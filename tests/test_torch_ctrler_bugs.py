"""The shard-controller service layer against the live JAX package under
each planted controller bug, on the CPU: every ``CtrlerState`` leaf after
every tick (``test_torch_ctrler.CtrlerPair``), and the bug's oracle bit
set in the reference's final state: the node-rotated tie-break
(CTRL_DIVERGE, metrics on), the greedy rebalance (CTRL_BALANCE, legacy
layout) and the retention-blind reshuffle (CTRL_MINIMAL, metrics on,
legacy layout). Tolerance: exact equality."""

import pytest

from _torch_parity import single_thread
from test_torch_ctrler import check_case


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.mark.parametrize("case", ["rotate_tiebreak", "greedy_rebalance",
                                  "full_reshuffle"])
def test_ctrler_bug_tick_equals_the_reference_every_tick(case):
    check_case(case)
