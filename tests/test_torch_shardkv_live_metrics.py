"""The shardkv layer's live-controller mode with the metrics plane on
(the clerks' latency folds, the five-phase split with the migration row,
the per-shard and per-client axes, the controller cluster's event
counters) against the live JAX package, every leaf after every tick, at
n = 3 under the partitionable layout: the kinds of
``chip_smoke.shardkv_knob_rows`` in live mode as [B] knob rows, the
storm, seed and checks of ``test_torch_shardkv_live.py``. Tolerance:
exact equality."""

import pytest

from _torch_parity import single_thread, threefry_layout
from test_torch_shardkv_live import LIVE, check_ctrl_rows


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    from conftest import no_persistent_cache

    with no_persistent_cache():
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def test_shardkv_live_ctrler_metrics_equal_the_reference_every_tick():
    with threefry_layout(True):
        check_ctrl_rows(LIVE, 3, True, 2)
