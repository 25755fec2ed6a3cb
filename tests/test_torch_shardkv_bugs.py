"""The shardkv service layer's kinds (clean, the planted bugs
``bug_skip_freeze``, ``bug_drop_dup_table`` and ``bug_serve_frozen``, Puts,
open-loop Zipf traffic, the WrongGroup re-query) as [B] knob rows against
the live JAX package, every leaf every tick, with metrics off and on, at
n = 5 under the legacy threefry layout, and a config's 0-d knobs with
``bug_drop_dup_table`` and metrics on (``test_torch_shardkv.py`` holds the
shared checks): each bug raises the reference's violation bit on the same
deployments at the same first tick. Tolerance: exact equality."""

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu_torch.tpusim import shardkv as psk
from test_torch_shardkv import check_rows, check_uniform


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.mark.parametrize("metrics", [False, True])
def test_shardkv_kinds_legacy_equal_the_reference_every_tick(metrics):
    with threefry_layout(False):
        check_rows(5, metrics, 10)


def test_shardkv_uniform_bug_equals_the_reference_every_tick():
    with threefry_layout(False):
        check_uniform({"bug_drop_dup_table": True}, 5, True, 10,
                      psk.VIOLATION_SHARD_DIVERGE)
