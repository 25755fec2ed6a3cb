"""The ``shardkv-fuzz`` verb's controller modes (``--live-ctrler``,
``--computed-ctrler``) on the port's CLI against the JAX CLI's, on the
CPU: the JSON report (every field but the telemetry, which carries the
wall times and the state layout: the reference ticks its packed
deployment carry, the port the wide state), ``ann_resolved_mean`` and
``ctrl_walker_stalled_mean`` among them, and the exit code: the live mode
clean with metrics off and with ``--service-bug stale_ctrler_read`` and
metrics on, the computed mode with ``--service-bug rotate_tiebreak`` and
metrics off and clean with metrics on. The storm at 8 deployments x 150
ticks with the CLI's default seed (12345), where both bugs raise
SHARD_CTRL_STALE. Tolerance: exact equality."""

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu_torch.__main__ import main as port_main
from test_torch_kv_cli import report

LEG = ["shardkv-fuzz", "--storm", "--clusters", "8", "--ticks", "150"]


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    # the controller modes' programs crash the persistent cache's
    # serialize (tests/test_tpusim_shardkv.py)
    from conftest import no_persistent_cache

    with no_persistent_cache():
        yield


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


@pytest.mark.parametrize("mode,bug,metrics", [
    ("--live-ctrler", "", False),
    ("--live-ctrler", "stale_ctrler_read", True),
    ("--computed-ctrler", "rotate_tiebreak", False),
    ("--computed-ctrler", "", True)])
def test_shardkv_ctrl_fuzz_json_equals_the_reference(mode, bug, metrics):
    argv = LEG + [mode] + (["--service-bug", bug] if bug else []) + (
        ["--metrics"] if metrics else [])
    rc_j, want = report(jax_main, argv)
    rc_p, got = report(port_main, argv + ["--platform", "cpu"])
    assert rc_j == rc_p == (1 if bug else 0)
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    assert tp["backend"] == "cpu" and tp["state_layout"] == "wide"
    assert got["acked_ops_mean"] > 0 and got["ann_resolved_mean"] > 0
    assert got["installs_mean"] > 0
    if metrics:
        lat = got["latency"]
        assert lat["ops"] > 0 and "migration" in lat["phases"]
    if bug:
        assert "SHARD_CTRL_STALE" in got["violation_names"]
