"""The ``shardkv-fuzz`` verb of the port's CLI against the JAX CLI's, on
the CPU: the JSON report (every field but the telemetry, which carries
the wall times and the state layout: the reference ticks its packed
deployment carry, the port the wide state) clean with metrics off, and
with ``--service-bug serve_frozen`` and metrics on (the five-phase split
with the migration row, the per-shard and per-client blocks); the exit
codes (0 clean, 1 on a violation, the reference's
messages for an unknown bug and for a controller-mode bug without its
mode, 2 for ``--mesh`` and for both controller modes at once, whose
config check the reference lets escape as a ValueError;
``test_torch_shardkv_ctrl_cli.py`` runs the controller modes); one run through
``python -m madraft_tpu_torch shardkv-fuzz --check-deterministic``; and
``stats`` over the port's ``--metrics`` report against the JAX CLI's.
Tolerance: exact equality."""

import json
import pathlib
import subprocess
import sys

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu_torch.__main__ import main as port_main
from test_torch_kv_cli import report, run

ROOT = pathlib.Path(__file__).resolve().parent.parent
LEG = ["shardkv-fuzz", "--storm", "--clusters", "8", "--ticks", "150",
       "--seed", "3"]
# the oracle bit each planted bug sets
BUG_NAMES = {"serve_frozen": "SHARD_STALE_READ"}


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


@pytest.mark.parametrize("bug,metrics", [
    ("", False), ("serve_frozen", True)])
def test_shardkv_fuzz_json_equals_the_reference(bug, metrics):
    argv = LEG + (["--service-bug", bug] if bug else []) + (
        ["--metrics"] if metrics else [])
    rc_j, want = report(jax_main, argv)
    rc_p, got = report(port_main, argv + ["--platform", "cpu"])
    assert rc_j == rc_p == (1 if bug else 0)
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    assert tp["backend"] == "cpu" and tp["state_layout"] == "wide"
    assert tp["state_hbm_bytes"] > 0
    assert got["acked_ops_mean"] > 0 and got["installs_mean"] > 0
    if metrics:
        lat = got["latency"]
        assert lat["ops"] > 0 and "worst_op" in got
        assert "migration" in lat["phases"]
        assert lat["by_key"] and lat["by_client"]
    if bug:
        assert BUG_NAMES[bug] in got["violation_names"]


def test_shardkv_fuzz_exit_codes_and_usage_errors():
    for bug in ("no_such_bug", "stale_ctrler_read", "rotate_tiebreak"):
        argv = ["shardkv-fuzz", "--service-bug", bug, "--clusters", "2",
                "--ticks", "2"]
        rc_j, _, _ = run(jax_main, argv)
        rc_p, _, err = run(port_main, argv + ["--platform", "cpu"])
        # the reference exits with the message (status 1 from a process)
        assert rc_p == 1 and err.strip() == rc_j, bug
    rc, _, err = run(port_main, ["shardkv-fuzz", "--mesh", "--platform",
                                 "cpu"])
    assert rc == 2 and "A6" in err
    # both controller modes: the reference's config check raises, the
    # port makes its message a usage error
    both = ["shardkv-fuzz", "--live-ctrler", "--computed-ctrler",
            "--clusters", "2", "--ticks", "2"]
    with pytest.raises(ValueError, match="supersedes") as e:
        jax_main(both)
    rc, _, err = run(port_main, both + ["--platform", "cpu"])
    assert rc == 2 and str(e.value) in err


def test_shardkv_fuzz_runs_as_a_module_and_checks_determinism():
    r = subprocess.run(
        [sys.executable, "-m", "madraft_tpu_torch", "shardkv-fuzz",
         "--storm", "--clusters", "3", "--ticks", "40",
         "--check-deterministic", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["deterministic"] is True and doc["violating"] == 0


def test_stats_over_a_shardkv_metrics_report(tmp_path):
    _, out, _ = run(port_main, ["shardkv-fuzz", "--storm", "--clusters", "4",
                                "--ticks", "120", "--metrics", "--platform",
                                "cpu"])
    path = tmp_path / "shardkv.json"
    path.write_text(out)
    for extra in ([], ["--json"], ["--by-key", "--by-client"]):
        argv = ["stats", str(path), *extra]
        rc_j, want, err_j = run(jax_main, argv)
        rc_p, got, err_p = run(port_main, argv)
        assert rc_j == rc_p == 0
        assert (got, err_p) == (want, err_j)
        assert "migration" in got
