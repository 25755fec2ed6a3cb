"""The ``ctrler-fuzz`` verb of the port's CLI against the JAX CLI's, on the
CPU: the JSON report (every field but the telemetry, which carries the
wall times and the state layout: the reference ticks its packed carry,
the port the wide state) clean and under each ``--service-bug``
(``rotate_tiebreak``, ``greedy_rebalance``, ``full_reshuffle``), metrics
off and on, the exit codes (0 clean, 1 on a violation, the reference's
message for an unknown bug, 2 for ``--mesh``), and one run through
``python -m madraft_tpu_torch ctrler-fuzz --check-deterministic``.
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
LEG = ["ctrler-fuzz", "--storm", "--clusters", "16", "--ticks", "200",
       "--seed", "3"]
# the oracle bit each planted bug sets
BUG_NAMES = {"rotate_tiebreak": "CTRL_DIVERGE",
             "greedy_rebalance": "CTRL_BALANCE",
             "full_reshuffle": "CTRL_MINIMAL"}


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


@pytest.mark.parametrize("bug,metrics", [
    ("", False), ("", True), ("rotate_tiebreak", False),
    ("greedy_rebalance", True), ("full_reshuffle", False)])
def test_ctrler_fuzz_json_equals_the_reference(bug, metrics):
    argv = LEG + (["--service-bug", bug] if bug else []) + (
        ["--metrics"] if metrics else [])
    rc_j, want = report(jax_main, argv)
    rc_p, got = report(port_main, argv + ["--platform", "cpu"])
    assert rc_j == rc_p == (1 if bug else 0)
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    assert tp["backend"] == "cpu" and tp["state_layout"] == "wide"
    assert tp["state_hbm_bytes"] > 0
    assert got["configs_created_mean"] > 0 and got["queries_done_mean"] > 0
    if metrics:
        assert got["latency"]["ops"] > 0 and "worst_op" in got
    if bug:
        assert BUG_NAMES[bug] in got["violation_names"]


def test_ctrler_fuzz_exit_codes_and_usage_errors():
    argv = ["ctrler-fuzz", "--service-bug", "no_such_bug", "--clusters", "2",
            "--ticks", "2"]
    rc_j, _, _ = run(jax_main, argv)
    rc_p, _, err = run(port_main, argv + ["--platform", "cpu"])
    # the reference exits with the message (status 1 from a process)
    assert rc_p == 1 and err.strip() == rc_j
    assert "greedy_rebalance" in err
    rc, _, err = run(port_main, ["ctrler-fuzz", "--mesh", "--platform",
                                 "cpu"])
    assert rc == 2 and "A6" in err


def test_ctrler_fuzz_runs_as_a_module_and_checks_determinism():
    r = subprocess.run(
        [sys.executable, "-m", "madraft_tpu_torch", "ctrler-fuzz", "--storm",
         "--clusters", "4", "--ticks", "40", "--check-deterministic",
         "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["deterministic"] is True and doc["violating"] == 0
