"""The ``kv-fuzz`` verb of the port's CLI against the JAX CLI's, on the
CPU: the JSON report (every field but the wall-time telemetry) clean and
with ``--service-bug stale_read``, metrics off and on (the per-key and
per-client blocks with the clients' retries), the exit codes (0 clean, 1
on a violation, the reference's message for an unknown bug, 2 for
``--mesh``, for the verbs not ported yet and for ``shardkv-fuzz
--live-ctrler --computed-ctrler``), one run through ``python -m
madraft_tpu_torch kv-fuzz``, and ``stats --by-key --by-client`` over the
port's ``--metrics`` report against the JAX CLI's. Tolerance: exact
equality."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu_torch.__main__ import main as port_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
LEG = ["kv-fuzz", "--storm", "--clusters", "16", "--ticks", "120", "--seed",
       "3"]


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:  # both CLIs exit from inside
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def report(main, argv):
    rc, out, _ = run(main, argv)
    return rc, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("metrics", [False, True])
@pytest.mark.parametrize("bug", ["", "stale_read"])
def test_kv_fuzz_json_equals_the_reference(bug, metrics):
    argv = LEG + (["--service-bug", bug] if bug else []) + (
        ["--metrics"] if metrics else [])
    rc_j, want = report(jax_main, argv)
    rc_p, got = report(port_main, argv + ["--platform", "cpu"])
    assert rc_j == rc_p == (1 if bug else 0)
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    assert tp["backend"] == "cpu" and tp["state_layout"] == "wide"
    assert tp["state_hbm_bytes"] > 0
    if metrics:
        lat = got["latency"]
        assert lat["by_key"] and lat["by_client"]
        assert all("retries" in d for d in lat["by_client"].values())
        assert lat["ops"] == sum(d["ops"] for d in lat["by_key"].values())
    if bug:
        assert "STALE_READ" in got["violation_names"]


def test_kv_fuzz_exit_codes_and_usage_errors():
    argv = ["kv-fuzz", "--service-bug", "no_such_bug", "--clusters", "2",
            "--ticks", "2"]
    rc_j, _, _ = run(jax_main, argv)
    rc_p, _, err = run(port_main, argv + ["--platform", "cpu"])
    # the reference exits with the message (status 1 from a process)
    assert rc_p == 1 and err.strip() == rc_j
    assert "apply_uncommitted" in err
    rc, _, err = run(port_main, ["kv-fuzz", "--mesh", "--platform", "cpu"])
    assert rc == 2 and "A6" in err
    for verb in ("bridge", "lint"):
        rc, _, err = run(port_main, [verb])
        assert rc == 2 and "ROADMAP queue A" in err, verb
    # shardkv-fuzz runs in each controller mode, not in both at once
    rc, _, err = run(port_main, ["shardkv-fuzz", "--live-ctrler",
                                 "--computed-ctrler", "--platform", "cpu"])
    assert rc == 2 and "supersedes" in err


def test_kv_fuzz_runs_as_a_module_and_checks_determinism():
    r = subprocess.run(
        [sys.executable, "-m", "madraft_tpu_torch", "kv-fuzz", "--storm",
         "--clusters", "4", "--ticks", "30", "--check-deterministic",
         "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["deterministic"] is True and doc["violating"] == 0


def test_stats_by_key_and_client_over_a_kv_report(tmp_path):
    _, out, _ = run(port_main, LEG + ["--metrics", "--platform", "cpu"])
    path = tmp_path / "kv.json"
    path.write_text(out)
    for extra in ([], ["--json"]):
        argv = ["stats", str(path), "--by-key", "--by-client", *extra]
        rc_j, want, err_j = run(jax_main, argv)
        rc_p, got, err_p = run(port_main, argv)
        assert rc_j == rc_p == 0
        assert (got, err_p) == (want, err_j)
        assert "key" in got
