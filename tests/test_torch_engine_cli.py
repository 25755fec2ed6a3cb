"""The port's engine and CLI against the live JAX package at 64 clusters x
300 ticks, default (partitionable) threefry layout: per-cluster fuzz
reports, the fuzz and replay JSON lines (replay's ``state_layout`` and
``state_schema_version`` included), and the exit codes 0 / 1 / 2.
Tolerance: exact equality of every field, apart from wall-time
telemetry."""

import contextlib
import io
import json

import numpy as np
import pytest

from _torch_parity import configs, single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.tpusim import engine as pengine

BUG_LEG = ["--profile", "durability", "--bug", "ack_before_fsync",
           "--clusters", "64", "--ticks", "300", "--seed", "1"]


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:  # the reference exits 2 from inside
            rc = e.code
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def port(argv):
    return run(port_main, argv + ["--platform", "cpu"])


def test_fuzz_reports_match_per_cluster():
    jcfg, pcfg = configs("storm")
    want = jengine.fuzz(jcfg, 8, 64, 300)
    got = pengine.fuzz(pcfg, 8, 64, 300, device="cpu")
    for f in got._fields:
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        assert np.array_equal(np.asarray(a), b), f
    assert got.committed.sum() > 0


def test_cli_fuzz_and_replay_match_reference():
    rc_j, want, _ = run(jax_main, ["fuzz", *BUG_LEG])
    rc_p, got, _ = port(["fuzz", *BUG_LEG])
    assert rc_j == rc_p == 1
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    for k in ("state_layout", "state_hbm_bytes", "bytes_per_lane"):
        assert tp[k] == tj[k], k
    assert tp["backend"] == "cpu"
    # the violating cluster replays alone, bit for bit
    bad = str(want["violating_clusters"][0])
    replay = ["replay", *BUG_LEG, "--cluster", bad]
    rc_j, want, _ = run(jax_main, replay)
    rc_p, got, _ = port(replay)
    assert rc_j == rc_p == 1
    assert got["state_layout"] == "packed"
    assert got == want
    assert got["violations"] != 0


def test_cli_clean_run_exit_0_and_deterministic():
    argv = ["fuzz", "--storm", "--clusters", "8", "--ticks", "40",
            "--check-deterministic"]
    rc_j, want, _ = run(jax_main, argv)
    rc_p, got, _ = port(argv)
    assert rc_j == rc_p == 0
    want.pop("telemetry"), got.pop("telemetry")
    assert got == want and got["deterministic"] is True


@pytest.mark.parametrize("argv", [
    ["fuzz", "--profile", "no_such_profile"],
    ["replay", "--cluster", "0", "--knobs-json", "{not json"],
    ["replay", "--cluster", "0", "--knobs-json", '{"loss_prob": 2.0}'],
    ["replay", "--cluster", "0", "--knobs-json", '{"no_such_knob": 1}'],
])
def test_cli_usage_errors_exit_2_like_reference(argv):
    rc_j, _, _ = run(jax_main, argv)
    rc_p, _, err = port(argv)
    assert rc_j == rc_p == 2, err


@pytest.mark.parametrize("argv", [
    ["fuzz", "--mesh", "--clusters", "4", "--ticks", "2"],
    ["pool", "--metrics", "--heartbeat", "hb.jsonl", "--clusters", "4"],
    ["pool", "--devices", "2", "--clusters", "4"],
    ["sweep", "--mesh", "--clusters", "12", "--ticks", "2"],
])
def test_cli_unported_paths_exit_2(argv):
    rc, out, err = port(argv)
    assert rc == 2 and out is None and "not ported yet" in err


def test_list_profiles_matches_reference():
    outs = []
    for main in (jax_main, port_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["fuzz", "--list-profiles"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "gray_storm" in outs[1]
