"""The port's continuous fuzzing pool (``engine.run_pool``, the ``pool``
verb) against the live JAX package, at the shape of tests/test_pool.py:
16 lanes, horizon 64, chunks of 32 ticks, a 320-tick budget, default
(partitionable) threefry layout. Rows in order and every summary field
but the wall-time telemetry must be equal, under the monotone id scheme
(packed carry, and wide under a packed tick ceiling the run exceeds) and
the lane-partitioned one (devices=1); the port's one-device lane scheme
retires the multiset the reference's two-device pool retires. Tolerance:
exact equality."""

import contextlib
import io
import json

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import SimConfig as JaxSimConfig
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.kernels import pack as K3
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim.config import SimConfig, pool_generation, pool_lane

STORM = dict(n_nodes=5, p_client_cmd=0.2, loss_prob=0.1, p_crash=0.01,
             p_restart=0.2, max_dead=2, p_repartition=0.02, p_heal=0.05)
# the dual-leader demo: violations land early, across refill generations
JVIOL = JaxSimConfig(**STORM).replace(majority_override=2)
PVIOL = SimConfig(**STORM).replace(majority_override=2)
# the same runs with a packed tick ceiling below horizon + chunk (96), so
# both sides fall back to the wide carry; the dynamics do not change
NARROW = dict(max_lane_ticks=64)
SHAPE = (7, 16, 64)  # seed, lanes, horizon
KW = dict(chunk_ticks=32, budget_ticks=320)
WALL = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
        "violations_per_s", "compile_s", "dispatch_gap_s", "device_wait_s",
        "host_overlap_s")
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def _strip(rows):
    return [{k: v for k, v in r.items()
             if k not in ("wall_s", "violations_per_s")} for r in rows]


def pooled(side: str, wide: bool = False, **kw):
    """(rows, summary) of one pool run, cached per side and arguments;
    ``wide`` runs the config whose packed tick ceiling forces the wide
    carry."""
    key = (side, wide, tuple(sorted(kw.items())))
    if key not in _RUNS:
        rows = []
        if side == "jax":
            cfg = JVIOL.replace(**NARROW) if wide else JVIOL
            s = jengine.run_pool(cfg, *SHAPE, **KW, on_retired=rows.append,
                                 **kw)
        else:
            cfg = PVIOL.replace(**NARROW) if wide else PVIOL
            s = pengine.run_pool(cfg, *SHAPE, **KW, on_retired=rows.append,
                                 device="cpu", **kw)
        _RUNS[key] = (_strip(rows), {k: v for k, v in s.items()
                                     if k not in WALL})
    return _RUNS[key]


@pytest.mark.parametrize("kw", [{}, {"wide": True}, {"devices": 1}],
                         ids=["monotone-packed", "monotone-wide", "lane-1"])
def test_pool_matches_reference(kw):
    rows_j, sum_j = pooled("jax", **kw)
    rows_p, sum_p = pooled("port", **kw)
    assert rows_p == rows_j
    assert sum_p == sum_j
    assert sum_p["state_layout"] == ("wide" if kw.get("wide") else "packed")
    assert sum_p["retired_violating"] > 0
    if kw.get("wide"):  # the layout changes the bytes, never the rows
        rows_packed, _ = pooled("port")
        assert rows_p == rows_packed


def test_port_lane_scheme_retires_the_reference_two_device_multiset():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the reference's virtual two-device mesh")
    rows_j, sum_j = pooled("jax", devices=2)
    rows_p, sum_p = pooled("port", devices=1)
    key = lambda r: r["cluster_id"]  # noqa: E731
    assert sorted(rows_p, key=key) == sorted(rows_j, key=key)
    assert sum_p["retired"] == sum_j["retired"]
    assert sum_p["id_watermark"] == sum_j["id_watermark"]
    for r in rows_p:
        i = r["cluster_id"]
        assert pool_generation(i, 16) * 16 + pool_lane(i, 16) == i


def test_pool_first_generation_equals_fuzz():
    # horizon == chunk == budget: one chunk and one harvest, so every lane
    # retires with the state a straight fuzz run ends in
    rep = pengine.fuzz(PVIOL, 12345, 16, 96, device="cpu")
    rows = []
    s = pengine.run_pool(PVIOL, 12345, 16, 96, chunk_ticks=96,
                         budget_ticks=96, on_retired=rows.append,
                         device="cpu")
    assert s["retired"] == 16
    assert sorted(r["cluster_id"] for r in rows) == list(range(16))
    for r in rows:
        c = r["cluster_id"]
        assert r["ticks_run"] == 96
        for f, g in (("violations", "violations"),
                     ("first_violation_tick", "first_violation_tick"),
                     ("first_leader_tick", "first_leader_tick"),
                     ("committed", "committed"), ("msg_count", "msg_count"),
                     ("snap_installs", "snap_installs")):
            assert r[f] == int(getattr(rep, g)[c]), (c, f)


def test_pool_refill_ids_are_monotone_and_unique():
    rows, summary = pooled("port")
    ids = [r["cluster_id"] for r in rows]
    assert len(ids) == len(set(ids)), "a global cluster id was reused"
    assert summary["retired"] == len(rows)
    assert max(ids) >= 16
    assert summary["next_cluster_id"] == 16 + len(rows)
    assert all(r["ticks_run"] % 32 == 0 for r in rows)


def test_pool_hits_replay_through_the_port_replay():
    rows, _ = pooled("port")
    viol = [r for r in rows if r["violations"]]
    assert len({r["cluster_id"] // 16 for r in viol}) >= 2
    before = (K3.pack_state.launches, K3.unpack_state.launches)
    for r in viol[:6]:
        st = pengine.replay_cluster(PVIOL, 7, r["cluster_id"], r["ticks_run"],
                                    device="cpu")
        assert int(st.violations[0]) == r["violations"]
        assert int(st.first_violation_tick[0]) == r["first_violation_tick"]
        assert int(st.shadow_len[0]) == r["committed"]
        assert int(st.msg_count[0]) == r["msg_count"]
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (K3.pack_state.launches, K3.unpack_state.launches) == before


def test_pool_wide_fallback():
    wide_delay = PVIOL.replace(delay_max=300)
    s = pengine.run_pool(wide_delay, 3, 8, 32, chunk_ticks=32,
                         budget_ticks=32, device="cpu")
    assert s["state_layout"] == "wide" and s["bytes_per_lane"] > 5000


def test_pool_on_retired_exception_propagates():
    def boom(row):
        raise RuntimeError("emitter died")

    with pytest.raises(RuntimeError, match="emitter died"):
        pengine.run_pool(PVIOL, 3, 16, 64, chunk_ticks=32, budget_ticks=64,
                         on_retired=boom, device="cpu")


def test_pool_budget_seconds_and_devices_validation():
    rows = []
    s = pengine.run_pool(PVIOL, 11, 8, 64, chunk_ticks=32,
                         budget_seconds=0.001, on_retired=rows.append,
                         device="cpu")
    assert s["lane_ticks"] >= 32 and s["retired"] == len(rows)
    for devices, match in ((0, ">= 1"), (2, "exceeds")):
        with pytest.raises(ValueError, match=match):
            pengine.run_pool(PVIOL, 7, 16, 64, devices=devices, device="cpu")


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv + ["--platform", "cpu"])
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    return rc, lines, err.getvalue()


@pytest.mark.parametrize("majority,want_rc", [(2, 1), (0, 0)])
def test_cli_pool_exit_code_is_1_iff_a_violation(majority, want_rc):
    argv = ["pool", "--storm", "--clusters", "8", "--ticks", "32",
            "--budget-ticks", "64", "--seed", "7"]
    if majority:
        argv += ["--majority-override", str(majority)]
    rc, lines, _ = _cli(argv)
    summary = lines[-1]
    assert rc == want_rc
    assert bool(summary["retired_violating"]) == bool(want_rc)
    assert len(lines) - 1 == summary["retired"]  # --emit all: every row
    assert summary["backend"] == "cpu"
    assert summary["state_layout"] == "packed"


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--mesh"], ["--coverage", "--devices", "2"],
    ["--coverage", "--heartbeat", "hb.jsonl"],
    ["--coverage", "--coverage-bits", "64", "--digest-every", "2"],
    ["--heartbeat", "hb.jsonl"], ["--digest-every", "2"],
    ["--metrics", "--coverage", "--mesh"],
])
def test_cli_pool_unported_flags_exit_2(flags):
    rc, lines, err = _cli(["pool", "--clusters", "4", "--ticks", "8", *flags])
    assert rc == 2 and not lines and "not ported yet" in err
