"""The metrics plane on the port's pool and CLI against the live JAX
package, on the CPU: ``run_pool`` with metrics on (rows in order, with
their latency_hist / events / latency_phases / worst_op columns, and the
summary's latency, events and worst_op) under the monotone id scheme with
the packed and the wide carry and under the lane scheme; the lane scheme's
rows as a multiset and merged worst op against the reference's two-device
pool; ``fuzz --metrics`` and ``pool --metrics`` through the CLI (JSON,
rows, the stderr digest). Tolerance: exact equality, apart from wall-time
telemetry."""

import contextlib
import io
import json

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu.tpusim import SimConfig as JaxSimConfig
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim.config import SimConfig

STORM = dict(n_nodes=5, p_client_cmd=0.2, loss_prob=0.1, p_crash=0.01,
             p_restart=0.2, max_dead=2, p_repartition=0.02, p_heal=0.05,
             metrics=True)
# violations across refill generations, so retirement mixes both causes
JCFG = JaxSimConfig(**STORM).replace(majority_override=2)
PCFG = SimConfig(**STORM).replace(majority_override=2)
NARROW = dict(max_lane_ticks=64)  # forces the wide carry on both sides
SHAPE = (7, 16, 64)  # seed, lanes, horizon
KW = dict(chunk_ticks=32, budget_ticks=320)
WALL = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
        "violations_per_s", "compile_s", "dispatch_gap_s", "device_wait_s",
        "host_overlap_s", "device", "backend")
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def _strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in WALL}


def pooled(side: str, wide: bool = False, **kw):
    key = (side, wide, tuple(sorted(kw.items())))
    if key not in _RUNS:
        rows = []
        if side == "jax":
            cfg = JCFG.replace(**NARROW) if wide else JCFG
            s = jengine.run_pool(cfg, *SHAPE, **KW, on_retired=rows.append,
                                 **kw)
        else:
            cfg = PCFG.replace(**NARROW) if wide else PCFG
            s = pengine.run_pool(cfg, *SHAPE, **KW, on_retired=rows.append,
                                 device="cpu", **kw)
        _RUNS[key] = ([_strip(r) for r in rows], _strip(s))
    return _RUNS[key]


@pytest.mark.parametrize("kw", [{}, {"wide": True}, {"devices": 1}],
                         ids=["monotone-packed", "monotone-wide", "lane-1"])
def test_pool_with_metrics_matches_reference(kw):
    rows_j, sum_j = pooled("jax", **kw)
    rows_p, sum_p = pooled("port", **kw)
    assert rows_p == rows_j
    assert sum_p == sum_j
    assert sum_p["state_layout"] == ("wide" if kw.get("wide") else "packed")
    if not kw.get("wide"):
        assert sum_p["bytes_per_lane"] == 3600.0
    assert sum_p["retired_violating"] > 0 and sum_p["latency"]["ops"] > 0
    lat = sum_p["latency"]
    assert all(d["ops"] == lat["ops"] for d in lat["phases"].values())
    assert sum(d["ticks_total"] for d in lat["phases"].values()) \
        == lat["ticks_total"]
    for r in rows_p:
        assert all(sum(h) == sum(r["latency_hist"])
                   for h in r["latency_phases"].values())


def test_lane_scheme_metrics_equal_the_reference_two_device_run():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the reference's virtual two-device mesh")
    rows_j, sum_j = pooled("jax", devices=2)
    rows_p, sum_p = pooled("port", devices=1)
    key = lambda r: r["cluster_id"]  # noqa: E731
    assert sorted(rows_p, key=key) == sorted(rows_j, key=key)
    for k in ("latency", "events", "worst_op", "retired", "id_watermark"):
        assert sum_p[k] == sum_j[k], k


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:  # the reference exits 2 from inside
            rc = e.code
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    return rc, lines, err.getvalue()


def test_cli_fuzz_metrics_matches_reference():
    argv = ["fuzz", "--storm", "--metrics", "--clusters", "16", "--ticks",
            "200", "--check-deterministic"]
    rc_j, (want,), _ = run(jax_main, argv)
    rc_p, (got,), _ = run(port_main, argv + ["--platform", "cpu"])
    assert rc_j == rc_p == 0
    tj, tp = want.pop("telemetry"), got.pop("telemetry")
    assert got == want
    assert list(got) == list(want)  # the keys in the reference's order
    assert got["deterministic"] is True and got["latency"]["ops"] > 0
    for k in ("state_layout", "state_hbm_bytes", "bytes_per_lane"):
        assert tp[k] == tj[k], k


def test_cli_pool_metrics_matches_reference():
    argv = ["pool", "--profile", "durability", "--bug", "ack_before_fsync",
            "--metrics", "--clusters", "16", "--ticks", "64",
            "--budget-ticks", "192", "--seed", "5"]
    rc_j, want, err_j = run(jax_main, argv)
    rc_p, got, err_p = run(port_main, argv + ["--platform", "cpu"])
    assert rc_p == rc_j
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    # the digest line, up to its wall-clock violations/s
    digest = [x.split(";")[0] for x in err_p.splitlines()
              if x.startswith("pool: latency")]
    assert digest == [x.split(";")[0] for x in err_j.splitlines()
                      if x.startswith("pool: latency")]
    assert len(digest) == 1 and "violations/s" in err_p
    assert got[-1]["latency"]["ops"] > 0


def test_cli_replay_metrics_matches_reference():
    argv = ["replay", "--storm", "--metrics", "--majority-override", "2",
            "--seed", "7", "--cluster", "3", "--ticks", "96"]
    rc_j, (want,), _ = run(jax_main, argv)
    rc_p, (got,), _ = run(port_main, argv + ["--platform", "cpu"])
    assert rc_p == rc_j and got == want
