"""The port's ``sweep`` verb (``engine.make_sweep_fn``) against the live JAX
package: both dispatches (the uniform one cell by cell over global ids
[id0, id0 + n), the per-cluster one with [B] knob rows), the CLI JSON apart
from wall-time telemetry, every per-cluster report array, the layouts
against each other on every final state leaf, ``_knob_runs``, and the
usage errors. The sweep legs of ``tests/torch_fixtures/coverage_legs.json``
(recorded by ``tests/test_torch_coverage.py``) are the reference's CLI runs
that ``chip_smoke.py`` holds the card to. Tolerance: exact equality."""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_parity import single_thread, threefry_layout
from madraft_tpu import __main__ as jcli
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu_torch import __main__ as pcli
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import state as pstate

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / "coverage_legs.json"
# an 8-cell grid (the uniform dispatch) and the CLI's default 12-cell grid
# (more than SWEEP_UNIFORM_MAX_CELLS: the per-cluster dispatch)
SWEEP_LEGS = {
    "uniform": ["sweep", "--storm", "--loss", "0,0.1", "--crash", "0,0.01",
                "--repartition", "0,0.02", "--clusters", "32", "--ticks",
                "128", "--seed", "3"],
    "per_cluster": ["sweep", "--storm", "--clusters", "36", "--ticks", "128",
                    "--seed", "3"],
}
REPORT_FIELDS = ("violations", "first_violation_tick", "first_leader_tick",
                 "committed", "msg_count", "snap_installs")


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def run_cli(side: str, argv) -> tuple:
    """(rc, the JSON line without its telemetry, the per-cluster report
    arrays, the telemetry keys) of one sweep through a CLI."""
    cli, eng = (jcli, jengine) if side == "jax" else (pcli, pengine)
    if side == "port":
        argv = list(argv) + ["--platform", "cpu"]
    kept = []
    report = eng.report

    def keep(final):
        rep = report(final)
        kept.append({f: np.asarray(getattr(rep, f)).astype(int).tolist()
                     for f in REPORT_FIELDS})
        return rep

    out = io.StringIO()
    eng.report = keep
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
    finally:
        eng.report = report
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    tele = doc.pop("telemetry")
    return rc, doc, kept[0], sorted(tele)


def record_sweeps() -> dict:
    legs = {}
    for name, argv in SWEEP_LEGS.items():
        rc, doc, rep, _ = run_cli("jax", argv)
        legs[name] = {"argv": argv, "rc": rc, "output": doc, "report": rep}
    return legs


@pytest.mark.parametrize("leg", list(SWEEP_LEGS))
def test_sweep_cli_matches_reference_and_fixture(leg):
    want = run_cli("jax", SWEEP_LEGS[leg])
    got = run_cli("port", SWEEP_LEGS[leg])
    assert got == want
    rc, doc, rep, _ = got
    assert doc["dispatch"] == leg
    assert len(doc["cells"]) == (8 if leg == "uniform" else 12)
    rec = json.loads(FIXTURE.read_text())["sweeps"][leg]
    assert rec == {"argv": SWEEP_LEGS[leg], "rc": rc, "output": doc,
                   "report": rep}


def test_sweep_layouts_agree_on_every_leaf():
    # the 8-cell grid cell by cell and as one batch of knob rows: every
    # final state leaf equal, and both dispatches named
    cfg = pcli._storm(pcfg.SimConfig())
    loss = torch.tensor([0.0, 0.1, 0.2, 0.3], dtype=torch.float32)
    majority = torch.tensor([3, 2], dtype=torch.int32)
    kn = cfg.knobs()._replace(loss_prob=loss.repeat_interleave(6),
                              majority=majority.repeat(12))
    finals = {}
    for umc in (pengine.SWEEP_UNIFORM_MAX_CELLS, 0):
        fn = pengine.make_sweep_fn(cfg, kn, 24, 60, uniform_max_cells=umc,
                                   device="cpu")
        finals[fn.dispatch] = pstate.state_to_numpy(fn(4))
    # the majority alternates lane by lane: 24 cells, more than 8
    assert set(finals) == {"per_cluster"}
    kn = kn._replace(majority=majority.repeat_interleave(12))
    for umc in (pengine.SWEEP_UNIFORM_MAX_CELLS, 0):
        fn = pengine.make_sweep_fn(cfg, kn, 24, 60, uniform_max_cells=umc,
                                   device="cpu")
        finals[fn.dispatch] = pstate.state_to_numpy(fn(4))
    assert pstate.first_divergence(60, finals["uniform"],
                                   finals["per_cluster"]) is None
    assert finals["uniform"]["violations"].any()  # the broken quorum shows


def test_knob_runs_match_reference():
    import jax.numpy as jnp

    from madraft_tpu.tpusim import config as jcfg

    for loss, crash in (([0.0, 0.1, 0.1, 0.3], [0.0, 0.0, 0.02, 0.02]),
                        ([0.1] * 4, [0.0] * 4),
                        ([0.0, 0.1, 0.0, 0.1], [0.0] * 4)):
        per = 5
        jk = jcfg.SimConfig().knobs()._replace(
            loss_prob=jnp.repeat(jnp.asarray(loss, jnp.float32), per),
            p_crash=jnp.repeat(jnp.asarray(crash, jnp.float32), per))
        pk = pcfg.SimConfig().knobs()._replace(
            loss_prob=torch.tensor(loss).repeat_interleave(per),
            p_crash=torch.tensor(crash).repeat_interleave(per))
        assert pengine._knob_runs(pk.broadcast(20), 20) \
            == jengine._knob_runs(jk.broadcast(20), 20)


def test_sweep_telemetry_keys_and_determinism_match_reference():
    argv = SWEEP_LEGS["uniform"][:-4] + ["--clusters", "16", "--ticks", "40",
                                          "--check-deterministic"]
    want = run_cli("jax", argv)
    got = run_cli("port", argv)
    assert got[3] == want[3]  # the telemetry keys
    assert got[:3] == want[:3] and got[1]["deterministic"] is True


@pytest.mark.parametrize("argv", [
    ["--mesh"], ["--clusters", "5"], ["--loss", "0,x"],
])
def test_sweep_usage_errors_exit_2(argv):
    rc = pcli.main(["sweep", "--ticks", "8", "--clusters", "24",
                    "--platform", "cpu"] + argv)
    assert rc == 2
