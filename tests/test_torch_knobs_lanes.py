"""The port's tick under per-lane knob rows (every ``Knobs`` field a [B]
row, the int and bool knobs among them) against the live JAX package's
per-cluster knob layout: the reference's init and step vmapped over the
knob rows (the body of its ``make_sweep_fn(..., uniform_max_cells=0)``
program), compared on every state leaf at every tick, then the final
state against that program's. Also ``Knobs.broadcast``/``lanes`` and knob
validation on rows. Tolerance: exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_host, single_thread, threefry_layout
from madraft_tpu.tpusim import config as jcfg
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim.state import init_cluster as jax_init
from madraft_tpu.tpusim.step import step_cluster as jax_step
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import state as pstate
from madraft_tpu_torch.tpusim import step as pstep

# lanes take their knob rows from these profiles in turn (every field
# varies across them), with the int knobs varied further below
PROFILES = ("storm", "gray_storm", "rolling_wave", "limp", "fsync_stall",
            "skew_storm", "durability", "fig8")
LANES, TICKS, SEED = 16, 160, 21


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def knob_rows() -> dict:
    """field -> numpy [LANES] row of the reference's dtype."""
    rows = {}
    for lane in range(LANES):
        kn = jcfg.storm_profiles()[PROFILES[lane % len(PROFILES)]][0].knobs()
        for f, x in zip(kn._fields, kn):
            rows.setdefault(f, []).append(np.asarray(x))
    rows = {f: np.stack(v) for f, v in rows.items()}
    lane = np.arange(LANES)
    rows["majority"] = np.array([3, 2, 3, 4], np.int32)[lane % 4]
    rows["eto_min"] = (rows["eto_min"] + lane % 3).astype(np.int32)
    rows["eto_max"] = (rows["eto_max"] + 2 * (lane % 3)).astype(np.int32)
    rows["heartbeat_ticks"] = (rows["heartbeat_ticks"] + lane % 2).astype(
        np.int32)
    rows["flow_cap"] = np.where(lane % 5 == 1, 2, rows["flow_cap"]).astype(
        np.int32)
    rows["compact_every"] = (rows["compact_every"] + lane % 4).astype(np.int32)
    rows["fsync_every"] = (1 + lane % 3).astype(np.int32)
    rows["max_dead"] = (lane % 3).astype(np.int32)
    rows["compact_at_commit"] = lane % 2 == 0
    rows["delay_max"] = (rows["delay_max"] + lane % 3).astype(np.int32)
    rows["p_client_cmd"] = np.where(lane % 7 == 3, 0.9,
                                    rows["p_client_cmd"]).astype(np.float32)
    return rows


@functools.lru_cache(maxsize=None)
def _jax_programs(static_cfg):
    init = jax.jit(jax.vmap(functools.partial(jax_init, static_cfg),
                            in_axes=(0, 0)))
    step = jax.jit(jax.vmap(functools.partial(jax_step, static_cfg),
                            in_axes=(0, 0, 0)))
    return init, step


@pytest.mark.parametrize("metrics_on", [False, True])
def test_step_under_knob_rows_matches_reference_every_tick(metrics_on):
    rows = knob_rows()
    jc = jcfg.storm_profiles()["storm"][0].replace(metrics=metrics_on)
    pc = pcfg.storm_profiles()["storm"][0].replace(metrics=metrics_on)
    jkn = jcfg.Knobs(**{f: jnp.asarray(v) for f, v in rows.items()})
    pkn = pcfg.Knobs(**{f: torch.from_numpy(v.copy()) for f, v in rows.items()})
    init, step = _jax_programs(jc.static_key())
    jkeys = jengine._cluster_keys(jnp.uint32(SEED), LANES)
    pkeys = pengine.cluster_keys(SEED, LANES, "cpu")
    js, ps = init(jkeys, jkn), pstate.init_cluster(pc, pkeys, pkn)
    for t in range(TICKS):
        d = pstate.first_divergence(t, jax_host(js), pstate.state_to_numpy(ps))
        assert d is None, d
        js = step(js, jkeys, jkn)
        ps = pstep.step_cluster(pc, ps, pkeys, pkn)
    final = pstate.state_to_numpy(ps)
    assert pstate.first_divergence(TICKS, jax_host(js), final) is None
    # the rows reached the tick: lanes differ in what they did
    assert len(set(final["msg_count"].tolist())) > LANES // 2
    # the reference's per-cluster sweep program ends there too, and so does
    # the port's per-cluster sweep (draws a chunk of ticks at a time)
    jfn = jengine.make_sweep_fn(jc, jkn, LANES, TICKS, uniform_max_cells=0)
    pfn = pengine.make_sweep_fn(pc, pkn, LANES, TICKS, uniform_max_cells=0,
                                device="cpu")
    assert pfn.dispatch == "per_cluster"
    assert pstate.first_divergence(TICKS, jax_host(jfn(SEED)), final) is None
    assert pstate.first_divergence(
        TICKS, final, pstate.state_to_numpy(pfn(SEED))) is None


def test_uniform_rows_equal_the_uniform_tick():
    # knob rows that all hold the base values give the uniform tick's state
    cfg = pcfg.storm_profiles()["gray_storm"][0]
    kn = cfg.knobs()
    keys = pengine.cluster_keys(4, 8, "cpu")
    a = pengine._run(cfg, keys, kn, 70)
    b = pengine._run(cfg, keys, kn.broadcast(8), 70)
    assert pstate.first_divergence(70, pstate.state_to_numpy(a),
                                   pstate.state_to_numpy(b)) is None


def test_broadcast_and_lane_views():
    kn = pcfg.SimConfig().knobs()
    rows = kn.broadcast(6)
    assert all(x.shape == (6,) and x.dtype == y.dtype for x, y in zip(rows, kn))
    assert all(x.shape == () for x in kn.lanes(3))  # 0-d stays 0-d
    assert all(x.shape == (6, 1, 1) for x in rows.lanes(3))
    assert rows.broadcast(6).majority.tolist() == [kn.majority.item()] * 6


def test_validation_rejects_a_bad_row_like_the_reference():
    rows = knob_rows()
    rows["eto_max"] = rows["eto_max"].copy()
    rows["eto_max"][5] = rows["eto_min"][5] - 1
    with pytest.raises(ValueError, match="election timeout"):
        jengine._validate_knobs(
            jcfg.Knobs(**{f: jnp.asarray(v) for f, v in rows.items()}))
    with pytest.raises(ValueError, match="election timeout"):
        pengine._validate_knobs(
            pcfg.Knobs(**{f: torch.from_numpy(v) for f, v in rows.items()}))
    rows = knob_rows()
    rows["p_crash"] = rows["p_crash"].copy()
    rows["p_crash"][2] = 1.5
    with pytest.raises(ValueError, match="p_crash"):
        pengine.make_sweep_fn(
            pcfg.SimConfig(),
            pcfg.Knobs(**{f: torch.from_numpy(v) for f, v in rows.items()}),
            LANES, 8, device="cpu")
