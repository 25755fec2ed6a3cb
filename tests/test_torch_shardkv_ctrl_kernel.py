"""K11's controller branches (``kernels/shardkv.py``,
``csrc/shardkv.cuh``: the controller walker, the computed controller's
per-replica rebalance through ``csrc/ctrler.cuh``, the announcers, the
Query mailboxes with the stale log-tail answer, the CONFIG adoption and
the walker's CTRL_STALE checks), built for the host with g++
(``tests/shardkv_host_emu.cpp``), against the plain version
(``tpusim/shardkv.py`` ``_shardkv_service_tick``) through the wrapper's
own ``_launch``: every leaf of the new state, the controller cluster's
among them, after every tick of a run with the controller cluster ticking
beside the groups, K11 and K11-metrics, both modes, both threefry
layouts: the kinds of ``chip_smoke.shardkv_knob_rows`` as [B] rows (the
schedule mode's bugs, Puts, open-loop Zipf traffic, the re-query and the
mode's bug), a config's uniform ``bug_stale_ctrler_read`` and
``bug_rotate_tiebreak`` (each raising CTRL_STALE), five groups, and a
planted slid controller shadow (the sticky walker stall); then the
wrapper's refusals for the modes. The host build runs a phase's lanes
one after another, reversed on odd deployments, on a poisoned region.
Skips only where there is no g++. Tolerance: exact equality."""

import pathlib

import pytest
import torch

import _kernel_host
import chip_smoke
from _torch_parity import single_thread
from madraft_tpu_torch.kernels import shardkv as K11
from madraft_tpu_torch.tpusim import engine, prng
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.step import step_cluster
from test_torch_shardkv_kernel import BASE, staging_edges

TICKS = 90
LIVE = {"live_ctrler": True, "p_phantom": 0.5}
COMPUTED = {"computed_ctrler": True}
# name -> (n, shardkv config, rows, metrics, partitionable, deployments,
# seed, the violation bit the run must raise somewhere, or 0)
CASES = {
    "live_rows_metrics": (3, LIVE, True, True, True, 16, 7, 0),
    "live_rows_legacy": (5, LIVE, True, False, False, 16, 7, 0),
    "computed_rows": (3, COMPUTED, True, False, True, 16, 7, 0),
    "computed_rows_metrics_legacy": (5, COMPUTED, True, True, False, 16, 7,
                                     0),
    # seed 6: three of the twelve deployments adopt a phantom announce
    "live_stale_read": (3, {**LIVE, "bug_stale_ctrler_read": True}, False,
                        False, True, 12, 6, psk.VIOLATION_SHARD_CTRL_STALE),
    "computed_rotate_g5": (5, {**COMPUTED, "n_groups": 5, "walk_max": 9,
                               "bug_rotate_tiebreak": True}, False, True,
                           False, 6, 7, psk.VIOLATION_SHARD_CTRL_STALE),
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("shardkv_ctrl_host"))
    return {m: _kernel_host.build_shardkv(d, m) for m in (False, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def host_vs_plain(cfg, kcfg, st, keys, kn, skn, lib, ticks: int):
    """``ticks`` ticks on the plain version (the controller cluster
    stepped beside the groups), K11's host build held against it at
    each; returns (first divergence or None, final state)."""
    table = K11.knob_table(kn, skn, keys.shape[0])
    g, b = kcfg.n_groups, keys.shape[0]
    gkeys = psk.group_keys(keys, g).reshape(-1, 2)
    ckeys = psk.ctrl_keys(keys)
    gkn = psk._group_knobs(kn, g)
    for t in range(ticks):
        pre = st.rafts
        s = psk._unflat(step_cluster(cfg, psk._flat(pre), gkeys, gkn), b)
        ctrl = step_cluster(cfg, st.ctrl, ckeys, kn)
        want = psk._shardkv_service_tick(cfg, kcfg, st, pre.alive, pre.base,
                                         s, keys, kn, skn, ctrl)
        got = K11._launch(cfg, kcfg, st, pre.alive, pre.base, s, keys, table,
                          lib, None, ctrl)
        d = psk.first_divergence(t, psk.shardkv_state_to_numpy(want),
                                 psk.shardkv_state_to_numpy(got))
        if d is not None:
            return d, want
        st = want
    return None, st


def resolved(st) -> torch.Tensor:
    return torch.cumprod((st.win_var >= 0).int(), -1).sum(-1) - 1


@pytest.mark.parametrize("case", list(CASES))
def test_shardkv_ctrl_kernel_host_build_equals_plain_every_tick(libs, case):
    n, kw, rows, metrics, partitionable, b, seed, bit = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=16, **kw)
    with prng.layout(partitionable):
        keys = engine.cluster_keys(seed, b, "cpu")
        kn = cfg.knobs()
        skn = (chip_smoke.shardkv_knob_rows(kcfg, b) if rows
               else kcfg.knobs())
        st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        d, final = host_vs_plain(cfg, kcfg, st, keys, kn, skn,
                                 libs[metrics], TICKS)
    assert d is None, d
    assert final.clerk_acked.sum() > 0
    assert (resolved(final) >= 2).any() and final.installs_done.sum() > 0
    if bit:
        assert (final.violations & bit).any(), final.violations
    if rows:
        cases = chip_smoke.shardkv_row_cases(kcfg)
        clean = torch.arange(b) % len(cases) == 0
        assert not final.violations[clean].any()


@pytest.mark.parametrize("kw,n", [(LIVE, 3), (COMPUTED, 5)])
def test_shardkv_ctrl_kernel_host_build_walker_stall(libs, kw, n):
    """A planted slid controller shadow (shadow_base past the walker's
    frontier): the host build raises the sticky stall with the plain
    version and resolves nothing, every leaf equal for 12 ticks."""
    cfg = SimConfig(n_nodes=n, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=16, **kw)
    keys = engine.cluster_keys(3, 4, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    c = st.ctrl
    st = st._replace(ctrl=c._replace(
        shadow_len=torch.full_like(c.shadow_len, cfg.log_cap + 5),
        shadow_base=torch.full_like(c.shadow_base, 5)))
    d, final = host_vs_plain(cfg, kcfg, st, keys, kn, skn, libs[False], 12)
    assert d is None, d
    assert final.ctrl_w_stalled.all() and (final.ctrl_w_frontier == 0).all()
    assert (resolved(final) == 0).all()


@pytest.mark.parametrize("kw,n,misaligned", [
    (LIVE, 3, True), (LIVE, 7, False), (COMPUTED, 3, False),
    (COMPUTED, 7, True)])
def test_shardkv_ctrl_kernel_host_build_staging_edges(libs, kw, n,
                                                      misaligned):
    """The staging plan at its edges through the host build, each
    controller mode's instance: inputs one element off their alignment or
    aligned, a ragged batch of three, K11-metrics, n = 3 and 7."""
    cfg = SimConfig(n_nodes=n, metrics=True, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=8, **kw)
    final = staging_edges(libs, cfg, kcfg, 3, misaligned)
    assert final.clerk_acked.sum() > 0


def test_shardkv_ctrl_kernel_refuses_what_it_does_not_take(libs):
    cfg = SimConfig(n_nodes=3, **BASE)
    kcfg = psk.ShardKvConfig(**LIVE)
    keys = engine.cluster_keys(1, 2, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    s = st.rafts
    table = K11.knob_table(kn, skn, 2)
    # a controller leaf of the wrong type
    bad = st._replace(win_var=st.win_var.to(torch.int64))
    with pytest.raises(ValueError, match="win_var"):
        K11._launch(cfg, kcfg, bad, s.alive, s.base, s, keys, table,
                    libs[False], None, st.ctrl)
    # the schedule mode's placeholder controller where a mode needs the
    # full cluster
    sched = psk.init_shardkv_cluster(cfg, psk.ShardKvConfig(), keys)
    with pytest.raises(ValueError, match="ctrl"):
        K11._launch(cfg, kcfg, st, s.alive, s.base, s, keys, table,
                    libs[False], None, sched.ctrl)
    # the computed controller's rebalance is fixed at 10 shards
    with pytest.raises(ValueError, match="n_shards 10"):
        K11.check_shape(cfg, _computed_cfg_with_shards(12))


def _computed_cfg_with_shards(ns: int):
    """A computed-mode config past the rebalance's 10 shards (the config
    check refuses it, so the shape check sees a stand-in)."""
    class Stand:
        n_groups, n_shards, n_clients, n_configs = 3, ns, 4, 6
        live_ctrler, computed_ctrler = False, True
    return Stand()
