"""K10, the shard controller's service tick (``kernels/ctrler.py``,
``csrc/ctrler.cuh``), built for the host with g++
(``tests/ctrler_host_emu.cpp``), against its plain version
(``tpusim/ctrler.py`` ``_ctrler_service_tick``) through the wrapper's own
``_launch``: every leaf of the new state after every tick of a run, K10
and K10-metrics, at n = 3, 5 and 7, under each planted controller bug,
with ten gids and one gid an op, two gids, a history that fills, [B]
knob rows that mix the bugs, 32 clients, more apply rounds and walker
steps than the defaults, states planted at mixed ticks, both threefry
layouts and ragged batch sizes; the constructed walker-stall state; then
the wrapper's refusals. The host build runs a phase's lanes one after
another, reversed on odd clusters, on a poisoned region. Skips only where
there is no g++. Tolerance: exact equality."""

import pathlib

import pytest
import torch

import _kernel_host
import chip_smoke
from _torch_parity import single_thread
from madraft_tpu_torch.kernels import ctrler as K10
from madraft_tpu_torch.tpusim import ctrler as pct
from madraft_tpu_torch.tpusim import engine, prng
from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.step import step_cluster

BASE = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
            p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
            p_heal=0.05, log_cap=32, compact_every=8)
TICKS = 80
# name -> (n, ctrler config ("rows": the mixed knob rows), metrics,
# partitionable, clusters)
CASES = {
    "n3": (3, {}, False, True, 13),
    "n7_metrics_legacy": (7, {}, True, False, 9),
    "rotate_tiebreak": (5, {"bug_rotate_tiebreak": True}, True, True, 13),
    "greedy_rebalance": (5, {"bug_greedy_rebalance": True}, False, False,
                         11),
    "full_reshuffle": (5, {"bug_full_reshuffle": True}, True, False, 13),
    # ten gids, one an op, and a history of six configs that fills
    "ng10_jm1_full_history": (5, {"n_gids": 10, "join_max": 1,
                                  "n_configs": 6, "p_query": 0.2,
                                  "p_move": 0.2}, True, True, 13),
    "ng2_jm2": (5, {"n_gids": 2, "join_max": 2, "p_move": 0.3}, False, True,
                11),
    "mixed_rows": (5, "rows", True, True, 16),
    "mixed_rows_off": (7, "rows", False, False, 16),
    # 32 clients: a warp's every lane a clerk
    "clients_32": (5, {"n_clients": 32, "n_gids": 10}, True, True, 9),
    # more apply rounds and walker steps than the defaults
    "apply_11_walk_13": (5, {"apply_max": 11, "walk_max": 13,
                             "bug_rotate_tiebreak": True}, True, False, 13),
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("ctrler_host"))
    return {m: _kernel_host.build_ctrler(d, m) for m in (False, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def cat(a, b):
    """Two ctrler states' batches, one after the other."""
    return pct.CtrlerState(
        type(a.raft)(*(torch.cat(x) for x in zip(a.raft, b.raft))),
        *(torch.cat(x) for x in zip(a[1:], b[1:])))


def host_vs_plain(cfg, kcfg, ks, keys, kn, ckn, lib, ticks: int):
    """``ticks`` ticks on the plain version, K10's host build held against
    it at each; returns (first divergence or None, final state)."""
    table = K10.knob_table(kn, ckn, keys.shape[0])
    for t in range(ticks):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        want = pct._ctrler_service_tick(cfg, kcfg, ks, pre.alive, pre.base,
                                        s, keys, kn, ckn)
        got = K10._launch(cfg, kcfg, ks, pre.alive, pre.base, s, keys, table,
                          lib, None)
        d = pct.first_divergence(t, pct.ctrler_state_to_numpy(want),
                                 pct.ctrler_state_to_numpy(got))
        if d is not None:
            return d, want
        ks = want
    return None, ks


@pytest.mark.parametrize("case", list(CASES))
def test_ctrler_kernel_host_build_equals_plain_every_tick(libs, case):
    n, kw, metrics, partitionable, b = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **BASE)
    kcfg = pct.CtrlerConfig(**({} if kw == "rows" else kw))
    with prng.layout(partitionable):
        keys = engine.cluster_keys(11, b, "cpu")
        kn = cfg.knobs()
        ckn = (chip_smoke.ctrler_knob_rows(kcfg, b) if kw == "rows"
               else kcfg.knobs())
        ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
        d, final = host_vs_plain(cfg, kcfg, ks, keys, kn, ckn,
                                 libs[metrics], TICKS)
    assert d is None, d
    assert final.clerk_acked.sum() > 0
    assert final.w_cfg_num.sum() > 0 and final.queries_done.sum() > 0
    if kw == "rows":
        viol = final.raft.violations != 0
        assert viol.any() and not viol[torch.arange(b) % 5 == 0].any()
    if case == "ng10_jm1_full_history":
        assert (final.w_cfg_num == kcfg.n_configs - 1).any()


@pytest.mark.parametrize("metrics", [False, True])
def test_ctrler_kernel_host_build_on_states_at_mixed_ticks(libs, metrics):
    """Two storm batches run to different ticks, side by side in one
    batch (a pool's lanes), then ticked on."""
    cfg = SimConfig(n_nodes=5, metrics=metrics, **BASE)
    kcfg = pct.CtrlerConfig(bug_rotate_tiebreak=True)
    kn, ckn = cfg.knobs(), kcfg.knobs()
    parts = []
    for seed, ticks, b in ((3, 23, 6), (4, 71, 7)):
        keys = engine.cluster_keys(seed, b, "cpu")
        ks = pct._advance_ctrler(cfg, kcfg, pct.init_ctrler_cluster(
            cfg, kcfg, keys, kn), keys, kn, ckn, ticks)
        parts.append((ks, keys))
    ks, keys = cat(parts[0][0], parts[1][0]), torch.cat([parts[0][1],
                                                         parts[1][1]])
    assert len(set(ks.raft.tick.tolist())) == 2
    d, _ = host_vs_plain(cfg, kcfg, ks, keys, kn, ckn, libs[metrics], 40)
    assert d is None, d


@pytest.mark.parametrize("n,misaligned", [(3, True), (7, False),
                                           (7, True)])
def test_ctrler_kernel_host_build_staging_edges(libs, n, misaligned):
    """The staging plan at its edges through the host build: inputs one
    element off their alignment (word and byte rows only, the log rows by
    words) or aligned (the bulk rows), a ragged batch of five, K10-metrics
    at ten gids (byte rows of 10 and n * 10 bytes, word rows of n words),
    n = 3 and 7, every leaf after each of 20 ticks from tick 30."""
    cfg = SimConfig(n_nodes=n, metrics=True, **BASE)
    kcfg = pct.CtrlerConfig(n_gids=10, p_move=0.2)
    b = 5
    keys = engine.cluster_keys(17, b, "cpu")
    kn, ckn = cfg.knobs(), kcfg.knobs()
    ks = pct._advance_ctrler(cfg, kcfg, pct.init_ctrler_cluster(
        cfg, kcfg, keys, kn), keys, kn, ckn, 30)
    table = K10.knob_table(kn, ckn, b)
    for t in range(20):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        want = pct._ctrler_service_tick(cfg, kcfg, ks, pre.alive, pre.base,
                                        s, keys, kn, ckn)
        ks_in, s_in = ((_kernel_host.misaligned(ks),
                        _kernel_host.misaligned(s)) if misaligned
                       else (ks, s))
        got = K10._launch(cfg, kcfg, ks_in, ks_in.raft.alive,
                          ks_in.raft.base, s_in, keys, table, libs[True],
                          None)
        d = pct.first_divergence(t, pct.ctrler_state_to_numpy(want),
                                 pct.ctrler_state_to_numpy(got))
        assert d is None, d
        ks = want
    assert ks.clerk_acked.sum() > 0


def test_ctrler_kernel_host_build_on_the_walker_stall(libs):
    """The constructed slid-window state (shadow_base past the walker's
    frontier, the reference test's): the kernel raises the sticky stall
    as the plain version does."""
    cfg = SimConfig(n_nodes=5, **{**BASE, "loss_prob": 0.0, "p_crash": 0.0,
                                  "p_repartition": 0.0})
    kcfg = pct.CtrlerConfig()
    keys = engine.cluster_keys(3, 5, "cpu")
    kn, ckn = cfg.knobs(), kcfg.knobs()
    ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
    ks = ks._replace(raft=ks.raft._replace(
        shadow_len=torch.full((5,), cfg.log_cap + 5, dtype=torch.int32),
        shadow_base=torch.full((5,), 5, dtype=torch.int32)))
    d, final = host_vs_plain(cfg, kcfg, ks, keys, kn, ckn, libs[False], 6)
    assert d is None, d
    assert final.w_stalled.all()


def test_ctrler_kernel_refuses_what_it_does_not_take(libs):
    cfg = SimConfig(n_nodes=5, **BASE)
    kcfg = pct.CtrlerConfig()
    keys = engine.cluster_keys(1, 4, "cpu")
    kn, ckn = cfg.knobs(), kcfg.knobs()
    ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
    s = step_cluster(cfg, ks.raft, keys, kn)
    table = K10.knob_table(kn, ckn, 4)
    args = (cfg, kcfg, ks, ks.raft.alive, ks.raft.base, s, keys, table)
    # the metrics build refuses a metrics-off state (its descriptor check)
    with pytest.raises(RuntimeError, match="ctrler_launch"):
        K10._launch(*args, libs[True], None)
    bad = ks._replace(hist=ks.hist.to(torch.int64))
    with pytest.raises(ValueError, match="hist"):
        K10._launch(cfg, kcfg, bad, *args[3:], libs[False], None)
    with pytest.raises(ValueError, match="keys"):
        K10._launch(*args[:6], keys[:3], table, libs[False], None)
    with pytest.raises(ValueError, match="n_configs"):
        K10._launch(cfg, kcfg.replace(n_configs=300), *args[2:], libs[False],
                    None)
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        K10.ctrler_tick(cfg, kcfg, ks, ks.raft.alive, ks.raft.base,
                        s._replace(tick=s.tick.to("meta")), keys, kn, ckn)
