"""K6-ctrler on the CPU: K6 with the shard controller's service tick after
each raft tick of a chunk (``kernels/ctrler.py`` ``ctrler_chunk``,
``csrc/tick.cuh`` ``ctrler_tick`` on ``csrc/ctrler.cuh``'s phases), its
device code built for the host with g++ (``tests/tick_host_emu.cpp`` with
``-DMADRAFT_K6_CTRLER``, the plain and metrics builds, module-scoped) and
driven through the wrapper's own marshalling
(``kernels.tick._launch(..., side=kernels.ctrler.Side(...))``):

- every ``CtrlerState`` leaf, the raft leaves included, equals the plain
  route's (``step_cluster``, then ``_ctrler_service_tick``) after every
  launch (from a state WARM ticks in), at n = 3, 5 and 7 at cap 32 (n = 5
  the K6-ctrler builds' own template instance, the others the runtime
  one) and at the template instances of caps 16 and 64, under each ctrler
  bug and a raft bug, with 32 clients, with [B] knob rows mixing the bugs
  (the sweep), metrics on and off, both threefry layouts, each in batches
  of three clusters (the second tile of the second warp lies past the
  batch's end); one case's compared launches hold a tick on which a node
  installs the snapshot of a sender that compacts on the same tick;
- ``tpusim.ctrler._advance_ctrler``'s chunking (K6-ctrler launches of up
  to ``engine.KERNEL_CHUNK`` ticks: 300 ticks in a launch of 256 and a
  short one of 44) gives the CPU route's final state;
- the host build equals the live JAX package's ``ctrler_step`` over a
  storm batch's first ticks, leaf by leaf;
- the builds refuse what they do not take.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import _tick_host
import chip_smoke
import test_torch_ctrler as tct
from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import ctrler as jct
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.kernels import ctrler as K10
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import ctrler as pct
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.step import step_cluster

I32 = torch.int32
SEED = 11
# the ticks a case runs on K6-ctrler before the compared launches (past the
# first elections and configs), and the compared launches' lengths
WARM = 40
LAUNCHES = (8, 1, 11)
# the ctrler tests' storm faults, at the compaction pace of each ring
STORM = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
             p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
             p_heal=0.05)
CAP = {16: dict(log_cap=16, compact_every=4),
       32: dict(log_cap=32, compact_every=8),
       64: dict(log_cap=64, compact_every=16)}
# name -> (n, cap, ctrler config ("rows": the mixed knob rows), raft
# overrides, metrics, partitionable)
CASES = {
    "n5_cap32": (5, 32, {}, {}, False, True),
    "n3_cap32_metrics_legacy": (3, 32, {}, {}, True, False),
    "n7_cap32_rotate_tiebreak": (7, 32, {"bug_rotate_tiebreak": True}, {},
                                 True, True),
    "n5_cap16_greedy_rebalance": (5, 16, {"bug_greedy_rebalance": True}, {},
                                  False, False),
    "n3_cap64_full_reshuffle": (3, 64, {"bug_full_reshuffle": True}, {}, True,
                                True),
    "raft_bug_ack_before_fsync": (5, 32, {}, {"bug": "ack_before_fsync"},
                                  True, False),
    # 32 clients: the tile's lanes take two clerks each
    "n7_cap64_clients_32": (7, 64, {"n_clients": 32, "n_gids": 10}, {}, True,
                            True),
    "mixed_rows": (5, 32, "rows", {}, True, True),
    # crashes and compactions often enough that, at its seed, a node
    # installs the snapshot of a sender compacting on the same tick (tick
    # 50, in the second compared launch)
    "install_after_compaction": (5, 16, {}, dict(p_crash=0.05), False, True),
}
# a case's seed where it is not SEED
SEEDS = {"install_after_compaction": 15}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """K6-ctrler's plain and metrics builds for the host, by build name."""
    return _tick_host.build(tmp_path_factory.mktemp("tick_ctrler"),
                            ("tick_ctrler", "tick_metrics_ctrler"))


def launch(lib, cfg, kcfg, ks, keys, kn, ckn, m: int):
    """One K6-ctrler launch of m ticks on the host build ``lib``."""
    b = keys.shape[0]
    out, launched = K6._launch(
        cfg, ks.raft, keys, kn, m, lib, None, table=K6.knob_table(kn, b),
        side=K10.Side(cfg, kcfg, ks, K10.knob_table(kn, ckn, b)))
    assert launched
    return out


def installs_after_compaction(cfg, kcfg, ks, keys, kn, ckn, m: int) -> int:
    """The ticks of the plain route's next m on which a node installs the
    snapshot of a sender whose own snapshot the same tick rewrites (its
    compaction capture, or its own install)."""
    hits = 0
    for _ in range(m):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        src = s.snap_installed_src
        rewrite = (((s.base != pre.base) & s.alive) | (src >= 0))
        sender = torch.gather(rewrite, 1, src.clamp(0, cfg.n_nodes - 1).long())
        hits += int(((src >= 0) & sender).any())
        ks = pct._ctrler_service_tick(cfg, kcfg, ks, pre.alive, pre.base, s,
                                      keys, kn, ckn)
    return hits


@pytest.mark.parametrize("case", list(CASES))
def test_k6_ctrler_equals_the_plain_route_after_every_launch(host, case):
    n, cap, kw, raft, metrics, flag = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **{**STORM, **CAP[cap],
                                                   **raft})
    kcfg = pct.CtrlerConfig(**({} if kw == "rows" else kw))
    want_instance = (0 if (n, cap) not in K6.CTRLER_SHAPES
                     else 1 + K6.CTRLER_SHAPES.index((n, cap)))
    lib = host[K6.variant(metrics, False, ctrler=True)]
    assert K6.instance(cfg, ctrler=True) == want_instance
    assert lib.tick_instance(n, cap, cfg.ae_max) == want_instance
    b = 3
    with threefry_layout(flag):
        keys = pengine.cluster_keys(SEEDS.get(case, SEED), b, "cpu")
        kn = cfg.knobs()
        ckn = (chip_smoke.ctrler_knob_rows(kcfg, b) if kw == "rows"
               else kcfg.knobs())
        ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
        # past the first elections and configs on K6-ctrler itself, then
        # launches held to the plain route
        ks = launch(lib, cfg, kcfg, ks, keys, kn, ckn, WARM)
        start = ks
        done = 0
        for m in LAUNCHES:
            got = launch(lib, cfg, kcfg, ks, keys, kn, ckn, m)
            want = K10.ctrler_chunk_plain(cfg, kcfg, ks, keys, kn, ckn, m)
            done += m
            d = pct.first_divergence(done, pct.ctrler_state_to_numpy(want),
                                     pct.ctrler_state_to_numpy(got))
            assert d is None, d
            ks = want
        if case == "install_after_compaction":
            assert installs_after_compaction(cfg, kcfg, start, keys, kn, ckn,
                                             sum(LAUNCHES)) > 0
    assert ks.clerk_acked.sum() > 0, "no op acked"
    assert ks.w_cfg_num.sum() > 0, "no config created"


def test_k6_ctrler_chunks_of_a_long_run(host, monkeypatch):
    """300 ticks through ``_advance_ctrler`` on the kernel route: a
    K6-ctrler launch of 256 ticks and one of 44 (the host build standing in
    for the card's), equal to the CPU route's run; two clusters, one warp
    of the host build."""
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[32])
    kcfg = pct.CtrlerConfig()
    keys = pengine.cluster_keys(SEED, 2, "cpu")
    kn, ckn = cfg.knobs(), kcfg.knobs()
    ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
    want = pct._advance_ctrler(cfg, kcfg, ks, keys, kn, ckn, 300)
    ms = []

    def ctrler_chunk(cfg_, kcfg_, ks_, keys_, kn_, ckn_, m, table, ctable):
        ms.append(m)
        return launch(host["tick_ctrler"], cfg_, kcfg_, ks_, keys_, kn_,
                      ckn_, m)

    monkeypatch.setattr(pengine, "tick_route", lambda *a, **k: "kernel")
    monkeypatch.setattr(K10, "ctrler_chunk", ctrler_chunk)
    got = pct._advance_ctrler(cfg, kcfg, ks, keys, kn, ckn, 300)
    assert ms == [pengine.KERNEL_CHUNK, 300 - pengine.KERNEL_CHUNK]
    d = pct.first_divergence(300, pct.ctrler_state_to_numpy(want),
                             pct.ctrler_state_to_numpy(got))
    assert d is None, d
    assert want.clerk_acked.sum() > 0 and want.w_cfg_num.sum() > 0


def test_k6_ctrler_equals_the_reference_ctrler_step(host):
    """A storm batch (the JAX ctrler tests' config) from init: the host
    build's state after each launch equals the live JAX ``ctrler_step``'s,
    leaf by leaf."""
    with threefry_layout(True):
        jcfg = JaxCfg(**tct.BASE, metrics=False)
        cfg = SimConfig(**tct.BASE, metrics=False)
        jk, kcfg = jct.CtrlerConfig(), pct.CtrlerConfig()
        init, step = tct._jax_programs(jcfg.static_key(), jk.static_key(),
                                       True)
        jkeys = jengine._cluster_keys(np.uint32(tct.SEED), tct.CLUSTERS)
        jkn, jckn = jcfg.knobs(), jk.knobs()
        keys = pengine.cluster_keys(tct.SEED, tct.CLUSTERS, "cpu")
        kn, ckn = cfg.knobs("cpu"), kcfg.knobs("cpu")
        js = init(jkeys, jkn)
        ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
        done = 0
        for m in (17, 23):
            for _ in range(m):
                js = step(js, jkeys, jkn, jckn)
            ks = launch(host["tick_ctrler"], cfg, kcfg, ks, keys, kn, ckn, m)
            done += m
            d = pct.first_divergence(done, tct.jax_flat(js),
                                     pct.ctrler_state_to_numpy(ks))
            assert d is None, d
        assert ks.clerk_acked.sum() > 0


def test_k6_ctrler_refuses_what_it_does_not_take(host):
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[32])
    kcfg = pct.CtrlerConfig()
    keys = pengine.cluster_keys(1, 3, "cpu")
    kn, ckn = cfg.knobs(), kcfg.knobs()
    ks = pct.init_ctrler_cluster(cfg, kcfg, keys, kn)
    side = K10.Side(cfg, kcfg, ks, K10.knob_table(kn, ckn, 3))
    # the metrics build refuses a metrics-off state, the ctrler build a
    # launch without the ctrler side or with trace rows
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_metrics_ctrler"],
                   None, side=side)
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_ctrler"], None)
    rows = torch.zeros((4, 3, K6.K8.record_width(cfg)), dtype=I32)
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_ctrler"], None,
                   trace=rows, side=side)
    with pytest.raises(ValueError, match="ctrler_chunk takes .*n_configs"):
        K10.Side(cfg, kcfg.replace(n_configs=300), ks, side.table)
    with pytest.raises(ValueError, match="clerk_seq"):
        K10.Side(cfg, kcfg, ks._replace(clerk_seq=ks.clerk_seq.to(
            torch.int64)), side.table)
