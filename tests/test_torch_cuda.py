"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips. The file imports
only torch and the port, so it also runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerance: exact equality (integer kernels)."""

import json
import pathlib

import pytest
import torch

from _kernel_host import misaligned as misalign
from madraft_tpu_torch.kernels import coverage as K5
from madraft_tpu_torch.kernels import ctrler as K10
from madraft_tpu_torch.kernels import harvest as K7
from madraft_tpu_torch.kernels import kv as K9
from madraft_tpu_torch.kernels import metrics as K4
from madraft_tpu_torch.kernels import oracle as K2
from madraft_tpu_torch.kernels import pack as K3
from madraft_tpu_torch.kernels import shardkv as K11
from madraft_tpu_torch.kernels import threefry as K1
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels import trace as K8
from madraft_tpu_torch.tpusim import (
    config,
    coverage,
    ctrler,
    engine,
    kv,
    metrics,
    prng,
    shardkv,
    state,
    step,
    trace,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(n):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, 2**32, (n, 2), generator=g, dtype=torch.int64)


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("n_nodes", [5, 7])
def test_tick_block_kernel_equals_plain(dev, n_nodes, partitionable):
    keys = _keys(1024).to(dev)
    total = step._block_total(n_nodes)
    for t in (1, 300, 2**20 + 1, 2**31 - 1):
        tt = torch.full((1024,), t, dtype=torch.int32, device=dev)
        before = K1.tick_blocks.launches
        got = K1.tick_block(keys, tt, total, partitionable)
        assert K1.tick_blocks.launches == before + 1
        assert torch.equal(got, K1.tick_block_plain(keys, tt, total, partitionable))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("n_nodes", [5, 7])
def test_tick_blocks_kernel_equals_plain(dev, n_nodes, partitionable):
    # per-cluster first ticks, a chunk crossing 2^31, and a row count that
    # leaves the last warp tile short
    b, n_ticks = 1000, 9
    keys = _keys(b).to(dev)
    total = step._block_total(n_nodes)
    t0 = torch.tensor([1, 300, 2**20 + 1, 2**31 - 4], dtype=torch.int32)
    t0 = t0.repeat(b // 4).to(dev)
    before = K1.tick_blocks.launches
    got = K1.tick_blocks(keys, t0, n_ticks, total, partitionable)
    assert K1.tick_blocks.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (n_ticks, b, total)
    assert torch.equal(got, K1.tick_blocks_plain(keys, t0, n_ticks, total,
                                                 partitionable))


def test_kernel_wrappers_raise_on_what_they_do_not_take(dev):
    keys = _keys(8).to(dev)
    with pytest.raises(ValueError):
        K1.tick_blocks(keys, torch.ones(8, dtype=torch.int64, device=dev), 2,
                       133, True)
    s = _storm_state(dev, 8, 0)
    args = list(_oracle_args(s))
    args[3] = args[3][:, :, :32]
    with pytest.raises(ValueError):
        K2.oracle(*args)


def test_hash_pairs_kernel_equals_plain(dev):
    keys = _keys(512).to(dev)
    x = torch.randint(0, 2**32, (2, 512, 9), dtype=torch.int64).to(dev)
    for a, b in zip(K1.hash_pairs(keys, x[0], x[1]),
                    K1.hash_pairs_plain(keys, x[0], x[1])):
        assert torch.equal(a, b)


def _storm_state(dev, n_clusters, ticks, n_nodes=5, metrics_on=False):
    cfg = config.storm_profiles()["storm"][0].replace(n_nodes=n_nodes,
                                                      metrics=metrics_on)
    keys = engine.cluster_keys(3, n_clusters, dev)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    for _ in range(ticks):
        s = step.step_cluster(cfg, s, keys, kn)
    return s


def _oracle_args(s):
    return (s.alive, s.role, s.term, s.log_term, s.log_val, s.log_len, s.base,
            s.commit, s.prefix_hash, s.shadow_term, s.shadow_val,
            s.shadow_base, s.shadow_len, s.shadow_prefix_hash, s.violations,
            s.first_violation_tick, s.first_leader_tick, s.tick + 1)


@pytest.mark.parametrize("n_clusters,n_nodes", [
    (256, 5), (1001, 5), (256, 3), (256, 7), (256, 4), (256, 9)])
def test_oracle_kernel_equals_plain_on_a_storm_state(dev, n_clusters, n_nodes):
    # 1001 clusters leave the last group of the kernel short; the kernel is
    # compiled for 3, 5 and 7 nodes exactly and for other counts up to 8
    # and 16 with the count read at run time
    args = _oracle_args(_storm_state(dev, n_clusters, 120, n_nodes))
    got, want = K2.oracle(*args), K2.oracle_plain(*args)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_oracle_kernel_flags_planted_violations(dev):
    # one divergence per cluster: each kernel output equals the plain one
    # and the planted bits fire, with the tick recorded
    s = _storm_state(dev, 64, 150)
    h = state.state_to_numpy(s)
    cap = h["log_term"].shape[-1]
    h["alive"][:] = True
    h["violations"][:] = 0
    h["first_violation_tick"][:] = -1
    h["role"][0, :2] = 2
    h["term"][0, 1] = h["term"][0, 0]
    h["base"][1, :2] = max(int(h["base"][1, 0]), 1)
    h["prefix_hash"][1, 1] = h["prefix_hash"][1, 0] ^ 1
    c = next(c for c in range(2, 64) if h["log_len"][c, 0] > h["base"][c, 0])
    for f in ("log_term", "log_val", "log_len", "base"):
        h[f][c, 1] = h[f][c, 0]
    h["log_val"][c, 1, (int(h["log_len"][c, 0]) - 1) % cap] ^= 0x5A5A
    args = _oracle_args(state.state_from_numpy(h, dev))
    got, want = K2.oracle(*args), K2.oracle_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    viol, fvt = got[0].cpu(), got[7].cpu()
    assert viol[0] & 1 and viol[1] & 512 and viol[c] & 2
    assert (fvt[[0, 1, c]] == int(h["tick"][0]) + 1).all()


def test_fuzz_on_the_card_equals_the_cpu(dev):
    cfg = config.storm_profiles()["durability"][0].replace(bug="ack_before_fsync")
    with prng.layout(True):
        before = (K1.tick_blocks.launches, K6.tick_chunk.launches,
                  K2.oracle.launches)
        gpu = engine.fuzz(cfg, 5, 32, 120, device=dev)
        chunks = -(-120 // engine.KERNEL_CHUNK)
        # one K6 launch a chunk; the draws and the oracle run inside K6
        assert (K1.tick_blocks.launches - before[0],
                K6.tick_chunk.launches - before[1],
                K2.oracle.launches - before[2]) == (0, chunks, 0)
        cpu = engine.fuzz(cfg, 5, 32, 120, device="cpu")
    for f in ("violations", "first_violation_tick", "first_leader_tick",
              "committed", "msg_count", "snap_installs"):
        assert (getattr(gpu, f) == getattr(cpu, f)).all(), f


def _numpy(tree):
    return [x.cpu().numpy() for x in tree]


@pytest.mark.parametrize("kind", ["init", "storm", "edge"])
@pytest.mark.parametrize("n_nodes", [3, 5, 7])
def test_pack_kernels_equal_plain(dev, n_nodes, kind):
    # 1000 lanes leave every leaf's last block short
    cfg = config.storm_profiles()["storm"][0].replace(n_nodes=n_nodes)
    s = _storm_state(dev, 1000, 0 if kind == "init" else 60, n_nodes)
    h = state.state_to_numpy(s)
    if kind == "edge":
        h = state.planted_edge_state(cfg, h, n_nodes)
    s, cpu = state.state_from_numpy(h, dev), state.state_from_numpy(h)
    before = (K3.pack_state.launches, K3.unpack_state.launches)
    p = K3.pack_state(cfg, s)
    back = K3.unpack_state(cfg, p)
    assert (K3.pack_state.launches - before[0],
            K3.unpack_state.launches - before[1]) == (1, 1)
    want = state.pack_state(cfg, cpu)
    for f, a, b in zip(state.PackedClusterState._fields, _numpy(p),
                       _numpy(want)):
        assert a.dtype == b.dtype and (a == b).all(), f
    for f, a, b in zip(state.ClusterState._fields, _numpy(back),
                       _numpy(state.unpack_state(cfg, want))):
        assert a.dtype == b.dtype and (a == b).all(), f
    assert state.first_divergence(0, h, state.state_to_numpy(back)) is None


def test_pack_kernels_refuse_what_they_do_not_take(dev):
    cfg = config.storm_profiles()["storm"][0]
    s = _storm_state(dev, 8, 0)
    with pytest.raises(ValueError):
        K3.pack_state(cfg, s._replace(term=s.term.to(torch.int64)))
    p = K3.pack_state(cfg, s)
    with pytest.raises(ValueError):
        K3.unpack_state(cfg, p._replace(log_val=p.log_val[:, :, :32]))
    with pytest.raises(ValueError):
        K3.unpack_state(cfg, p._replace(log_term=p.log_term.cpu()))


def test_pool_on_the_card_equals_the_cpu(dev):
    cfg = config.storm_profiles()["storm"][0].replace(majority_override=2)
    runs = {}
    with prng.layout(True):
        for where in (dev, "cpu"):
            rows = []
            before = (K1.tick_blocks.launches, K3.pack_state.launches,
                      K3.unpack_state.launches)
            s = engine.run_pool(cfg, 7, 64, 64, chunk_ticks=32,
                                budget_ticks=128, on_retired=rows.append,
                                device=where)
            launched = (K1.tick_blocks.launches - before[0],
                        K3.pack_state.launches - before[1],
                        K3.unpack_state.launches - before[2])
            runs[str(where)] = (rows, s, launched)
    (rows_g, s_g, launched), (rows_c, s_c, _) = runs["cuda"], runs["cpu"]
    # four chunks: a harvest's pack each (K6 draws the words); an unpack
    # for each chunk after the first, which runs on the fresh wide batch
    assert launched == (0, 4, 3)
    drop = ("wall_s", "violations_per_s")
    assert [{k: v for k, v in r.items() if k not in drop} for r in rows_g] \
        == [{k: v for k, v in r.items() if k not in drop} for r in rows_c]
    for k in ("retired", "retired_violating", "violating_clusters",
              "effective_cluster_steps", "next_cluster_id", "state_layout",
              "bytes_per_lane"):
        assert s_g[k] == s_c[k], k
    assert s_g["retired_violating"] > 0


@pytest.mark.parametrize("n_clusters,n_nodes", [
    (256, 5), (1001, 5), (256, 3), (256, 7), (256, 4), (256, 9)])
def test_oracle_metrics_instance_equals_plain(dev, n_clusters, n_nodes):
    # the metrics instance of each template: shadow_sub as the tenth output
    s = _storm_state(dev, n_clusters, 120, n_nodes, metrics_on=True)
    args = _oracle_args(s)
    before = (K2.oracle.launches, K2.oracle.metrics_launches)
    got = K2.oracle(*args, log_tick=s.log_tick)
    assert (K2.oracle.launches - before[0],
            K2.oracle.metrics_launches - before[1]) == (1, 1)
    want = K2.oracle_plain(*args, log_tick=s.log_tick)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the metrics-off instance on the same state computes the nine as before
    for a, b in zip(K2.oracle(*args), want[:9]):
        assert torch.equal(a, b)


def _fold_args_to(args, dev):
    return tuple(_fold_args_to(x, dev) if isinstance(x, tuple) else x.to(dev)
                 for x in args)


def _fold_equal(got, want):
    flat = lambda r: [*r[:4], *r[4]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("b,m,p", [(4096, 64, 4), (1001, 64, 4), (64, 33, 5),
                                   (9, 1, 0)])
def test_latency_fold_kernel_equals_plain_on_planted_inputs(dev, b, m, p):
    cpu = metrics.planted_fold_inputs(b, m, p, seed=b + m)
    before = K4.latency_fold.launches
    got = K4.latency_fold(*_fold_args_to(cpu, dev))
    assert K4.latency_fold.launches == before + 1
    _fold_equal(got, metrics.latency_fold_plain(*cpu))


def test_latency_fold_kernel_equals_plain_on_a_storm_tick(dev):
    # the inputs one metrics-on tick gives the fold, captured at the call
    cfg = config.storm_profiles()["storm"][0].replace(metrics=True)
    keys = engine.cluster_keys(3, 512, dev)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    seen = []

    def keep(*args):
        seen.append(args)
        return fold(*args)

    fold = K4.latency_fold
    K4.latency_fold = keep
    try:
        for _ in range(120):
            s = step.step_cluster(cfg, s, keys, kn)
    finally:
        K4.latency_fold = fold
    assert len(seen) == 120
    assert sum(int((a[1]).sum()) for a in seen) > 0  # commits were folded
    for args in seen[-20:]:
        _fold_equal(K4.latency_fold(*args),
                    metrics.latency_fold_plain(*_fold_args_to(args, "cpu")))


def test_latency_fold_refuses_what_it_does_not_take(dev):
    args = list(_fold_args_to(metrics.planted_fold_inputs(8, 16, 4, 1), dev))
    with pytest.raises(ValueError):
        K4.latency_fold(*args[:1], args[1].to(torch.int32), *args[2:])
    with pytest.raises(ValueError):
        K4.latency_fold(*args[:6], args[6][:, :8], *args[7:])
    with pytest.raises(ValueError):
        K4.latency_fold(args[0].cpu(), *args[1:])


def test_fuzz_with_metrics_on_the_card_equals_the_cpu(dev):
    cfg = config.storm_profiles()["gray_storm"][0].replace(metrics=True)
    with prng.layout(True):
        before = (K4.latency_fold.launches, K2.oracle.metrics_launches,
                  K6.tick_chunk.metrics_launches)
        gpu = engine.fuzz(cfg, 5, 32, 120, device=dev)
        # K6-metrics, one launch: no K4 or K2-metrics launch a tick
        assert (K4.latency_fold.launches - before[0],
                K2.oracle.metrics_launches - before[1],
                K6.tick_chunk.metrics_launches - before[2]) == (0, 0, 1)
        cpu = engine.fuzz(cfg, 5, 32, 120, device="cpu")
    for f in gpu._fields:
        assert (getattr(gpu, f) == getattr(cpu, f)).all(), f
    assert gpu.lat_hist.sum() > 0


@pytest.mark.parametrize("kind", ["storm", "edge"])
def test_pack_kernels_equal_plain_with_metrics_on(dev, kind):
    cfg = config.storm_profiles()["storm"][0].replace(metrics=True)
    h = state.state_to_numpy(_storm_state(dev, 1000, 60, metrics_on=True))
    if kind == "edge":
        h = state.planted_edge_state(cfg, h, 5)
    s, cpu = state.state_from_numpy(h, dev), state.state_from_numpy(h)
    p = K3.pack_state(cfg, s)
    back = K3.unpack_state(cfg, p)
    want = state.pack_state(cfg, cpu)
    assert state.tree_bytes(p) == 3600 * 1000
    for f, a, b in zip(state.PackedClusterState._fields, _numpy(p),
                       _numpy(want)):
        assert a.dtype == b.dtype and (a == b).all(), f
    assert state.first_divergence(0, h, state.state_to_numpy(back)) is None


def _seen_pair(ccfg, b, shards, dev):
    fresh = torch.full((shards, ccfg.bitmap_bits), coverage.UNSEEN,
                       dtype=torch.int32)
    return ((fresh.to(dev), torch.zeros(b, dtype=torch.int32, device=dev)),
            (fresh.clone(), torch.zeros(b, dtype=torch.int32)))


@pytest.mark.parametrize("n_nodes,mode", [
    (3, "identity"), (5, "identity"), (3, "hashed"), (5, "hashed"),
    (7, "hashed"), (5, "hashed_small"), (7, "hashed_small")])
@pytest.mark.parametrize("shards", [None, 1, 4])
def test_seen_update_kernel_equals_plain(dev, n_nodes, mode, shards):
    # planted lanes (random rows, 8 lanes on one code, violated lanes,
    # int32 extremes) over three ticks: the stamps and every credit equal
    # the plain version's; a 16-bit seen-set makes many lanes collide. The
    # identity mode takes the ground-truth alphabet, its seen-set sized to
    # the code space (2^14 bits at n = 3, 2^23 at n = 5)
    ccfg = {"identity": config.coverage_ground_truth()[1],
            "hashed": config.CoverageConfig(),
            "hashed_small": config.CoverageConfig(bitmap_bits=16)}[mode]
    if mode == "identity":
        space = coverage.code_space(n_nodes, ccfg)
        ccfg = ccfg.replace(bitmap_bits=1 << (space - 1).bit_length())
        assert coverage.identity_mapped(n_nodes, ccfg)
    b = 1000
    cpu_in = coverage.planted_fingerprint_inputs(n_nodes, b, n_nodes)
    rows_c = None if shards is None else coverage.lane_shards(b, shards)
    (seen_g, nf_g), (seen_c, nf_c) = _seen_pair(ccfg, b, shards or 1, dev)
    gpu_in = [x.to(dev) for x in cpu_in]
    rows_g = None if rows_c is None else rows_c.to(dev)
    for t in (0, 1, 2):
        before = K5.seen_update.launches
        K5.seen_update(ccfg, *gpu_in, rows_g, seen_g, nf_g, t)
        assert K5.seen_update.launches == before + 1
        coverage.seen_update_plain(ccfg, *cpu_in, rows_c, seen_c, nf_c, t)
        assert torch.equal(seen_g.cpu(), seen_c) and torch.equal(nf_g.cpu(), nf_c)
        # the next tick's rows: half the lanes move on
        cpu_in = list(cpu_in)
        cpu_in[2] = torch.where(torch.arange(b)[:, None] % 2 == 1,
                                cpu_in[2] + 1, cpu_in[2])
        gpu_in = [x.to(dev) for x in cpu_in]
    assert int(nf_c[8:16].min()) >= 1  # all lanes on one new code earn it
    assert int(nf_c[16:24].max()) == 0  # violated lanes neither


def test_seen_update_kernel_refuses_what_it_does_not_take(dev):
    ccfg = config.CoverageConfig()
    args = [x.to(dev) for x in coverage.planted_fingerprint_inputs(5, 64, 1)]
    (seen, nf), _ = _seen_pair(ccfg, 64, 1, dev)
    with pytest.raises(ValueError):
        K5.seen_update(ccfg, args[0].to(torch.int64), *args[1:], None, seen,
                       nf, 0)
    with pytest.raises(ValueError):
        K5.seen_update(ccfg, *args, None, seen[:, :1024], nf, 0)
    with pytest.raises(ValueError):
        K5.seen_update(ccfg, *args, None, seen.cpu(), nf, 0)
    with pytest.raises(ValueError):
        K5.seen_update(ccfg, *args, None, seen, nf, coverage.UNSEEN)


def test_refill_grid_on_the_card_matches_the_reference_hash():
    # the plain exp2 / FMA arithmetic on the card over all 2^23 uniforms,
    # against the SHA-256 of the JAX package's results (recorded on the CPU)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fx = json.loads((pathlib.Path(__file__).parent / "torch_fixtures" /
                     "coverage_legs.json").read_text())["exp_grid"]
    gt = config.coverage_ground_truth()[1]
    for name, ccfg in (("default", config.CoverageConfig()),
                       ("ground_truth", gt)):
        mut, fresh = coverage.refill_grid(ccfg, "cuda")
        assert coverage.grid_sha256([mut.cpu(), fresh.cpu()]) \
            == fx[name]["sha256"], name


@pytest.mark.parametrize("devices,metrics_on", [(None, False), (1, True)])
def test_coverage_pool_on_the_card_equals_the_cpu(dev, devices, metrics_on):
    cfg = config.storm_profiles()["storm"][0].replace(metrics=metrics_on)
    runs = {}
    with prng.layout(True):
        for where in (dev, "cpu"):
            rows = []
            before = (K5.seen_update.launches,
                      K6.tick_chunk.coverage_launches, K5.credit_pass.launches,
                      K7.harvest.launches)
            s = engine.run_pool(cfg, 7, 64, 64, chunk_ticks=32,
                                budget_ticks=192, on_retired=rows.append,
                                devices=devices,
                                coverage=config.CoverageConfig(), device=where)
            runs[str(where)] = (rows, s, (
                K5.seen_update.launches - before[0],
                K6.tick_chunk.coverage_launches - before[1],
                K5.credit_pass.launches - before[2],
                K7.harvest.launches - before[3]))
    (rows_g, s_g, launched), (rows_c, s_c, _) = runs["cuda"], runs["cpu"]
    # K6-coverage, a credit pass and a K7 harvest a chunk
    assert launched == (0, 6, 6, 6)
    drop = ("wall_s", "violations_per_s")
    assert [{k: v for k, v in r.items() if k not in drop} for r in rows_g] \
        == [{k: v for k, v in r.items() if k not in drop} for r in rows_c]
    cov_g, cov_c = (dict(x["coverage"]) for x in (s_g, s_c))
    cov_g.pop("new_fingerprints_per_s")
    cov_c.pop("new_fingerprints_per_s")
    assert cov_g == cov_c
    assert cov_g["refills_mutated"] > 0


def test_sweep_on_the_card_equals_the_cpu(dev):
    cfg = config.SimConfig().replace(max_dead=2, p_restart=0.2, p_heal=0.05)
    loss = torch.tensor([0.0, 0.1, 0.3], dtype=torch.float32)
    kn = cfg.knobs()._replace(loss_prob=loss.repeat_interleave(8))
    reps = {}
    with prng.layout(True):
        for where, umc in ((dev, 8), (dev, 0), ("cpu", 0)):
            fn = engine.make_sweep_fn(cfg, kn, 24, 100, uniform_max_cells=umc,
                                      device=where)
            reps[(str(where), fn.dispatch)] = engine.report(fn(11))
    assert set(reps) == {("cuda", "uniform"), ("cuda", "per_cluster"),
                         ("cpu", "per_cluster")}
    want = reps[("cpu", "per_cluster")]
    for rep in reps.values():
        for f in ("violations", "first_violation_tick", "first_leader_tick",
                  "committed", "msg_count", "snap_installs"):
            assert (getattr(rep, f) == getattr(want, f)).all(), f


def _k6_start(cfg, b, seed, dev, kn=None, mixed=False):
    """A batch at tick 0, or with two lanes in three 45 ticks on (lanes at
    their own ticks, as the pool's after a harvest); built on the CPU."""
    keys = engine.cluster_keys(seed, b, "cpu")
    kn = cfg.knobs() if kn is None else kn
    s = state.init_cluster(cfg, keys, kn)
    if mixed:
        later = engine._advance(cfg, s, keys, kn, 45)
        sel = torch.arange(b) % 3 != 0
        s = state.ClusterState(*(
            torch.where(sel.view(-1, *(1,) * (x.dim() - 1)), y, x)
            if x.numel() else x for x, y in zip(s, later)))
    return s.__class__(*(x.to(dev) for x in s)), keys.to(dev), kn.to(dev)


def _k6_rows(b):
    """[B] knob rows: four storm profiles in turn, the quorum varied."""
    profiles = ("storm", "gray_storm", "limp", "fsync_stall")
    kns = [config.storm_profiles()[profiles[i % 4]][0].knobs()
           for i in range(b)]
    kn = config.Knobs(*(torch.stack(xs) for xs in zip(*kns)))
    return kn._replace(majority=torch.tensor([3, 2, 3, 4],
                                             dtype=torch.int32).repeat(b // 4))


_CAP16 = dict(log_cap=16, compact_every=4, uncommitted_cap=4)


@pytest.mark.parametrize("case", [
    "n3", "n5", "n7", "n5_rows_ragged", "n5_mixed", "n7_grant_any_vote",
    "n5_no_truncate", "n5_majority2", "n3_cap16", "n5_cap16", "n7_cap16",
    "n4_cap32_runtime", "n5_forced_runtime", "n5_legacy", "n7_legacy_cap16",
    "n5_wrap", "n5_rolling", "n5_rolling_wrap", "n5_b127"])
def test_tick_kernel_equals_plain_every_chunk(dev, case):
    storm = config.storm_profiles()[
        "rolling_wave" if "rolling" in case else "storm"][0]
    n = int(case[1])
    cfg = storm.replace(n_nodes=n)
    if case.endswith(("grant_any_vote", "no_truncate")):
        cfg = cfg.replace(bug=case.split("_", 1)[1])
    if case.endswith("majority2"):
        cfg = cfg.replace(majority_override=2)
    if "cap16" in case:
        cfg = cfg.replace(**_CAP16)
    if "cap32" in case:
        cfg = cfg.replace(log_cap=32, compact_every=8)
    if case.endswith("forced_runtime"):  # one more entry a message
        cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)
    assert (K6.instance(cfg) == 0) == ("runtime" in case)
    b = 127 if case.endswith("b127") else 128  # 127: a warp's last tile idle
    kn = _k6_rows(b) if "rows" in case else None
    s, keys, kn = _k6_start(cfg, b, 7, dev, kn, mixed="mixed" in case)
    if "wrap" in case:  # ticks across the int32 and the u32 wraps
        s = s._replace(tick=torch.tensor([2**31 - 10, -20, 1000] * 43,
                                         dtype=torch.int32)[:b].to(dev))
    chunk = 7 if "ragged" in case else 32
    done = 0
    with prng.layout("legacy" not in case):
        while done < 160:
            m = min(chunk, 160 - done)
            before = K6.tick_chunk.launches
            got = K6.tick_chunk(cfg, s, keys, kn, m)
            assert K6.tick_chunk.launches == before + 1
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m)
            done += m
            d = state.first_divergence(done, state.state_to_numpy(want),
                                       state.state_to_numpy(got))
            assert d is None, d
            s = want
    assert int(s.msg_count.sum()) > 0


def test_tick_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.storm_profiles()["storm"][0]
    s, keys, kn = _k6_start(cfg, 8, 1, dev)
    with pytest.raises(ValueError, match="metrics plane"):
        K6.tick_chunk(cfg.replace(metrics=True), s, keys, kn, 2)
    with pytest.raises(ValueError, match="keys are"):
        K6.tick_chunk(cfg, s, keys[:4], kn, 2)
    with pytest.raises(ValueError, match="keys are"):
        K6.tick_chunk(cfg, s, keys.cpu(), kn, 2)


def _plant_metric_registers(s):
    """Stale submit stamps in every ring slot and metric sums a few counts
    below the int32 wrap; lanes in turn with an empty, a held and a kept
    worst-op register (on the CPU)."""
    b = s.tick.shape[0]
    g = torch.Generator().manual_seed(5)
    top = 2**31 - 1

    def near(x):
        return (top - torch.randint(0, 4, x.shape, generator=g)).to(
            torch.int32)

    kind = torch.arange(b) % 3
    return s._replace(
        log_tick=torch.randint(1, 6, s.log_tick.shape, generator=g,
                               dtype=torch.int32),
        lat_hist=near(s.lat_hist), ev_counts=near(s.ev_counts),
        phase_hist=near(s.phase_hist), phase_ticks=near(s.phase_ticks),
        lat_ticks=near(s.lat_ticks),
        worst_lat=torch.where(kind == 2, 2**30, torch.where(
            kind == 0, 10**6, 0)).to(torch.int32)[:, None],
        worst_sub=torch.where(kind == 0, 0, 5).to(torch.int32)[:, None])


@pytest.mark.parametrize("case", [
    "n3", "n5", "n7", "n3_cap16", "n5_cap16", "n7_cap16", "n5_forced_runtime",
    "n5_legacy", "n5_wrap", "n5_registers", "n5_rows_bug", "n5_4096"])
def test_tick_metrics_kernel_equals_plain_every_chunk(dev, case):
    storm = config.storm_profiles()["storm"][0].replace(metrics=True)
    cfg = storm.replace(n_nodes=int(case[1]),
                        **(_CAP16 if "cap16" in case else {}))
    if case.endswith("forced_runtime"):
        cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)
    if case.endswith("bug"):
        cfg = cfg.replace(bug="commit_any_term")
    b = 4096 if case.endswith("4096") else 128  # 4096: the flagship's wave
    s, keys, kn = _k6_start(cfg, b, 7, "cpu",
                            _k6_rows(b) if "rows" in case else None)
    if "registers" in case:
        s = _plant_metric_registers(s)
    if "wrap" in case:
        s = s._replace(tick=torch.tensor([2**31 - 10, -20, 1000] * 43,
                                         dtype=torch.int32)[:b])
    s = s.__class__(*(x.to(dev) for x in s))
    keys, kn = keys.to(dev), kn.to(dev)
    done = 0
    with prng.layout("legacy" not in case):
        while done < 160:
            m = min(64, 160 - done)
            before = K6.tick_chunk.metrics_launches
            got = K6.tick_chunk(cfg, s, keys, kn, m)
            assert K6.tick_chunk.metrics_launches == before + 1
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m)
            done += m
            d = state.first_divergence(done, state.state_to_numpy(want),
                                       state.state_to_numpy(got))
            assert d is None, d
            s = want
    assert int(s.lat_hist.sum()) != 0


@pytest.mark.parametrize("case", [
    "one_row", "shards_16bits", "identity", "violated", "metrics"])
def test_tick_coverage_kernel_equals_plain_every_chunk(dev, case):
    cfg, ccfg, shards = (config.storm_profiles()["storm"][0],
                         config.CoverageConfig(), None)
    if case == "shards_16bits":
        ccfg, shards = config.CoverageConfig(bitmap_bits=16), 4
    elif case == "identity":
        cfg, ccfg, _ = config.coverage_ground_truth()
    elif case == "violated":
        cfg = cfg.replace(majority_override=2)
    elif case == "metrics":
        cfg, shards = cfg.replace(metrics=True), 2
    b = 256
    s, keys, kn = _k6_start(cfg, b, 7, dev)
    rows = None if shards is None else coverage.lane_shards(b, shards, dev)
    fp_cfg = ccfg.fingerprint_key()
    seen_k = torch.full((shards or 1, ccfg.bitmap_bits), coverage.UNSEEN,
                        dtype=torch.int32, device=dev)
    nf_k = torch.zeros(b, dtype=torch.int32, device=dev)
    seen_p, nf_p = seen_k.clone(), nf_k.clone()
    done = 0
    with prng.layout(True):
        while done < 160:
            m = min(64, 160 - done)
            before = (K6.tick_chunk.coverage_launches,
                      K5.credit_pass.launches)
            got = K6.tick_chunk(cfg, s, keys, kn, m, cov=K6.Seen(
                fp_cfg, seen_k, rows, nf_k, done))
            assert (K6.tick_chunk.coverage_launches,
                    K5.credit_pass.launches) == (before[0] + 1, before[1] + 1)
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m, cov=K6.Seen(
                fp_cfg, seen_p, rows, nf_p, done))
            done += m
            d = state.first_divergence(done, state.state_to_numpy(want),
                                       state.state_to_numpy(got))
            assert d is None, d
            assert torch.equal(seen_k, seen_p) and torch.equal(nf_k, nf_p)
            s = want
    assert int(nf_p.sum()) >= int((seen_p != coverage.UNSEEN).sum()) > 1


def test_credit_pass_kernel_equals_plain(dev):
    g = torch.Generator().manual_seed(3)
    m, b, bits = 256, 4096, 1 << 12
    seen = torch.randint(0, m + 8, (2, bits), generator=g, dtype=torch.int32)
    fp = torch.randint(-1, 2 * bits, (m, b), generator=g, dtype=torch.int32)
    nf = torch.randint(0, 9, (b,), generator=g, dtype=torch.int32)
    want = K5.credit_plain(fp, seen, nf.clone(), 4)
    got = K5.credit_pass(fp.to(dev), seen.to(dev), nf.to(dev), 4)
    assert torch.equal(got.cpu(), want) and int((want - nf).sum()) > 0


# ---- K7, the pool harvest
@pytest.mark.parametrize("case", ["mixed", "all", "none", "eto_edge"])
@pytest.mark.parametrize("cov_mode", [None, "guided", "random"])
@pytest.mark.parametrize("lane_ids", [False, True])
def test_harvest_kernel_equals_plain(dev, case, cov_mode, lane_ids):
    # 1100 lanes: the monotone ranks carry across the scan's 1024-lane
    # tiles; metrics on and off, both threefry layouts
    for metrics_on in (False, True):
        cfg = config.storm_profiles()["storm"][0].replace(metrics=metrics_on)
        for flag in (True, False):
            with prng.layout(flag):
                args = K7.planted_inputs(cfg, 1100, case, lane_ids, cov_mode,
                                         11)
                want = K7.harvest_plain(cfg, *args)
                before = K7.harvest.launches
                got = K7.harvest(cfg, *K7.inputs_to(args, dev))
                assert K7.harvest.launches == before + 1
                assert not K7.differences(want, got), (metrics_on, flag)


def test_harvest_refill_grid_kernel_matches_the_plain_hash():
    # K7's refill arithmetic (true FMAs) over all 2^23 uniforms against the
    # plain version's on the CPU, at the default and ground-truth configs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for ccfg in (config.CoverageConfig(), config.coverage_ground_truth()[1]):
        mut, fresh = K7.refill_grid(ccfg, "cuda")
        assert coverage.grid_sha256([mut.cpu(), fresh.cpu()]) \
            == coverage.grid_sha256(coverage.refill_grid(ccfg)), ccfg


def test_harvest_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.storm_profiles()["storm"][0]
    args = K7.inputs_to(K7.planted_inputs(cfg, 8, "mixed", False, None, 1),
                        dev)
    s = args[0]
    bad = s._replace(next_idx=s.next_idx.transpose(1, 2))
    with pytest.raises(ValueError):
        K7.harvest(cfg, bad, *args[1:])
    with pytest.raises(ValueError):
        K7.harvest(cfg, s, args[1].cpu(), *args[2:])


@pytest.mark.parametrize("devices,metrics_on", [(None, False), (1, True)])
def test_pool_on_the_card_runs_the_harvest_kernel(dev, devices, metrics_on):
    cfg = config.storm_profiles()["storm"][0].replace(
        metrics=metrics_on, majority_override=2)
    runs = {}
    with prng.layout(True):
        for where in (dev, "cpu"):
            rows = []
            before = K7.harvest.launches
            s = engine.run_pool(cfg, 7, 64, 64, chunk_ticks=32,
                                budget_ticks=192, on_retired=rows.append,
                                devices=devices, device=where)
            runs[str(where)] = (rows, s, K7.harvest.launches - before)
    drop = ("wall_s", "violations_per_s")
    (rows_g, s_g, n_g), (rows_c, s_c, n_c) = runs["cuda"], runs["cpu"]
    assert (n_g, n_c) == (6, 0)
    assert [{k: v for k, v in r.items() if k not in drop} for r in rows_g] \
        == [{k: v for k, v in r.items() if k not in drop} for r in rows_c]
    assert s_g["retired_violating"] > 0
    wall = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
            "violations_per_s", "compile_s", "dispatch_gap_s",
            "device_wait_s", "host_overlap_s")
    assert {k: v for k, v in s_g.items() if k not in wall} \
        == {k: v for k, v in s_c.items() if k not in wall}


# ---- K8, the flight recorder's row, and the traced replay
@pytest.mark.parametrize("metrics_on", [False, True])
def test_record_kernel_equals_plain(dev, metrics_on):
    cfg = config.storm_profiles()["storm"][0].replace(metrics=metrics_on)
    keys = engine.cluster_keys(3, 256, dev)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    out = torch.empty((256, K8.record_width(cfg)), dtype=torch.int32,
                      device=dev)
    for _ in range(40):
        nxt = K6.tick_chunk(cfg, s, keys, kn, 1)
        before = K8.record.launches
        K8.record(cfg, s, nxt, out)
        assert K8.record.launches == before + 1
        assert torch.equal(out, K8.record_plain(s, nxt))
        s = nxt


@pytest.mark.parametrize("bug,metrics_on", [("", False), ("", True),
                                            ("forget_voted_for", False)])
def test_traced_replay_on_the_card_equals_the_cpu(dev, bug, metrics_on):
    cfg = config.storm_profiles()["storm"][0].replace(metrics=metrics_on,
                                                      bug=bug)
    with prng.layout(True):
        fg, rg = trace.replay_cluster_traced(cfg, 12345, 5, 150, device=dev)
        fc, rc = trace.replay_cluster_traced(cfg, 12345, 5, 150,
                                             device="cpu")
        final = engine.replay_cluster(cfg, 12345, 5, 150, device=dev)
    for a, b, c in zip(fg, fc, final):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    for f in rg._fields:
        assert (getattr(rg, f) == getattr(rc, f)).all(), f
    assert trace.decode_events(rg) == trace.decode_events(rc)
    # one K6-trace launch wrote the 150 rows; no K8 launch
    launches = (K6.tick_chunk.launches, K6.tick_chunk.trace_launches,
                K8.record.launches)
    with prng.layout(True):
        trace.replay_cluster_traced(cfg, 12345, 5, 150, device=dev)
    assert (K6.tick_chunk.launches - launches[0],
            K6.tick_chunk.trace_launches - launches[1],
            K8.record.launches - launches[2]) == (1, 1, 0)


@pytest.mark.parametrize("case", [
    "n5", "n5_metrics", "n3_cap16", "n7_metrics", "n5_runtime_metrics",
    "bug_metrics", "wrap_metrics", "ragged_b1100"])
def test_k6_trace_rows_equal_plain(dev, case):
    """K6-trace (K6 with a trace buffer) against the eager tick with
    record_plain: every row of every tick and the state after each
    launch, 80 ticks in launches of 40 and 24 and 16."""
    storm = config.storm_profiles()["storm"][0].replace(
        metrics="metrics" in case)
    cfg, b, seed, id0 = storm, 3, 7, 0
    if case.startswith("n") and case[1].isdigit():
        cfg = storm.replace(n_nodes=int(case[1]),
                            **(_CAP16 if "cap16" in case else {}))
    if "runtime" in case:
        cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)
    if case.startswith("bug"):  # explain's seed; cluster 32 violates at 87
        cfg = config.storm_profiles()["durability"][0].replace(
            bug="ack_before_fsync", metrics=True)
        seed, id0 = 5, 30
    if case == "ragged_b1100":
        b = 1100
    keys = engine.cluster_keys(seed, b, dev, id0=id0)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    if "wrap" in case:
        s = s._replace(tick=torch.tensor([2**31 - 10, -20, 1000],
                                         dtype=torch.int32, device=dev))
    w = K8.record_width(cfg)
    with prng.layout(True):
        for m in (40, 24, 16) if not case.startswith("bug") else (64,) * 2:
            got_rows = torch.full((m, b, w), -7, dtype=torch.int32,
                                  device=dev)
            want_rows = got_rows.clone()
            before = K6.tick_chunk.trace_launches
            got = K6.tick_chunk(cfg, s, keys, kn, m, trace=got_rows)
            assert K6.tick_chunk.trace_launches == before + 1
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m, trace=want_rows)
            assert torch.equal(got_rows, want_rows)
            d = state.first_divergence(int(want.tick[0]),
                                       state.state_to_numpy(want),
                                       state.state_to_numpy(got))
            assert d is None, d
            s = want
    if case.startswith("bug"):
        assert int(s.first_violation_tick[2]) == 87


# ---- K9, the kv service tick, and the kv path on the card
KV_BASE = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
               p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
               p_heal=0.05, log_cap=64, compact_every=16)


@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {}, False, True),
    (3, {"p_put": 0.2, "bug_skip_dedup": True}, True, False),
    (7, {"bug_apply_uncommitted": True}, False, True),
    (5, {"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2}, True, True),
    (5, {"bug_stale_hint": True, "p_follow_hint": 0.9, "retry_wait": 3},
     True, False),
    (5, {"open_rate": 0.25, "zipf_a": 3.0, "open_queue_cap": 8,
         "p_get": 0.3, "p_put": 0.2}, True, True),
    # the widest tables: a cluster's shared region past 48 KB a block
    (7, {"n_clients": 32, "n_keys": 64, "p_put": 0.2}, True, True),
])
def test_kv_kernel_equals_plain_every_tick(dev, n_nodes, kw, metrics_on,
                                           partitionable):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on, **KV_BASE)
    kcfg = kv.KvConfig(**kw)
    b = 1100  # past a whole number of blocks: the grid's ragged edge
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
        ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
        for t in range(60):
            pre = ks.raft
            s = K6.tick_chunk(cfg, pre, keys, kn, 1)
            want = kv._kv_service_tick(cfg, kcfg, ks, pre.alive, pre.base,
                                       pre.shadow_len, s, keys, kn, kkn)
            before = (K9.kv_tick.launches, K9.kv_tick.metrics_launches)
            got = K9.kv_tick(cfg, kcfg, ks, pre.alive, pre.base,
                             pre.shadow_len, s, keys, kn, kkn)
            assert (K9.kv_tick.launches, K9.kv_tick.metrics_launches) == (
                before[0] + 1, before[1] + int(metrics_on))
            d = kv.first_divergence(t, kv.kv_state_to_numpy(want),
                                    kv.kv_state_to_numpy(got))
            assert d is None, d
            ks = got
    assert ks.clerk_acked.sum() > 0


def test_kv_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **KV_BASE)
    kcfg = kv.KvConfig()
    keys = engine.cluster_keys(1, 8, dev)
    kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
    s = K6.tick_chunk(cfg, ks.raft, keys, kn, 1)
    pre = (ks.raft.alive, ks.raft.base, ks.raft.shadow_len)
    before = K9.kv_tick.launches
    with pytest.raises(ValueError, match="clerk_key"):
        K9.kv_tick(cfg, kcfg, ks._replace(clerk_key=ks.clerk_key.cpu()),
                   *pre, s, keys, kn, kkn)
    with pytest.raises(ValueError, match="n_clients"):
        K9.kv_tick(cfg, kcfg.replace(n_clients=40), ks, *pre, s, keys, kn,
                   kkn)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="kv_launch"):
        K9._launch(cfg, kcfg, ks, *pre, s, keys,
                   K9.knob_table(kn, kkn, 8), K9._lib("kv_metrics"),
                   torch.cuda.current_stream(dev).cuda_stream)
    assert K9.kv_tick.launches == before


@pytest.mark.parametrize("metrics_on", [False, True])
def test_kv_fuzz_on_the_card_equals_the_cpu(dev, metrics_on):
    cfg = config.SimConfig(n_nodes=5, metrics=metrics_on, **KV_BASE)
    kcfg = kv.KvConfig(p_put=0.2, bug_stale_read=True)
    launches = (K6.tick_chunk.launches, K9.kv_tick.launches,
                K9.kv_chunk.launches, K9.kv_chunk.metrics_launches)
    got = kv.kv_fuzz(cfg, kcfg, 5, 64, 300, device=dev)
    # K6-kv a chunk of up to 256 ticks, no K6 or K9 launch
    assert (K6.tick_chunk.launches - launches[0],
            K9.kv_tick.launches - launches[1],
            K9.kv_chunk.launches - launches[2],
            K9.kv_chunk.metrics_launches - launches[3]) == (
                0, 0, 2, 2 * metrics_on)
    want = kv.kv_fuzz(cfg, kcfg, 5, 64, 300, device="cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or (a == b).all(), f


# ---- K6-kv: K6 with the kv service tick after each raft tick of a chunk
@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {}, False, True),
    (5, {"p_put": 0.2}, True, True),
    (3, {"p_put": 0.2, "bug_skip_dedup": True}, True, False),
    (7, {"bug_apply_uncommitted": True}, False, True),
    (5, {"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2}, True, True),
    (5, {"bug_stale_hint": True, "p_follow_hint": 0.9, "retry_wait": 3},
     False, False),
    (5, {"open_rate": 0.25, "zipf_a": 3.0, "open_queue_cap": 8,
         "p_get": 0.3, "p_put": 0.2}, True, True),
    # 32 clients and 64 keys: two clerks a lane of the 16-lane tile
    (7, {"n_clients": 32, "n_keys": 64, "p_put": 0.2}, True, True),
])
def test_k6_kv_kernel_equals_plain_every_launch(dev, n_nodes, kw, metrics_on,
                                                partitionable):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on, **KV_BASE)
    kcfg = kv.KvConfig(**kw)
    b = 1101  # a tile past the batch's end
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
        ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
        ks = K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn, 32)
        acked, done = int(ks.clerk_acked.sum()), 32
        for m in (16, 1, 7):
            before = (K9.kv_chunk.launches, K9.kv_chunk.metrics_launches)
            got = K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn, m)
            assert (K9.kv_chunk.launches, K9.kv_chunk.metrics_launches) == (
                before[0] + 1, before[1] + int(metrics_on))
            want = K9.kv_chunk_plain(cfg, kcfg, ks, keys, kn, kkn, m)
            done += m
            d = kv.first_divergence(done, kv.kv_state_to_numpy(want),
                                    kv.kv_state_to_numpy(got))
            assert d is None, d
            ks = want
    assert ks.clerk_acked.sum() > acked


def test_k6_kv_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **KV_BASE)
    kcfg = kv.KvConfig()
    keys = engine.cluster_keys(1, 8, dev)
    kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
    before = K9.kv_chunk.launches
    with pytest.raises(ValueError, match="clerk_key"):
        K9.kv_chunk(cfg, kcfg, ks._replace(clerk_key=ks.clerk_key.cpu()),
                    keys, kn, kkn, 4)
    with pytest.raises(ValueError, match="n_clients"):
        K9.kv_chunk(cfg, kcfg.replace(n_clients=40), ks, keys, kn, kkn, 4)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4,
                   K6._lib(K6.variant(True, False, kv=True)),
                   torch.cuda.current_stream(dev).cuda_stream,
                   side=K9.Side(cfg, kcfg, ks, K9.knob_table(kn, kkn, 8)))
    assert K9.kv_chunk.launches == before


@pytest.mark.parametrize("verb", ["fuzz", "kv-fuzz", "ctrler-fuzz",
                                  "shardkv-fuzz"])
def test_shapes_past_the_kernels_limits_are_refused_on_the_card(dev, verb,
                                                                capsys):
    # n = 17 nodes: past every kernel's layout, so the card refuses the run
    # before any launch, naming the limit and the CPU route (no kernel's
    # plain version runs on the card)
    from madraft_tpu_torch.__main__ import main

    launches = (K6.tick_chunk.launches, K2.oracle.launches,
                K9.kv_chunk.launches, K10.ctrler_tick.launches,
                K10.ctrler_chunk.launches, K11.shardkv_tick.launches,
                K11.shardkv_chunk.launches)
    rc = main([verb, "--nodes", "17", "--clusters", "8", "--ticks", "64"])
    err = capsys.readouterr().err
    assert rc == 2, err
    assert "n <= 16" in err and "--platform cpu" in err, err
    assert (K6.tick_chunk.launches, K2.oracle.launches,
            K9.kv_chunk.launches, K10.ctrler_tick.launches,
            K10.ctrler_chunk.launches, K11.shardkv_tick.launches,
            K11.shardkv_chunk.launches) == launches


# ---- K10, the shard controller's service tick, and the ctrler path
CTRLER_BASE = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
                   p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
                   p_heal=0.05, log_cap=32, compact_every=8)


@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {}, False, True),
    (3, {"bug_rotate_tiebreak": True}, True, False),
    (7, {"bug_greedy_rebalance": True}, False, True),
    (5, {"bug_full_reshuffle": True}, True, True),
    # ten gids, one an op, and a history that fills
    (5, {"n_gids": 10, "join_max": 1, "n_configs": 6, "p_move": 0.2}, True,
     False),
    # 32 clients: a warp's every lane a clerk
    (7, {"n_clients": 32, "n_gids": 10}, True, True),
])
def test_ctrler_kernel_equals_plain_every_tick(dev, n_nodes, kw, metrics_on,
                                               partitionable):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on,
                           **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig(**kw)
    b = 1100  # past a whole number of blocks: the grid's ragged edge
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
        ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
        for t in range(80):
            pre = ks.raft
            s = K6.tick_chunk(cfg, pre, keys, kn, 1)
            want = ctrler._ctrler_service_tick(cfg, kcfg, ks, pre.alive,
                                               pre.base, s, keys, kn, ckn)
            before = (K10.ctrler_tick.launches,
                      K10.ctrler_tick.metrics_launches)
            got = K10.ctrler_tick(cfg, kcfg, ks, pre.alive, pre.base, s,
                                  keys, kn, ckn)
            assert (K10.ctrler_tick.launches,
                    K10.ctrler_tick.metrics_launches) == (
                before[0] + 1, before[1] + int(metrics_on))
            d = ctrler.first_divergence(t, ctrler.ctrler_state_to_numpy(want),
                                        ctrler.ctrler_state_to_numpy(got))
            assert d is None, d
            ks = got
    assert ks.clerk_acked.sum() > 0 and ks.w_cfg_num.sum() > 0
    assert ks.queries_done.sum() > 0


def test_ctrler_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig()
    keys = engine.cluster_keys(1, 8, dev)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
    s = K6.tick_chunk(cfg, ks.raft, keys, kn, 1)
    pre = (ks.raft.alive, ks.raft.base)
    before = K10.ctrler_tick.launches
    with pytest.raises(ValueError, match="clerk_arg"):
        K10.ctrler_tick(cfg, kcfg, ks._replace(clerk_arg=ks.clerk_arg.cpu()),
                        *pre, s, keys, kn, ckn)
    with pytest.raises(ValueError, match="n_clients"):
        K10.ctrler_tick(cfg, kcfg.replace(n_clients=40), ks, *pre, s, keys,
                        kn, ckn)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="ctrler_launch"):
        K10._launch(cfg, kcfg, ks, *pre, s, keys,
                    K10.knob_table(kn, ckn, 8), K10._lib("ctrler_metrics"),
                    torch.cuda.current_stream(dev).cuda_stream)
    assert K10.ctrler_tick.launches == before


@pytest.mark.parametrize("metrics_on", [False, True])
def test_ctrler_fuzz_on_the_card_equals_the_cpu(dev, metrics_on):
    cfg = config.SimConfig(n_nodes=5, metrics=metrics_on, **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig(bug_rotate_tiebreak=True)
    launches = (K6.tick_chunk.launches, K10.ctrler_tick.launches,
                K10.ctrler_chunk.launches, K10.ctrler_chunk.metrics_launches)
    got = ctrler.ctrler_fuzz(cfg, kcfg, 5, 64, 160, device=dev)
    # one K6-ctrler launch for the 160 ticks, no K6 or K10 launch
    assert (K6.tick_chunk.launches - launches[0],
            K10.ctrler_tick.launches - launches[1],
            K10.ctrler_chunk.launches - launches[2],
            K10.ctrler_chunk.metrics_launches - launches[3]) == (
        0, 0, 1, int(metrics_on))
    want = ctrler.ctrler_fuzz(cfg, kcfg, 5, 64, 160, device="cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or (a == b).all(), f
    assert want.n_violating > 0


# ---- K6-ctrler: K6 with the ctrler service tick after each raft tick of a
# chunk
@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {}, False, True),
    (3, {"bug_rotate_tiebreak": True}, True, False),
    (7, {"bug_greedy_rebalance": True}, False, True),
    (5, {"bug_full_reshuffle": True}, True, True),
    # ten gids, one an op, and a history that fills
    (5, {"n_gids": 10, "join_max": 1, "n_configs": 6, "p_move": 0.2}, True,
     False),
    # 32 clients: two clerks a lane of the 16-lane tile
    (7, {"n_clients": 32, "n_gids": 10}, True, True),
])
def test_k6_ctrler_kernel_equals_plain_every_launch(dev, n_nodes, kw,
                                                    metrics_on,
                                                    partitionable):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on,
                           **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig(**kw)
    b = 1101  # a tile past the batch's end
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
        ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
        ks = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, 48)
        start = [int(x.sum()) for x in (ks.clerk_acked, ks.w_cfg_num)]
        done = 48
        for m in (16, 1, 7):
            before = (K10.ctrler_chunk.launches,
                      K10.ctrler_chunk.metrics_launches)
            got = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, m)
            assert (K10.ctrler_chunk.launches,
                    K10.ctrler_chunk.metrics_launches) == (
                before[0] + 1, before[1] + int(metrics_on))
            want = K10.ctrler_chunk_plain(cfg, kcfg, ks, keys, kn, ckn, m)
            done += m
            d = ctrler.first_divergence(done,
                                        ctrler.ctrler_state_to_numpy(want),
                                        ctrler.ctrler_state_to_numpy(got))
            assert d is None, d
            ks = want
    assert ks.clerk_acked.sum() > start[0] and ks.w_cfg_num.sum() > start[1]


@pytest.mark.parametrize("n_nodes,cap,kw", [
    # K10's largest tables: 16 nodes, a 256-slot ring, 32 clients, ten
    # gids and 256 configs (two 16 KB history tables a cluster, which
    # K6-ctrler keeps in device memory)
    (16, 256, {"n_clients": 32, "n_gids": 10, "n_configs": 256}),
    (9, 128, {"n_clients": 17, "n_configs": 100, "apply_max": 11,
              "walk_max": 13}),
])
def test_k6_ctrler_takes_every_shape_k10_takes(dev, n_nodes, cap, kw):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=True,
                           **{**CTRLER_BASE, "log_cap": cap,
                              "compact_every": cap // 4})
    kcfg = ctrler.CtrlerConfig(**kw)
    b = 37
    keys = engine.cluster_keys(3, b, dev)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
    ks = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, 40)
    got = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, 6)
    want = K10.ctrler_chunk_plain(cfg, kcfg, ks, keys, kn, ckn, 6)
    d = ctrler.first_divergence(46, ctrler.ctrler_state_to_numpy(want),
                                ctrler.ctrler_state_to_numpy(got))
    assert d is None, d


def test_k6_ctrler_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig()
    keys = engine.cluster_keys(1, 8, dev)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
    before = K10.ctrler_chunk.launches
    with pytest.raises(ValueError, match="clerk_arg"):
        K10.ctrler_chunk(cfg, kcfg,
                         ks._replace(clerk_arg=ks.clerk_arg.cpu()), keys, kn,
                         ckn, 4)
    with pytest.raises(ValueError, match="n_clients"):
        K10.ctrler_chunk(cfg, kcfg.replace(n_clients=40), ks, keys, kn, ckn,
                         4)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4,
                   K6._lib(K6.variant(True, False, ctrler=True)),
                   torch.cuda.current_stream(dev).cuda_stream,
                   side=K10.Side(cfg, kcfg, ks, K10.knob_table(kn, ckn, 8)))
    assert K10.ctrler_chunk.launches == before


@pytest.mark.parametrize("b,misaligned", [(1, True), (3, False), (131, True),
                                          (133, False)])
def test_ctrler_kernel_staging_edges(dev, b, misaligned):
    """K10's staging at its edges: ragged batches (a block a cluster) and
    inputs one element off their alignment, K10-metrics at ten gids (byte
    rows of 10 and 50 bytes), every leaf after each of 24 ticks from tick
    40 against the plain version on the same inputs."""
    cfg = config.SimConfig(n_nodes=5, metrics=True, **CTRLER_BASE)
    kcfg = ctrler.CtrlerConfig(n_gids=10, p_move=0.2)
    keys = engine.cluster_keys(11, b, dev)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = ctrler._advance_ctrler(cfg, kcfg, ctrler.init_ctrler_cluster(
        cfg, kcfg, keys, kn), keys, kn, ckn, 40)
    for t in range(24):
        pre = ks.raft
        s = K6.tick_chunk(cfg, pre, keys, kn, 1)
        want = ctrler._ctrler_service_tick(cfg, kcfg, ks, pre.alive,
                                           pre.base, s, keys, kn, ckn)
        ks_in, s_in = (misalign(ks), misalign(s)) if misaligned else (
            ks, s)
        assert not misaligned or ks_in.hist.data_ptr() % 16 == 4
        got = K10.ctrler_tick(cfg, kcfg, ks_in, ks_in.raft.alive,
                              ks_in.raft.base, s_in, keys, kn, ckn)
        d = ctrler.first_divergence(t, ctrler.ctrler_state_to_numpy(want),
                                    ctrler.ctrler_state_to_numpy(got))
        assert d is None, d
        ks = want
    assert ks.clerk_acked.sum() > 0


# ---- K11, the shardkv service tick, and the shardkv path
SHARDKV_BASE = dict(p_client_cmd=0.0, compact_at_commit=False, log_cap=64,
                    compact_every=16, loss_prob=0.1, p_crash=0.01,
                    p_restart=0.2, max_dead=1)


@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {}, False, True),
    (3, {"bug_skip_freeze": True}, True, False),
    (5, {"bug_drop_dup_table": True}, False, True),
    (5, {"bug_serve_frozen": True}, True, True),
    (3, {"p_put": 0.3, "requery_wrong_group": True}, True, False),
    (5, {"open_rate": 0.3, "open_queue_cap": 4, "zipf_a": 1.6}, True, True),
    # five groups of seven, 32 clients: a warp's every lane a clerk
    (7, {"n_groups": 5, "n_clients": 32, "p_put": 0.2}, True, False),
])
def test_shardkv_kernel_equals_plain_every_tick(dev, n_nodes, kw, metrics_on,
                                                partitionable):
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on,
                           **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=20, **kw)
    b = 1100  # past a whole number of blocks: the grid's ragged edge
    g = kcfg.n_groups
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
        gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
        st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        for t in range(60):
            pre = st.rafts
            s = shardkv._unflat(K6.tick_chunk(cfg, shardkv._flat(pre), gkeys,
                                              kn, 1), b)
            want = shardkv._shardkv_service_tick(cfg, kcfg, st, pre.alive,
                                                 pre.base, s, keys, kn, skn)
            before = (K11.shardkv_tick.launches,
                      K11.shardkv_tick.metrics_launches)
            got = K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base, s,
                                   keys, kn, skn)
            assert (K11.shardkv_tick.launches,
                    K11.shardkv_tick.metrics_launches) == (
                before[0] + 1, before[1] + int(metrics_on))
            d = shardkv.first_divergence(
                t, shardkv.shardkv_state_to_numpy(want),
                shardkv.shardkv_state_to_numpy(got))
            assert d is None, d
            st = got
    assert st.clerk_acked.sum() > 0
    if kw.get("bug_skip_freeze"):
        # no shard freezes, so no pull is answered: the walker diverges
        assert (st.violations & shardkv.VIOLATION_SHARD_DIVERGE).any()
    else:
        assert st.installs_done.sum() > 0


def test_shardkv_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig()
    keys = engine.cluster_keys(1, 8, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    s = st.rafts
    pre = (s.alive, s.base)
    before = K11.shardkv_tick.launches
    with pytest.raises(ValueError, match="clerk_shard"):
        K11.shardkv_tick(cfg, kcfg,
                         st._replace(clerk_shard=st.clerk_shard.cpu()),
                         *pre, s, keys, kn, skn)
    with pytest.raises(ValueError, match="n_clients"):
        K11.shardkv_tick(cfg, kcfg.replace(n_clients=40), st, *pre, s, keys,
                         kn, skn)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="shardkv_launch"):
        K11._launch(cfg, kcfg, st, *pre, s, keys,
                    K11.knob_table(kn, skn, 8), K11._lib("shardkv_metrics"),
                    torch.cuda.current_stream(dev).cuda_stream)
    assert K11.shardkv_tick.launches == before


def _shardkv_launches():
    return (K6.tick_chunk.launches, K11.shardkv_tick.launches,
            K11.shardkv_chunk.launches, K11.shardkv_chunk.metrics_launches)


@pytest.mark.parametrize("metrics_on", [False, True])
def test_shardkv_fuzz_on_the_card_equals_the_cpu(dev, metrics_on):
    """A 512-tick run on the card is two K6-shardkv launches (no K6 or
    K11 launch) and reports what the CPU's reports."""
    cfg = config.SimConfig(n_nodes=5, metrics=metrics_on, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=20, bug_serve_frozen=True)
    before = _shardkv_launches()
    got = shardkv.shardkv_fuzz(cfg, kcfg, 5, 32, 512, device=dev)
    assert tuple(x - y for x, y in zip(_shardkv_launches(), before)) == (
        0, 0, 2, 2 * metrics_on)
    want = shardkv.shardkv_fuzz(cfg, kcfg, 5, 32, 512, device="cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or (a == b).all(), f
    assert want.n_violating > 0 and want.installs.sum() > 0


# ---- K11's controller branches and the controller modes' path
@pytest.mark.parametrize("n_nodes,kw,metrics_on,partitionable", [
    (5, {"live_ctrler": True}, False, True),
    (3, {"live_ctrler": True, "bug_stale_ctrler_read": True,
         "p_phantom": 0.5, "p_put": 0.2}, True, False),
    (5, {"computed_ctrler": True, "requery_wrong_group": True}, True, True),
    (3, {"computed_ctrler": True, "bug_rotate_tiebreak": True}, False,
     False),
    (7, {"computed_ctrler": True, "n_groups": 5, "n_clients": 32,
         "bug_serve_frozen": True}, True, True),
])
def test_shardkv_ctrl_kernel_equals_plain_every_tick(dev, n_nodes, kw,
                                                     metrics_on,
                                                     partitionable):
    """K11 in a controller mode against the plain service tick on the
    card, every leaf after every tick, the controller cluster ticking on
    K6 beside the groups."""
    cfg = config.SimConfig(n_nodes=n_nodes, metrics=metrics_on,
                           **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=16, **kw)
    b = 301  # past a whole number of blocks: the grid's ragged edge
    g = kcfg.n_groups
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, dev)
        kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
        gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
        ckeys = shardkv.ctrl_keys(keys)
        st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        for t in range(60):
            pre = st.rafts
            s = shardkv._unflat(K6.tick_chunk(cfg, shardkv._flat(pre), gkeys,
                                              kn, 1), b)
            ctrl = K6.tick_chunk(cfg, st.ctrl, ckeys, kn, 1)
            want = shardkv._shardkv_service_tick(cfg, kcfg, st, pre.alive,
                                                 pre.base, s, keys, kn, skn,
                                                 ctrl)
            before = K11.shardkv_tick.launches
            got = K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base, s,
                                   keys, kn, skn, ctrl=ctrl)
            assert K11.shardkv_tick.launches == before + 1
            d = shardkv.first_divergence(
                t, shardkv.shardkv_state_to_numpy(want),
                shardkv.shardkv_state_to_numpy(got))
            assert d is None, d
            st = got
    assert st.clerk_acked.sum() > 0 and (st.win_var[:, 1] >= 0).any()
    # five groups reconfigure slower: their installs come after the run
    assert kcfg.n_groups > 3 or st.installs_done.sum() > 0
    if kw.get("bug_stale_ctrler_read") or kw.get("bug_rotate_tiebreak"):
        assert (st.violations & shardkv.VIOLATION_SHARD_CTRL_STALE).any()


@pytest.mark.parametrize("mode,b,misaligned", [
    ("schedule", 1, True), ("schedule", 67, False), ("live", 3, True),
    ("live", 66, False), ("computed", 5, True), ("computed", 130, False)])
def test_shardkv_kernel_staging_edges(dev, mode, b, misaligned):
    """K11's staging at its edges, each mode's instance: ragged batches (a
    block a deployment) and inputs one element off their alignment,
    K11-metrics at n = 3, every leaf after each of 24 ticks from tick 40
    against the plain version on the same inputs."""
    cfg = config.SimConfig(n_nodes=3, metrics=True, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=8,
                                 live_ctrler=mode == "live",
                                 computed_ctrler=mode == "computed")
    g = kcfg.n_groups
    keys = engine.cluster_keys(13, b, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
    ckeys = shardkv.ctrl_keys(keys)
    st = shardkv._advance_shardkv(cfg, kcfg, shardkv.init_shardkv_cluster(
        cfg, kcfg, keys, kn, skn), keys, kn, skn, 40)
    for t in range(24):
        pre = st.rafts
        s = shardkv._unflat(K6.tick_chunk(cfg, shardkv._flat(pre), gkeys,
                                          kn, 1), b)
        ctrl = (K6.tick_chunk(cfg, st.ctrl, ckeys, kn, 1)
                if mode != "schedule" else None)
        want = shardkv._shardkv_service_tick(cfg, kcfg, st, pre.alive,
                                             pre.base, s, keys, kn, skn, ctrl)
        args = (st, pre.alive, pre.base, s, ctrl)
        if misaligned:
            args = tuple(None if x is None else misalign(x) for x in args)
            assert args[0].last_seq.data_ptr() % 16 == 4
        got = K11.shardkv_tick(cfg, kcfg, *args[:4], keys, kn, skn,
                               ctrl=args[4])
        d = shardkv.first_divergence(t, shardkv.shardkv_state_to_numpy(want),
                                     shardkv.shardkv_state_to_numpy(got))
        assert d is None, d
        st = want
    assert st.clerk_acked.sum() > 0


@pytest.mark.parametrize("kw", [{"live_ctrler": True},
                                {"computed_ctrler": True}])
def test_shardkv_ctrl_kernel_walker_stall(dev, kw):
    """A planted slid controller shadow: K11 raises the sticky walker
    stall with the plain version, every leaf equal for 12 ticks."""
    cfg = config.SimConfig(n_nodes=5, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=16, **kw)
    keys = engine.cluster_keys(3, 64, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    c = st.ctrl
    st = st._replace(ctrl=c._replace(
        shadow_len=torch.full_like(c.shadow_len, cfg.log_cap + 5),
        shadow_base=torch.full_like(c.shadow_base, 5)))
    for t in range(12):
        want = shardkv.shardkv_step(cfg, kcfg, st, keys, kn, skn,
                                    tick="eager")
        got = shardkv.shardkv_step(cfg, kcfg, st, keys, kn, skn)
        d = shardkv.first_divergence(t, shardkv.shardkv_state_to_numpy(want),
                                     shardkv.shardkv_state_to_numpy(got))
        assert d is None, d
        st = got
    assert st.ctrl_w_stalled.all() and (st.ctrl_w_frontier == 0).all()


def test_shardkv_ctrl_kernel_refuses_what_it_does_not_take(dev):
    cfg = config.SimConfig(n_nodes=5, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(live_ctrler=True)
    keys = engine.cluster_keys(1, 8, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    s = st.rafts
    before = K11.shardkv_tick.launches
    # a controller mode needs the stepped controller cluster
    with pytest.raises(ValueError, match="ctrl="):
        K11.shardkv_tick(cfg, kcfg, st, s.alive, s.base, s, keys, kn, skn)
    with pytest.raises(ValueError, match="win_var"):
        K11.shardkv_tick(cfg, kcfg, st._replace(win_var=st.win_var.cpu()),
                         s.alive, s.base, s, keys, kn, skn, ctrl=st.ctrl)
    assert K11.shardkv_tick.launches == before


@pytest.mark.parametrize("kw", [
    {"live_ctrler": True, "bug_stale_ctrler_read": True, "p_phantom": 0.5},
    {"computed_ctrler": True, "bug_rotate_tiebreak": True}])
def test_shardkv_ctrl_fuzz_on_the_card_equals_the_cpu(dev, kw):
    """A controller mode's 512-tick run on the card (two K6-shardkv
    launches, no K6 or K11 launch) reports what the CPU's reports."""
    cfg = config.SimConfig(n_nodes=5, metrics=True, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=16, **kw)
    before = _shardkv_launches()
    got = shardkv.shardkv_fuzz(cfg, kcfg, 5, 32, 512, device=dev)
    assert tuple(x - y for x, y in zip(_shardkv_launches(), before)) == (
        0, 0, 2, 2)
    want = shardkv.shardkv_fuzz(cfg, kcfg, 5, 32, 512, device="cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None and b is None) or (a == b).all(), f
    assert want.n_violating > 0 and (want.ann_resolved >= 2).any()


# ---- K6-shardkv, the shardkv tick inside K6's chunk
K6S_MODES = {"schedule": {}, "live": {"live_ctrler": True},
             "computed": {"computed_ctrler": True}}


def _k6s_vs_plain(cfg, kcfg, st, keys, kn, skn, launches):
    """K6-shardkv against its plain version after every launch of
    ``launches`` ticks (a launch each, counted); the last state."""
    for t, m in enumerate(launches):
        before = K11.shardkv_chunk.launches
        got = K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, m)
        assert K11.shardkv_chunk.launches == before + 1
        want = K11.shardkv_chunk_plain(cfg, kcfg, st, keys, kn, skn, m)
        d = shardkv.first_divergence(t, shardkv.shardkv_state_to_numpy(want),
                                     shardkv.shardkv_state_to_numpy(got))
        assert d is None, d
        st = want
    return st


@pytest.mark.parametrize("metrics_on", [False, True])
@pytest.mark.parametrize("mode", list(K6S_MODES))
def test_k6_shardkv_kernel_equals_plain_every_launch(dev, mode, metrics_on):
    """The mode's row cases as [B] knob rows, 37 deployments warmed 40
    ticks on K6-shardkv, then launches of 16, 1 and 7 ticks held to the
    plain route on every leaf."""
    from chip_smoke import shardkv_knob_rows

    cfg = config.SimConfig(n_nodes=5, metrics=metrics_on, **SHARDKV_BASE)
    kcfg = shardkv.ShardKvConfig(cfg_interval=12, **K6S_MODES[mode])
    b = 37
    with prng.layout(not metrics_on):
        keys = engine.cluster_keys(5, b, dev)
        kn, skn = cfg.knobs(dev), shardkv_knob_rows(kcfg, b).to(dev)
        st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        st = K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, 40)
        st = _k6s_vs_plain(cfg, kcfg, st, keys, kn, skn, (16, 1, 7))
    assert st.clerk_acked.sum() > 0 and st.installs_done.sum() > 0


# shapes at K11's limits (kernels/shardkv.py check_shape) that its region
# of shared memory holds: eight groups of sixteen nodes at cap 256 with 64
# configs (32 in the computed mode, beside its map history), and 32 shards
# with 32 clients; name -> (raft config, shardkv config, metrics)
K6S_LIMITS = {
    "live_g8_n16_cap256_configs64": (
        dict(n_nodes=16, log_cap=256, compact_every=64),
        dict(live_ctrler=True, n_groups=8, n_configs=64), True),
    "computed_g8_n16_cap256": (
        dict(n_nodes=16, log_cap=256, compact_every=64),
        dict(computed_ctrler=True, n_groups=8, n_configs=32), False),
    "schedule_shards32_clients32_configs64": (
        dict(n_nodes=3, log_cap=16, compact_every=4),
        dict(n_groups=2, n_shards=32, n_clients=32, n_configs=64), False),
}


@pytest.mark.parametrize("case", list(K6S_LIMITS))
def test_k6_shardkv_takes_every_shape_k11_takes(dev, case):
    """K6-shardkv at shapes K11 takes at its limits (K11 lays each out on
    the card first): every leaf equals the plain route's after each launch;
    with sixteen nodes at cap 256 the clusters' blocks go to device memory,
    and eight groups with the controller take five warps."""
    raft, kw, metrics_on = K6S_LIMITS[case]
    cfg = config.SimConfig(p_client_cmd=0.0, compact_at_commit=False,
                           metrics=metrics_on, **raft)
    kcfg = shardkv.ShardKvConfig(cfg_interval=8, **kw)
    K11.check_shape(cfg, kcfg)
    b = 3
    keys = engine.cluster_keys(9, b, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    st = shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    ctrl = st.ctrl if kcfg.live_ctrler or kcfg.computed_ctrler else None
    K11.grid(cfg, kcfg, st, st.rafts.alive, st.rafts.base, st.rafts, keys,
             K11.knob_table(kn, skn, b), K11._lib(K11.variant(metrics_on)),
             ctrl)
    tables = K11.chunk_tables(cfg, kcfg, kn, skn, b)
    grid = K11.chunk_grid(cfg, kcfg, st, keys, 4, tables,
                          K11.chunk_lib(K11.chunk_variant(metrics_on)))
    if cfg.n_nodes == 16:
        assert not grid["blocks_in_shared"]
    if kcfg.n_groups == 8:
        assert grid["threads_a_block"] == 160
    st = K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, 30)
    st = _k6s_vs_plain(cfg, kcfg, st, keys, kn, skn, (4, 1, 3))
    assert (st.rafts.commit > 0).any()


@pytest.mark.parametrize("mode", list(K6S_MODES))
def test_k6_shardkv_flagship_equals_the_eager_route(dev, mode):
    """The shardkv flagships (shardkv-fuzz --storm, with the mode's flag,
    1024 deployments x 512 ticks): K6-shardkv's report equals the eager
    route's (the eager raft ticks, then the plain service tick) at the
    whole depth, which chip_smoke.py checks at 64 ticks to hold its
    time."""
    from functools import partial

    from chip_smoke import _shardkv_cli_cfg

    cfg, kcfg = _shardkv_cli_cfg(False, mode)
    reps = {}
    advance = shardkv._advance_shardkv
    for route in ("kernel", "eager"):
        shardkv._advance_shardkv = partial(advance, tick=route)
        try:
            reps[route] = shardkv.shardkv_fuzz(cfg, kcfg, 12345, 1024, 512,
                                               device=dev)
        finally:
            shardkv._advance_shardkv = advance
    for f in reps["eager"]._fields:
        a, b = getattr(reps["eager"], f), getattr(reps["kernel"], f)
        assert (a is None and b is None) or (a == b).all(), f
    assert reps["kernel"].installs.sum() > 0
