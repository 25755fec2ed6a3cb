"""The port's metrics plane against the live JAX package, on the CPU: the
plain folds (K4's plain versions) and the host helpers on random and
planted inputs; every ClusterState leaf, the metric leaves included, at
every tick with metrics on (16 clusters x 200 ticks, five storm profiles
and one planted bug); metrics-on trajectories equal to metrics-off on
every non-metric leaf; the plane's invariants; the metrics-on packed carry
(3600 B a lane, leaf by leaf against the reference). Tolerance: exact
equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import Pair, configs, single_thread, threefry_layout
from madraft_tpu.tpusim import config as jcfg_mod
from madraft_tpu.tpusim import metrics as jm
from madraft_tpu.tpusim import state as jst
from madraft_tpu_torch.kernels import harvest as K7
from madraft_tpu_torch.kernels import metrics as K4
from madraft_tpu_torch.tpusim import config as pcfg_mod
from madraft_tpu_torch.tpusim import engine, state
from madraft_tpu_torch.tpusim import metrics as pm

N_CLUSTERS, N_TICKS = 16, 200
PROFILES = [("storm", ""), ("fig8", ""), ("durability", ""), ("limp", ""),
            ("gray_storm", ""), ("durability", "ack_before_fsync")]


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def _random_inputs(b, m, p, seed):
    """Fold inputs of a plausible tick: latencies 0..300, a sparse mask,
    phases that sum to the latency, registers from earlier ticks."""
    rng = np.random.default_rng(seed)
    lat = rng.integers(0, 300, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.1
    cut = np.sort(rng.integers(0, 300, (b, p - 1, m)), axis=1)
    edges = np.concatenate([np.zeros((b, 1, m), np.int64), cut,
                            np.full((b, 1, m), 300)], axis=1)
    phases = np.minimum(np.diff(edges, axis=1), lat[:, None, :]).astype(np.int32)
    hb = pcfg_mod.HIST_BUCKETS
    ints = lambda *s: rng.integers(0, 1000, s).astype(np.int32)  # noqa: E731
    worst = (ints(b, 1), ints(b, p), ints(b, 1) - 1, ints(b, 1) - 1,
             np.where(rng.random((b, 1)) < 0.5, 0, ints(b, 1)).astype(np.int32))
    arrays = (lat, mask, phases, ints(b, m), ints(b, m), ints(b, m),
              ints(b, hb), ints(b, p, hb), ints(b, p), ints(b, 1))
    return tuple(torch.from_numpy(x) for x in arrays) + (
        tuple(torch.from_numpy(x) for x in worst),)


def _jax_folds(args, c):
    """The reference's three folds on cluster c of a port argument tuple."""
    (lat, mask, ph, keys, cl, subs, lh, phh, pt, lt, worst) = (
        tuple(jnp.asarray(y[c].numpy()) for y in x) if isinstance(x, tuple)
        else jnp.asarray(x[c].numpy()) for x in args)
    h = jm.fold_latencies(lh, lat, mask)
    phh, pt, lt = jm.fold_phases(phh, pt, lt, ph, lat, mask)
    w = jm.update_worst(worst, lat, mask, ph, keys, cl, subs)
    return [np.asarray(x) for x in (h, phh, pt, lt, *w)]


@pytest.mark.parametrize("kind", ["random", "planted"])
def test_plain_folds_equal_the_reference(kind):
    b, m, p = 16, 64, 4
    args = (_random_inputs(b, m, p, 3) if kind == "random"
            else pm.planted_fold_inputs(b, m, p, 3))
    got = pm.latency_fold_plain(*args)
    flat = [*got[:4], *got[4]]
    for c in range(b):
        for a, w in zip(flat, _jax_folds(args, c)):
            assert a[c].numpy().dtype == w.dtype
            assert np.array_equal(a[c].numpy(), w), c
    # K4's wrapper takes the plain version on CPU tensors, and counts nothing
    before = K4.latency_fold.launches
    again = K4.latency_fold(*args)
    assert K4.latency_fold.launches == before
    for a, w in zip(flat, [*again[:4], *again[4]]):
        assert torch.equal(a, w)


def test_bucket_edges_and_host_helpers_equal_the_reference():
    assert pm.BUCKET_EDGES == jm.BUCKET_EDGES
    edge = [0, 1, 2, 3, -1] + [x for k in range(2, 18)
                               for x in (2**k - 1, 2**k)] + [2**31 - 1]
    lat = np.asarray(edge, np.int32)
    want = np.asarray(jm.fold_latencies(
        jnp.zeros(16, jnp.int32), jnp.asarray(lat), jnp.ones(len(edge), bool)))
    got = pm.fold_latencies(torch.zeros(16, dtype=torch.int32),
                            torch.from_numpy(lat), torch.ones(len(edge), dtype=bool))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pm.bucket_of(torch.from_numpy(lat)).numpy(),
                          jm.host_bucket(lat))
    assert np.array_equal(pm.host_bucket(lat), jm.host_bucket(lat))
    for k in range(pcfg_mod.HIST_BUCKETS):
        assert pm.bucket_bounds(k) == jm.bucket_bounds(k)
    rng = np.random.default_rng(5)
    hists = [np.zeros(16, np.int64), rng.integers(0, 50, 16),
             np.eye(16, dtype=np.int64)[15] * 3, np.eye(16, dtype=np.int64)[0]]
    for h in hists:
        for q in (0.0, 0.5, 0.99, 1.0):
            assert pm.quantile_from_hist(h, q) == jm.quantile_from_hist(h, q)
        assert pm.latency_summary(h, 7) == jm.latency_summary(h, 7)
        assert pm.render_histogram(h) == jm.render_histogram(h)
    ph = rng.integers(0, 9, (4, 16))
    assert pm.phases_summary(ph, [1, 2, 3, 4]) == jm.phases_summary(ph, [1, 2, 3, 4])
    ev = rng.integers(0, 99, len(pcfg_mod.METRIC_EVENTS))
    assert pm.event_summary(ev) == jm.event_summary(ev)
    regs = (rng.integers(0, 99, (6, 1)), rng.integers(0, 9, (6, 4)),
            rng.integers(-1, 9, (6, 1)), rng.integers(-1, 9, (6, 1)),
            np.asarray([[0], [3], [5], [0], [7], [2]]))
    regs[0][4] = regs[0][2]  # a tie: the smaller cluster id wins
    ids = np.asarray([9, 4, 7, 1, 2, 8])
    for kw in ({}, {"ids": ids}, {"ids": ids, "into": {
            "latency_ticks": 50, "submit_tick": 1, "key": -1, "client": -1,
            "phases": {}, "cluster_id": 3}}):
        assert pm.merge_worst_registers(*regs, **kw) == \
            jm.merge_worst_registers(*regs, **kw)
    for c in range(6):
        assert pm.worst_op_dict(*(r[c] for r in regs)) == \
            jm.worst_op_dict(*(r[c] for r in regs))


def test_metrics_constants_equal_the_reference():
    for name in ("HIST_BUCKETS", "LATENCY_PHASES", "SHARDKV_PHASES",
                 "METRIC_EVENTS"):
        assert getattr(pcfg_mod, name) == getattr(jcfg_mod, name), name
    for n in range(7):
        assert pcfg_mod.phase_names(n) == jcfg_mod.phase_names(n)
    for n in (3, 5, 7):
        a = pcfg_mod.SimConfig(n_nodes=n, metrics=True)
        b = jcfg_mod.SimConfig(n_nodes=n, metrics=True)
        assert pcfg_mod.metrics_dims(a) == jcfg_mod.metrics_dims(b)


@pytest.mark.parametrize("profile,bug", PROFILES)
def test_step_with_metrics_matches_reference_every_tick(profile, bug):
    with threefry_layout(True):
        pair = Pair(*configs(profile, bug, metrics=True), seed=11,
                    n_clusters=N_CLUSTERS)
        d = pair.run(N_TICKS)
    assert d is None, f"first divergence: {d}"
    assert int(np.asarray(pair.js.lat_hist).sum()) > 0  # commits were folded


def _run(cfg, ticks, keep_every_tick=False):
    keys = engine.cluster_keys(4, N_CLUSTERS, "cpu")
    kn = cfg.knobs("cpu")
    s = state.init_cluster(cfg, keys, kn)
    seen = []
    for _ in range(ticks):
        s = engine._advance(cfg, s, keys, kn, 1)
        if keep_every_tick:
            seen.append(s)
    return s, seen


@pytest.mark.parametrize("profile", ["storm", "gray_storm"])
def test_metrics_on_leaves_every_other_leaf_as_metrics_off(profile):
    with threefry_layout(True):
        on_cfg = pcfg_mod.storm_profiles()[profile][0].replace(metrics=True)
        _, on = _run(on_cfg, N_TICKS, True)
        _, off = _run(on_cfg.replace(metrics=False), N_TICKS, True)
    k = state.METRIC_LEAF0
    for t, (a, b) in enumerate(zip(on, off)):
        for f, x, y in zip(state.ClusterState._fields[:k], a[:k], b[:k]):
            assert torch.equal(x, y), (t, f)
        assert all(x.numel() == 0 for x in b[k:])
    assert on[-1].lat_hist.sum() > 0


def test_metrics_invariants_hold():
    # hist mass == every phase row's mass == the acked (recorded) ops;
    # sum(phase_ticks) == lat_ticks; delivery counters sum to msg_count;
    # the worst op's phases sum to its latency
    with threefry_layout(True):
        cfg = pcfg_mod.storm_profiles()["durability"][0].replace(metrics=True)
        s, seen = _run(cfg, N_TICKS, True)
    acked = sum(int((x.shadow_sub > 0).sum()) for x in seen)
    assert acked == int(s.lat_hist.sum()) > 0
    mass = s.lat_hist.sum(-1)
    assert (s.phase_hist.sum(-1) == mass[:, None]).all()
    assert (s.phase_ticks.sum(-1) == s.lat_ticks[:, 0]).all()
    assert (s.ev_counts[:, 4:9].sum(-1) == s.msg_count).all()
    held = s.worst_sub[:, 0] > 0
    assert (s.worst_phases.sum(-1)[held] == s.worst_lat[held, 0]).all()
    assert held.any()
    names = pcfg_mod.METRIC_EVENTS
    assert names[4:9] == ("rv_req_delivered", "rv_rsp_delivered",
                          "ae_req_delivered", "ae_rsp_delivered",
                          "snap_delivered")


@functools.lru_cache(maxsize=None)
def _jax_pack(cfg):
    return jax.jit(jax.vmap(functools.partial(jst.pack_state, cfg)))


@pytest.mark.parametrize("kind", ["storm", "planted"])
@pytest.mark.parametrize("n", [3, 5, 7])
def test_metrics_on_packed_carry_equals_the_reference(n, kind):
    with threefry_layout(True):
        cfg = pcfg_mod.storm_profiles()["storm"][0].replace(n_nodes=n,
                                                            metrics=True)
        jcfg = jcfg_mod.storm_profiles()["storm"][0].replace(n_nodes=n,
                                                             metrics=True)
        s, _ = _run(cfg, 80)
    h = state.state_to_numpy(s)
    if kind == "planted":
        h = state.planted_edge_state(cfg, h, n)
    pp = state.pack_state(cfg, state.state_from_numpy(h))
    jp = _jax_pack(jcfg)(jst.ClusterState(*(jnp.asarray(h[f])
                                           for f in jst.ClusterState._fields)))
    got = state.packed_state_to_numpy(pp)
    for f in jst.PackedClusterState._fields:
        want = np.asarray(getattr(jp, f))
        assert got[f].dtype == want.dtype and got[f].shape == want.shape, f
        assert np.array_equal(got[f], want), f
    back = state.state_to_numpy(state.unpack_state(cfg, pp))
    assert state.first_divergence(0, h, back) is None


def test_metrics_on_packed_carry_is_3600_bytes_a_lane():
    cfg = pcfg_mod.storm_profiles()["durability"][0].replace(
        bug="ack_before_fsync", metrics=True)
    jcfg = jcfg_mod.storm_profiles()["durability"][0].replace(
        bug="ack_before_fsync", metrics=True)
    p = state.pack_state(cfg, state.init_cluster(
        cfg, engine.cluster_keys(1, 4, "cpu")))
    want = jst.abstract_bytes(jax.eval_shape(
        lambda k: jst.pack_state(jcfg, jst.init_cluster(jcfg, k)),
        jax.random.PRNGKey(0)))
    assert state.tree_bytes(p) / 4 == want == 3600
    # the layout verdict does not depend on the plane, on either side
    for ticks in (10, 5000):
        for m in (True, False):
            assert (state.packed_layout_reason(cfg.replace(metrics=m),
                                               cfg.knobs(), ticks)
                    == jst.packed_layout_reason(jcfg.replace(metrics=m),
                                                jcfg.knobs(), ticks))


def test_fresh_lanes_start_with_zero_metric_rows():
    cfg = pcfg_mod.storm_profiles()["storm"][0].replace(metrics=True)
    with threefry_layout(True):
        s, _ = _run(cfg, 60)
    keys = engine.cluster_keys(99, N_CLUSTERS, "cpu")
    retired = torch.arange(N_CLUSTERS) % 2 == 0
    out = K7._scatter_fresh(retired, state.init_cluster(cfg, keys), s)
    k = state.METRIC_LEAF0
    for f, x, old in zip(state.ClusterState._fields[k:], out[k:], s[k:]):
        fill = -1 if f in ("worst_key", "worst_client") else 0
        assert (x[retired] == fill).all(), f
        assert torch.equal(x[~retired], old[~retired]), f
    assert s.lat_hist[retired].sum() > 0
