"""The kv layer's drivers and helpers against the live JAX package, on the
CPU: ``kv_fuzz`` reports field by field (metrics on, a planted bug), the
replay of a violating cluster (every leaf of its final state), the sweep
with per-cluster raft and kv knob rows (a uniform-valued sweep equals the
uniform run; a bug planted in half the batch violates only there), the
knob validators' and ``KvConfig``'s errors in the reference's words,
``prng.bernoulli`` under both counter layouts, ``config.zipf_map`` over
every draw of the Zipf grid, and the B5' folds (``fold_latencies_by``,
``clerk_phase_matrix``) on planted inputs. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import config as jconfig
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import kv as jkv
from madraft_tpu.tpusim import metrics as jmetrics
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.tpusim import config as pconfig
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import kv as pkv
from madraft_tpu_torch.tpusim import metrics as pmetrics
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg
from test_torch_kv import BASE, jax_flat

N, TICKS = 16, 100


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def _cfgs(**kw):
    return JaxCfg(**BASE, **kw), PortCfg(**BASE, **kw)


def _reports_equal(want, got):
    for f in got._fields:
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        assert np.array_equal(np.asarray(a), b), f


def test_kv_fuzz_report_equals_the_reference_with_metrics():
    jcfg, pcfg = _cfgs(metrics=True)
    kw = dict(bug_stale_read=True, p_get=0.5, p_put=0.2)
    want = jkv.kv_fuzz(jcfg, jkv.KvConfig(**kw), 7, N, TICKS)
    got = pkv.kv_fuzz(pcfg, pkv.KvConfig(**kw), 7, N, TICKS, device="cpu")
    _reports_equal(want, got)
    assert got.n_violating > 0 and got.key_hist.sum() > 0


def test_kv_replay_of_a_violating_cluster_equals_the_reference():
    jcfg, pcfg = _cfgs()
    kw = dict(bug_skip_dedup=True)
    rep = pkv.kv_fuzz(pcfg, pkv.KvConfig(**kw), 7, N, TICKS, device="cpu")
    bad = int(rep.violating_clusters()[0])
    want = jkv.kv_replay_cluster(jcfg, jkv.KvConfig(**kw), 7, bad, TICKS)
    got = pkv.kv_replay_cluster(pcfg, pkv.KvConfig(**kw), 7, bad, TICKS,
                                device="cpu")
    flat = {k: v[None] for k, v in jax_flat(want).items()}
    assert pkv.first_divergence(TICKS, flat,
                                pkv.kv_state_to_numpy(got)) is None
    assert int(got.raft.violations[0]) == int(rep.violations[bad]) != 0
    assert int(got.raft.first_violation_tick[0]) == int(
        rep.first_violation_tick[bad])


def test_kv_sweep_per_cluster_knobs_and_bugs():
    jcfg, pcfg = _cfgs()
    pk = pkv.KvConfig()
    # a uniform-valued sweep equals the uniform run
    fn = pkv.make_kv_sweep_fn(pcfg, pcfg.knobs(), pk.knobs(), pk, N, TICKS,
                              device="cpu")
    _reports_equal(pkv.kv_fuzz(pcfg, pk, 7, N, TICKS, device="cpu"),
                   pkv.kv_report(fn(7)))
    # the bug axis as data: stale-read serving in the first half only,
    # against the reference's sweep
    half = np.arange(N) < N // 2
    jk = jkv.KvConfig()
    jkkn = jk.replace(p_get=0.5).knobs()._replace(
        bug_stale_read=jnp.asarray(half))
    want = jkv.kv_report(jax.block_until_ready(jkv.make_kv_sweep_fn(
        jcfg, jcfg.knobs(), jkkn, jk, N, TICKS)(jnp.uint32(7))))
    pkkn = pk.replace(p_get=0.5).knobs()._replace(
        bug_stale_read=torch.from_numpy(half))
    got = pkv.kv_report(pkv.make_kv_sweep_fn(
        pcfg, pcfg.knobs(), pkkn, pk, N, TICKS, device="cpu")(7))
    _reports_equal(want, got)
    viol = got.violations != 0
    assert viol[half].any() and not viol[~half].any()
    assert (got.violations[viol] & pkv.VIOLATION_STALE_READ).all()


def _error(fn):
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("case", [
    "p_get_plus_p_put", "prob_range", "queue_cap", "zipf_a", "bug_dtype",
    "p_client_cmd", "compact_at_commit"])
def test_kv_sweep_validators_raise_the_reference_errors(case):
    jcfg, pcfg = _cfgs()
    jk, pk = jkv.KvConfig(), pkv.KvConfig()
    jkn, pkn = jcfg.knobs(), pcfg.knobs()
    jkk, pkk = jk.knobs(), pk.knobs()
    if case == "p_get_plus_p_put":
        jkk = jkk._replace(p_get=jnp.float32(0.8), p_put=jnp.float32(0.5))
        pkk = pkk._replace(p_get=torch.tensor(0.8), p_put=torch.tensor(0.5))
    elif case == "prob_range":
        jkk = jkk._replace(p_retry=jnp.float32(1.5))
        pkk = pkk._replace(p_retry=torch.tensor(1.5))
    elif case == "queue_cap":
        jkk = jkk._replace(open_queue_cap=jnp.int32(9))
        pkk = pkk._replace(open_queue_cap=torch.tensor(9, dtype=torch.int32))
    elif case == "zipf_a":
        jkk = jkk._replace(zipf_a=jnp.float32(0.5))
        pkk = pkk._replace(zipf_a=torch.tensor(0.5))
    elif case == "bug_dtype":
        jkk = jkk._replace(bug_stale_read=jnp.zeros(N, jnp.int32))
        pkk = pkk._replace(bug_stale_read=torch.zeros(N, dtype=torch.int32))
    elif case == "p_client_cmd":
        jkn = jkn._replace(p_client_cmd=jnp.float32(0.1))
        pkn = pkn._replace(p_client_cmd=torch.tensor(0.1))
    else:
        jkn = jkn._replace(compact_at_commit=jnp.bool_(True))
        pkn = pkn._replace(compact_at_commit=torch.tensor(True))
    want = _error(lambda: jkv.make_kv_sweep_fn(jcfg, jkn, jkk, jk, N, TICKS))
    got = _error(lambda: pkv.make_kv_sweep_fn(pcfg, pkn, pkk, pk, N, TICKS,
                                              device="cpu"))
    assert got == want


@pytest.mark.parametrize("kw", [
    {"p_get": 0.7, "p_put": 0.4}, {"open_rate": 1.5}, {"open_queue_cap": 9},
    {"zipf_a": 0.9}, {"n_clients": 64, "n_keys": 256}])
def test_kv_config_rejects_what_the_reference_rejects(kw):
    assert _error(lambda: pkv.KvConfig(**kw)) == _error(
        lambda: jkv.KvConfig(**kw))


def test_kv_knobs_and_init_equal_the_reference():
    kw = dict(p_put=0.2, p_follow_hint=0.5, retry_wait=2, open_rate=0.25,
              open_queue_cap=8, zipf_a=3.0, bug_stale_hint=True)
    for a, b in zip(jkv.KvConfig(**kw).knobs(), pkv.KvConfig(**kw).knobs()):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    assert pconfig.OPEN_QUEUE_SLOTS == jconfig.OPEN_QUEUE_SLOTS


@pytest.mark.parametrize("partitionable", [True, False])
def test_bernoulli_equals_jax(partitionable):
    with threefry_layout(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(3), 64)
        pkeys = torch.from_numpy(
            np.asarray(jax.random.key_data(keys)).astype(np.int64))
        p = np.linspace(0, 1, 64).astype(np.float32)
        want = jax.vmap(lambda k, q: jax.random.bernoulli(k, q, (9,)))(
            keys, jnp.asarray(p))
        got = prng.bernoulli(pkeys, torch.from_numpy(p), 9)
        assert np.array_equal(np.asarray(want), got.numpy())
        want0 = jax.vmap(lambda k: jax.random.bernoulli(
            k, jnp.float32(0.3), (5,)))(keys)
        got0 = prng.bernoulli(pkeys, torch.tensor(0.3), 5)
        assert np.array_equal(np.asarray(want0), got0.numpy())


@pytest.mark.parametrize("n_keys", [4, 8, 16])
def test_zipf_map_equals_jax_over_the_grid(n_keys):
    draws = np.arange(n_keys, dtype=np.int32)
    for a in (1.0, 1.5, 2.0, 3.0):
        want = jax.jit(jconfig.zipf_map, static_argnums=1)(
            jnp.asarray(draws), n_keys, jnp.float32(a))
        got = pconfig.zipf_map(torch.from_numpy(draws), n_keys,
                               torch.tensor(a, dtype=torch.float32))
        assert np.array_equal(np.asarray(want), got.numpy()), (n_keys, a)


def _planted_clerks(b: int, m: int, seed: int):
    """Latencies across the bucket edges (negative and past the last edge
    too), a mask, row ids in and out of range, and boundary stamps in
    every order, [b, m]."""
    rng = np.random.default_rng(seed)
    edges = np.asarray([0, 1, 2, 3, -1, -7, 2**16, 2**31 - 1]
                       + [2**k + d for k in range(2, 16) for d in (-1, 0)],
                       np.int32)
    lat = rng.choice(edges, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.6
    idx = rng.integers(-1, 6, (b, m)).astype(np.int32)
    t = rng.integers(0, 50, (b, 1)).astype(np.int32)
    stamps = [rng.integers(0, 60, (b, m)).astype(np.int32) for _ in range(4)]
    is_get = rng.random((b, m)) < 0.5
    return lat, mask, idx, t, stamps, is_get


def test_fold_latencies_by_and_clerk_phase_matrix_equal_jax():
    b, m, rows = 24, 7, 5
    lat, mask, idx, t, (sub, app, cmt, apl), is_get = _planted_clerks(b, m, 4)
    hist = np.random.default_rng(5).integers(
        0, 9, (b, rows, jconfig.HIST_BUCKETS)).astype(np.int32)
    want = jax.vmap(jmetrics.fold_latencies_by)(
        jnp.asarray(hist), jnp.asarray(lat), jnp.asarray(mask),
        jnp.asarray(idx))
    got = pmetrics.fold_latencies_by(*(torch.from_numpy(x) for x in (
        hist, lat, mask, idx)))
    assert np.array_equal(np.asarray(want), got.numpy())
    want = jax.vmap(jmetrics.clerk_phase_matrix)(
        jnp.asarray(t[:, 0]), *(jnp.asarray(x) for x in (
            sub, app, cmt, apl, is_get)))
    got = pmetrics.clerk_phase_matrix(*(torch.from_numpy(x) for x in (
        t, sub, app, cmt, apl, is_get)))
    assert np.array_equal(np.asarray(want), got.numpy())
    # the split telescopes to t - sub
    assert np.array_equal(got.sum(-2).numpy(), t - sub)


def test_kv_cluster_keys_and_device_default_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform runs there")
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkv.kv_fuzz(pcfg, pkv.KvConfig(), 0, 2, 2)
    assert np.array_equal(
        pengine.cluster_keys(7, 4, "cpu").numpy(),
        np.asarray(jax.random.key_data(jengine._cluster_keys(
            jnp.uint32(7), 4))).astype(np.int64))
