"""The shard controller's drivers and helpers against the live JAX
package, on the CPU: ``ctrler_fuzz`` reports field by field (metrics on,
a planted bug), the replay of a violating cluster (every leaf of its
final state), the sweep with per-cluster raft and ctrler knob rows (a
uniform-valued sweep equals the uniform run; the greedy rebalance planted
in half the batch violates only there, as in the reference's sweep),
determinism, the knob validators' and ``CtrlerConfig``'s errors in the
reference's words, the knobs and the initial state. Tolerance: exact
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import ctrler as jct
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.tpusim import ctrler as pct
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg
from test_torch_ctrler import BASE, jax_flat

N, TICKS = 16, 150


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


def test_ctrler_fuzz_report_equals_the_reference_with_metrics():
    jcfg, pcfg = _cfgs(metrics=True)
    kw = dict(bug_full_reshuffle=True)
    want = jct.ctrler_fuzz(jcfg, jct.CtrlerConfig(**kw), 7, N, TICKS)
    got = pct.ctrler_fuzz(pcfg, pct.CtrlerConfig(**kw), 7, N, TICKS,
                          device="cpu")
    _reports_equal(want, got)
    assert got.n_violating > 0 and got.lat_hist.sum() > 0
    assert (got.worst_key[got.worst_sub > 0] == -1).all()


def test_ctrler_replay_of_a_violating_cluster_equals_the_reference():
    jcfg, pcfg = _cfgs()
    kw = dict(bug_greedy_rebalance=True)
    rep = pct.ctrler_fuzz(pcfg, pct.CtrlerConfig(**kw), 7, N, TICKS,
                          device="cpu")
    bad = int(rep.violating_clusters()[0])
    want = jct.ctrler_replay_cluster(jcfg, jct.CtrlerConfig(**kw), 7, bad,
                                     TICKS)
    got = pct.ctrler_replay_cluster(pcfg, pct.CtrlerConfig(**kw), 7, bad,
                                    TICKS, device="cpu")
    flat = {k: v[None] for k, v in jax_flat(want).items()}
    assert pct.first_divergence(TICKS, flat,
                                pct.ctrler_state_to_numpy(got)) is None
    assert int(got.raft.violations[0]) == int(rep.violations[bad]) != 0
    assert int(got.w_cfg_num[0]) == int(rep.configs_created[bad])


def test_ctrler_sweep_per_cluster_knobs_and_bugs():
    jcfg, pcfg = _cfgs()
    pk = pct.CtrlerConfig()
    # a uniform-valued sweep equals the uniform run, and runs deterministic
    fn = pct.make_ctrler_sweep_fn(pcfg, pcfg.knobs(), pk.knobs(), pk, N,
                                  TICKS, device="cpu")
    uni = pct.ctrler_fuzz(pcfg, pk, 7, N, TICKS, device="cpu")
    _reports_equal(uni, pct.ctrler_report(fn(7)))
    _reports_equal(uni, pct.ctrler_report(fn(7)))
    # the bug axis as data: greedy rebalance in the first half only and a
    # per-cluster op mix, against the reference's sweep
    half = np.arange(N) < N // 2
    p_move = np.where(np.arange(N) % 3 == 0, 0.3, 0.1).astype(np.float32)
    jk = jct.CtrlerConfig()
    jckn = jk.knobs()._replace(bug_greedy_rebalance=jnp.asarray(half),
                               p_move=jnp.asarray(p_move))
    want = jct.ctrler_report(jax.block_until_ready(jct.make_ctrler_sweep_fn(
        jcfg, jcfg.knobs(), jckn, jk, N, TICKS)(jnp.uint32(7))))
    pckn = pk.knobs()._replace(bug_greedy_rebalance=torch.from_numpy(half),
                               p_move=torch.from_numpy(p_move))
    got = pct.ctrler_report(pct.make_ctrler_sweep_fn(
        pcfg, pcfg.knobs(), pckn, pk, N, TICKS, device="cpu")(7))
    _reports_equal(want, got)
    viol = got.violations != 0
    assert viol[half].any() and not viol[~half].any()
    assert (got.violations[viol] & pct.VIOLATION_CTRL_BALANCE).all()


def _error(fn):
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("case", [
    "p_query_plus_p_move", "prob_range", "bug_dtype", "p_client_cmd",
    "compact_at_commit"])
def test_ctrler_sweep_validators_raise_the_reference_errors(case):
    jcfg, pcfg = _cfgs()
    jk, pk = jct.CtrlerConfig(), pct.CtrlerConfig()
    jkn, pkn = jcfg.knobs(), pcfg.knobs()
    jkk, pkk = jk.knobs(), pk.knobs()
    if case == "p_query_plus_p_move":
        jkk = jkk._replace(p_query=jnp.float32(0.8), p_move=jnp.float32(0.5))
        pkk = pkk._replace(p_query=torch.tensor(0.8),
                           p_move=torch.tensor(0.5))
    elif case == "prob_range":
        jkk = jkk._replace(p_retry=jnp.float32(1.5))
        pkk = pkk._replace(p_retry=torch.tensor(1.5))
    elif case == "bug_dtype":
        jkk = jkk._replace(bug_full_reshuffle=jnp.zeros(N, jnp.int32))
        pkk = pkk._replace(bug_full_reshuffle=torch.zeros(
            N, dtype=torch.int32))
    elif case == "p_client_cmd":
        jkn = jkn._replace(p_client_cmd=jnp.float32(0.1))
        pkn = pkn._replace(p_client_cmd=torch.tensor(0.1))
    else:
        jkn = jkn._replace(compact_at_commit=jnp.bool_(True))
        pkn = pkn._replace(compact_at_commit=torch.tensor(True))
    want = _error(lambda: jct.make_ctrler_sweep_fn(jcfg, jkn, jkk, jk, N,
                                                   TICKS))
    got = _error(lambda: pct.make_ctrler_sweep_fn(pcfg, pkn, pkk, pk, N,
                                                  TICKS, device="cpu"))
    assert got == want


@pytest.mark.parametrize("kw", [
    {"p_query": 0.7, "p_move": 0.4}, {"n_gids": 1}, {"n_gids": 11},
    {"join_max": 0}, {"join_max": 6}, {"n_clients": 2000, "n_gids": 10}])
def test_ctrler_config_rejects_what_the_reference_rejects(kw):
    assert _error(lambda: pct.CtrlerConfig(**kw)) == _error(
        lambda: jct.CtrlerConfig(**kw))


def test_ctrler_knobs_init_and_constants_equal_the_reference():
    kw = dict(p_op=0.4, p_query=0.2, p_move=0.3, bug_greedy_rebalance=True)
    for a, b in zip(jct.CtrlerConfig(**kw).knobs(),
                    pct.CtrlerConfig(**kw).knobs()):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    assert jct.CtrlerConfig(**kw)._arg_lim == pct.CtrlerConfig(**kw)._arg_lim
    for name in ("VIOLATION_CTRL_DIVERGE", "VIOLATION_CTRL_BALANCE",
                 "VIOLATION_CTRL_MINIMAL", "VIOLATION_CTRL_QUERY",
                 "N_SHARDS", "_SEQ_LIM", "_S_CLERK_START", "_S_CLERK_KIND"):
        assert getattr(jct, name) == getattr(pct, name), name
    jcfg, pcfg = _cfgs(metrics=True)
    kc = dict(n_gids=7, n_configs=9)
    want = jct.init_ctrler_cluster(jcfg, jct.CtrlerConfig(**kc),
                                   jax.random.PRNGKey(4))
    got = pct.init_ctrler_cluster(pcfg, pct.CtrlerConfig(**kc),
                                  torch.tensor([[0, 4]]), pcfg.knobs())
    flat = {k: v[None] for k, v in jax_flat(want).items()}
    assert pct.first_divergence(0, flat,
                                pct.ctrler_state_to_numpy(got)) is None
