"""The kv service layer (``tpusim/kv.py``) against the live JAX package's
``madraft_tpu.tpusim.kv``, tick by tick, on the CPU.

The same seed, configs and threefry counter layout go through the JAX
``kv_step`` (vmapped, jitted) and the port's ``kv_step`` (the eager
route: ``step_cluster``, then K9's plain version), 16 clusters at the JAX
tests' ``BASE`` (storm faults, ``log_cap=32``), and every ``KvState``
leaf, raft leaves included, is compared after every tick
(``kv.first_divergence``): the storm, each planted kv bug, Puts, hint
following with ``retry_wait``, the open loop with the Zipf key draw
(``hot_key_openloop``'s workload), metrics on and off, both counter
layouts. Each bug case checks that its oracle fired (the stale hint, a
routing bug, only steers). Then a reference state planted into the port
(``kv_state_from_numpy``) ticks on equal to the reference. Tolerance:
exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import kv as jkv
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import kv as pkv
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg

# the JAX kv tests' BASE raft config
BASE = dict(n_nodes=5, p_client_cmd=0.0, compact_at_commit=False,
            loss_prob=0.1, p_crash=0.01, p_restart=0.2, max_dead=2,
            p_repartition=0.02, p_heal=0.05, log_cap=32, compact_every=8)
CLUSTERS, TICKS, SEED = 16, 100, 7
HOT_KEY = dict(open_rate=0.25, zipf_a=3.0, open_queue_cap=8, p_get=0.3,
               p_put=0.2)
# name -> (kv knobs, metrics, partitionable, the violation bit it must set);
# the planted uncommitted apply diverges within 100 ticks under seed 0
SEEDS = {"apply_uncommitted": 0}
CASES = {
    "storm": ({}, False, True, 0),
    "storm_metrics_legacy": ({}, True, False, 0),
    "skip_dedup": ({"bug_skip_dedup": True}, True, True,
                   pkv.VIOLATION_EXACTLY_ONCE),
    "apply_uncommitted": ({"bug_apply_uncommitted": True}, False, False,
                          pkv.VIOLATION_KV_DIVERGE),
    "stale_read_puts": ({"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2},
                        True, False, pkv.VIOLATION_STALE_READ),
    "stale_hint_hints": ({"bug_stale_hint": True, "p_follow_hint": 0.9,
                          "retry_wait": 3}, True, True, 0),
    "puts": ({"p_get": 0.3, "p_put": 0.3}, False, True, 0),
    "hot_key_openloop": (HOT_KEY, True, True, 0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg, jkcfg, partitionable: bool):
    # the knobs are arguments, so the kv configs of one static shape share
    # a program (the layout is read while tracing)
    init = jax.jit(jax.vmap(functools.partial(jkv.init_kv_cluster, jcfg,
                                              jkcfg)))
    step = jax.jit(jax.vmap(functools.partial(jkv.kv_step, jcfg, jkcfg),
                            in_axes=(0, 0, None, None)))
    return init, step


def jax_flat(ks) -> dict:
    """A JAX kv state as the port's flat field -> numpy mapping (writable
    copies, so that the port can take them as they are)."""
    out = {f: np.array(getattr(ks.raft, f)) for f in ks.raft._fields}
    out.update({f: np.array(getattr(ks, f)) for f in ks._fields[1:]})
    return out


def run_pair(kw: dict, metrics: bool, partitionable: bool,
             ticks: int = TICKS, n: int = CLUSTERS, seed: int = SEED):
    """Both sides from init, every leaf compared after every tick; returns
    (first divergence or None, the JAX final state)."""
    with threefry_layout(partitionable):
        jcfg = JaxCfg(**BASE, metrics=metrics)
        pcfg = PortCfg(**BASE, metrics=metrics)
        jk, pk = jkv.KvConfig(**kw), pkv.KvConfig(**kw)
        init, step = _jax_programs(jcfg, jk.static_key(), partitionable)
        jkeys = jengine._cluster_keys(jnp.uint32(seed), n)
        jkn, jkkn = jcfg.knobs(), jk.knobs()
        pkeys = pengine.cluster_keys(seed, n, "cpu")
        pkn, pkkn = pcfg.knobs("cpu"), pk.knobs("cpu")
        js = init(jkeys)
        ps = pkv.init_kv_cluster(pcfg, pk, pkeys, pkn)
        d = pkv.first_divergence(0, jax_flat(js), pkv.kv_state_to_numpy(ps))
        for t in range(1, ticks + 1):
            if d is not None:
                break
            js = step(js, jkeys, jkn, jkkn)
            ps = pkv.kv_step(pcfg, pk, ps, pkeys, pkn, pkkn)
            d = pkv.first_divergence(t, jax_flat(js),
                                     pkv.kv_state_to_numpy(ps))
        return d, js


@pytest.mark.parametrize("case", list(CASES))
def test_kv_tick_equals_the_reference_every_tick(case):
    kw, metrics, partitionable, bit = CASES[case]
    d, final = run_pair(kw, metrics, partitionable,
                        seed=SEEDS.get(case, SEED))
    assert d is None, d
    viol = np.asarray(final.raft.violations)
    assert np.asarray(final.clerk_acked).sum() > 0
    if bit:
        assert (viol & bit).any(), f"{case}: the oracle never fired"
    elif case != "stale_hint_hints":
        assert not viol.any(), f"{case}: a clean run violated: {viol}"
    if case == "hot_key_openloop":
        keys = np.asarray(final.key_lat_hist).sum(axis=(0, 2))
        assert keys[0] > keys[1:].sum(), "the Zipf draw skews to key 0"


def test_kv_tick_from_a_planted_reference_state():
    """A JAX kv state at tick 60 (metrics on, stale reads planted), carried
    into the port through ``kv_state_from_numpy``, ticks on equal to the
    reference for 30 more ticks; the carry round-trips every leaf."""
    kw = {"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2}
    with threefry_layout(True):
        jcfg = JaxCfg(**BASE, metrics=True)
        pcfg = PortCfg(**BASE, metrics=True)
        jk, pk = jkv.KvConfig(**kw), pkv.KvConfig(**kw)
        init, step = _jax_programs(jcfg, jk.static_key(), True)
        jkeys = jengine._cluster_keys(jnp.uint32(SEED), CLUSTERS)
        jkn, jkkn = jcfg.knobs(), jk.knobs()
        js = init(jkeys)
        for _ in range(60):
            js = step(js, jkeys, jkn, jkkn)
        h = jax_flat(js)
        ps = pkv.kv_state_from_numpy(h)
        assert pkv.first_divergence(60, h, pkv.kv_state_to_numpy(ps)) is None
        pkeys = pengine.cluster_keys(SEED, CLUSTERS, "cpu")
        pkn, pkkn = pcfg.knobs("cpu"), pk.knobs("cpu")
        for t in range(61, 91):
            js = step(js, jkeys, jkn, jkkn)
            ps = pkv.kv_step(pcfg, pk, ps, pkeys, pkn, pkkn)
            d = pkv.first_divergence(t, jax_flat(js),
                                     pkv.kv_state_to_numpy(ps))
            assert d is None, d
    with pytest.raises(ValueError, match="int64"):
        pkv.kv_state_from_numpy({**h, "clerk_seq": h["clerk_seq"].astype(
            np.int64)})
