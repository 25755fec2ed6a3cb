"""The shard-controller service layer (``tpusim/ctrler.py``) against the
live JAX package's ``madraft_tpu.tpusim.ctrler``, tick by tick, on the CPU.

The same seed, configs and threefry counter layout go through the JAX
``ctrler_step`` (vmapped, jitted) and the port's ``ctrler_step`` (the
eager route: ``step_cluster``, then K10's plain version), 16 clusters at
the JAX tests' ``BASE`` (storm faults, ``log_cap=32``), and every
``CtrlerState`` leaf, raft leaves included, is compared after every tick
(``ctrler.first_divergence``). This file runs the storm with metrics off
(partitionable layout) and on (legacy layout) and holds the closed-form
helpers (``_rebalance`` under every bug flag and tie rotation,
``_min_moves``, ``_hash_config``) and the clerks' 2-D gid draw against
the reference's. ``CtrlerPair`` and ``CASES`` serve
``test_torch_ctrler_bugs.py`` and ``test_torch_ctrler_edges.py`` too.
Tolerance: exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import ctrler as jct
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.tpusim import ctrler as pct
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg

# the JAX ctrler tests' BASE raft config
BASE = dict(n_nodes=5, p_client_cmd=0.0, compact_at_commit=False,
            loss_prob=0.1, p_crash=0.01, p_restart=0.2, max_dead=2,
            p_repartition=0.02, p_heal=0.05, log_cap=32, compact_every=8)
LEADER_CUTS = dict(p_repartition=0.0, p_leader_part=0.03, p_asym_cut=0.05,
                   p_heal=0.06)
CLUSTERS, TICKS, SEED = 16, 200, 11
# name -> (ctrler config, raft overrides, metrics, partitionable, the
# violation bit it must set, ticks); this file runs the first two, the
# others run in test_torch_ctrler_bugs.py and test_torch_ctrler_edges.py
CASES = {
    "storm": ({}, {}, False, True, 0, TICKS),
    "storm_metrics_legacy": ({}, {}, True, False, 0, TICKS),
    "rotate_tiebreak": ({"bug_rotate_tiebreak": True}, {}, True, True,
                        pct.VIOLATION_CTRL_DIVERGE, TICKS),
    "greedy_rebalance": ({"bug_greedy_rebalance": True}, {}, False, False,
                         pct.VIOLATION_CTRL_BALANCE, TICKS),
    "full_reshuffle": ({"bug_full_reshuffle": True}, {}, True, False,
                       pct.VIOLATION_CTRL_MINIMAL, 260),
    "leader_cuts": ({}, LEADER_CUTS, True, True, 0, TICKS),
    # ten gids, one a Join/Leave, and a history of six configs that fills
    "ng10_jm1_full_history": ({"n_gids": 10, "join_max": 1, "n_configs": 6,
                               "p_query": 0.2, "p_move": 0.2}, {}, False,
                              True, 0, TICKS),
}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg, jkcfg, partitionable: bool):
    # the knobs are arguments, so the configs of one static shape share a
    # program (the layout is read while tracing)
    init = jax.jit(jax.vmap(functools.partial(jct.init_ctrler_cluster, jcfg,
                                              jkcfg), in_axes=(0, None)))
    step = jax.jit(jax.vmap(functools.partial(jct.ctrler_step, jcfg, jkcfg),
                            in_axes=(0, 0, None, None)))
    return init, step


def jax_flat(ks) -> dict:
    """A JAX ctrler state as the port's flat field -> numpy mapping
    (writable copies, so that the port can take them as they are)."""
    out = {f: np.array(getattr(ks.raft, f)) for f in ks.raft._fields}
    out.update({f: np.array(getattr(ks, f)) for f in ks._fields[1:]})
    return out


class CtrlerPair:
    """The reference and the port stepping the same ctrler batch."""

    def __init__(self, kw: dict, raft: dict, metrics: bool,
                 n: int = CLUSTERS, seed: int = SEED):
        self.jcfg = JaxCfg(**{**BASE, **raft}, metrics=metrics)
        self.pcfg = PortCfg(**{**BASE, **raft}, metrics=metrics)
        self.jk, self.pk = jct.CtrlerConfig(**kw), pct.CtrlerConfig(**kw)
        init, self._jstep = _jax_programs(self.jcfg.static_key(),
                                          self.jk.static_key(),
                                          prng.partitionable())
        self.jkeys = jengine._cluster_keys(jnp.uint32(seed), n)
        self.jkn, self.jckn = self.jcfg.knobs(), self.jk.knobs()
        self.pkeys = pengine.cluster_keys(seed, n, "cpu")
        self.pkn, self.pckn = self.pcfg.knobs("cpu"), self.pk.knobs("cpu")
        self.js = init(self.jkeys, self.jkn)
        self.ps = pct.init_ctrler_cluster(self.pcfg, self.pk, self.pkeys,
                                          self.pkn)
        self.tick = 0

    def divergence(self):
        return pct.first_divergence(self.tick, jax_flat(self.js),
                                    pct.ctrler_state_to_numpy(self.ps))

    def run(self, ticks: int):
        """Step both sides, every leaf compared after every tick; the
        first divergence or None."""
        d = self.divergence()
        for _ in range(ticks):
            if d is not None:
                return d
            self.js = self._jstep(self.js, self.jkeys, self.jkn, self.jckn)
            self.ps = pct.ctrler_step(self.pcfg, self.pk, self.ps,
                                      self.pkeys, self.pkn, self.pckn)
            self.tick += 1
            d = self.divergence()
        return d


def check_case(case: str):
    """Run one of CASES on both sides; every leaf equal after every tick,
    configs created and Queries completed, the case's oracle fired (and
    none in a clean case)."""
    kw, raft, metrics, partitionable, bit, ticks = CASES[case]
    with threefry_layout(partitionable):
        pair = CtrlerPair(kw, raft, metrics)
        d = pair.run(ticks)
    assert d is None, d
    final = pair.js
    viol = np.asarray(final.raft.violations)
    assert np.asarray(final.clerk_acked).sum() > 0
    assert np.asarray(final.w_cfg_num).sum() > 0, "no config created"
    assert np.asarray(final.queries_done).sum() > 0, "no Query completed"
    if bit:
        assert (viol & bit).any(), f"{case}: the oracle never fired"
    else:
        assert not viol.any(), f"{case}: a clean run violated: {viol}"
    if case == "ng10_jm1_full_history":
        # the history filled: mutations are rejected from then on
        assert (np.asarray(final.w_cfg_num)
                == pair.pk.n_configs - 1).any()
    if metrics:
        assert np.asarray(final.raft.lat_hist).sum() > 0


@pytest.mark.parametrize("case", ["storm", "storm_metrics_legacy"])
def test_ctrler_tick_equals_the_reference_every_tick(case):
    check_case(case)


def _random_states(rng, ng, n_cases):
    # the reference tests' random (member, owner) states
    for _ in range(n_cases):
        member = rng.random(ng) < 0.6
        if not member.any():
            member[rng.integers(ng)] = True
        yield member, rng.integers(-1, ng, size=pct.N_SHARDS)


@pytest.mark.parametrize("ng", [5, 2, 10])
def test_rebalance_min_moves_and_hash_equal_the_reference(ng):
    """``_rebalance`` (each bug flag and tie_rot 0-4), ``_min_moves`` and
    ``_hash_config`` over 120 random states against the reference's, the
    port batched over the states, the reference vmapped."""
    rng = np.random.default_rng(ng)
    states = list(_random_states(rng, ng, 120))
    member = np.stack([m for m, _ in states])
    owner = np.stack([o for _, o in states]).astype(np.int32)
    nums = rng.integers(0, 30, len(states)).astype(np.int32)
    pm, po = torch.from_numpy(member), torch.from_numpy(owner)
    for rot in range(5):
        for greedy, reshuffle in ((False, False), (True, False),
                                  (False, True), (True, True)):
            want = jax.vmap(lambda m, o: jct._rebalance(
                ng, m, o, jnp.int32(rot), jnp.bool_(greedy),
                jnp.bool_(reshuffle)))(jnp.asarray(member),
                                       jnp.asarray(owner))
            got = pct._rebalance(ng, pm, po, torch.tensor(rot),
                                 torch.tensor(greedy), torch.tensor(reshuffle))
            assert np.array_equal(np.asarray(want), got.numpy()), (
                rot, greedy, reshuffle)
    want = jax.vmap(lambda m, o: jct._min_moves(ng, m, o))(
        jnp.asarray(member), jnp.asarray(owner))
    assert np.array_equal(np.asarray(want), pct._min_moves(ng, pm, po).numpy())
    want = jax.vmap(jct._hash_config)(jnp.asarray(member), jnp.asarray(owner),
                                      jnp.asarray(nums))
    got = pct._hash_config(pm, po, torch.from_numpy(nums))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(jct._HASH_POW, pct._HASH_POW)


@pytest.mark.parametrize("partitionable", [True, False])
def test_gid_set_draw_equals_jax_two_dimensional_randint(partitionable):
    """The clerks' (nc, join_max) gid draw, which the port takes as one
    flat stream reshaped row-major, against ``jax.random.randint`` over
    the 2-D shape."""
    with threefry_layout(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(5), 32)
        pkeys = torch.from_numpy(
            np.asarray(jax.random.key_data(keys)).astype(np.int64))
        for nc, jm, ng in ((4, 3, 5), (3, 1, 10), (5, 10, 10)):
            want = jax.vmap(lambda k: jax.random.randint(
                k, (nc, jm), 0, ng, dtype=jnp.int32))(keys)
            got = prng.randint(pkeys, nc * jm, 0, ng).view(32, nc, jm)
            assert np.array_equal(np.asarray(want), got.numpy())
