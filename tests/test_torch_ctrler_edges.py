"""The shard-controller service layer against the live JAX package at its
edges, on the CPU, every ``CtrlerState`` leaf after every tick
(``test_torch_ctrler.CtrlerPair``): leader-targeted cuts (the reference
test's leader-in-minority partitions and one-sided cuts), ten gids with
one gid an op and a six-config history that fills (the ``room`` gate
closes), a reference state planted into the port through
``ctrler_state_from_numpy`` at tick 100 that ticks on equal, and the
reference test's constructed slid-window state, where both sides raise
the sticky walker stall, under both counter layouts. Tolerance: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu_torch.tpusim import ctrler as pct
from test_torch_ctrler import CtrlerPair, check_case, jax_flat


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.mark.parametrize("case", ["leader_cuts", "ng10_jm1_full_history"])
def test_ctrler_edge_tick_equals_the_reference_every_tick(case):
    check_case(case)


def test_ctrler_tick_from_a_planted_reference_state():
    """A JAX ctrler state at tick 100 (metrics on, the rotate bug planted),
    carried into the port through ``ctrler_state_from_numpy``, ticks on
    equal to the reference for 60 more ticks; the carry round-trips every
    leaf."""
    kw = {"bug_rotate_tiebreak": True}
    with threefry_layout(True):
        pair = CtrlerPair(kw, {}, True)
        for _ in range(100):
            pair.js = pair._jstep(pair.js, pair.jkeys, pair.jkn, pair.jckn)
        h = jax_flat(pair.js)
        pair.ps = pct.ctrler_state_from_numpy(h)
        pair.tick = 100
        assert pair.divergence() is None
        d = pair.run(60)
        assert d is None, d
    with pytest.raises(ValueError, match="int64"):
        pct.ctrler_state_from_numpy({**h, "hist": h["hist"].astype(
            np.int64)})


@pytest.mark.parametrize("partitionable", [True, False])
def test_ctrler_walker_stall_is_sticky_equal_to_the_reference(partitionable):
    """The reference test's constructed slid-window state (shadow_base past
    the walker's frontier): both sides raise the sticky stall at the
    first tick and keep it, every leaf equal for 12 ticks."""
    raft = dict(loss_prob=0.0, p_crash=0.0, p_repartition=0.0)
    with threefry_layout(partitionable):
        pair = CtrlerPair({}, raft, False, seed=3)
        cap = pair.pcfg.log_cap
        h = jax_flat(pair.js)
        h["shadow_len"] = np.full_like(h["shadow_len"], cap + 5)
        h["shadow_base"] = np.full_like(h["shadow_base"], 5)
        pair.js = type(pair.js)(
            raft=type(pair.js.raft)(*(jnp.asarray(h[f])
                                      for f in pair.js.raft._fields)),
            **{f: jnp.asarray(h[f]) for f in pair.js._fields[1:]})
        pair.ps = pct.ctrler_state_from_numpy(h)
        d = pair.run(12)
        assert d is None, d
        assert pair.ps.w_stalled.all()
        assert (pair.ps.w_frontier == 0).all()


