"""The shardkv layer's computed-controller mode (``computed_ctrler``: the
controller cluster's apply machine is the 4A rebalance over committed
membership flips, and a group adopts the map of the replica that answered
its Query) against the live JAX package's ``madraft_tpu.tpusim.shardkv``
``shardkv_step``, tick by tick, on the CPU, at n = 5 under the legacy
threefry layout.

Every ``ShardKvState`` leaf, the full controller cluster, the replicas'
owner chains and write-once map history among them, is compared after
every tick (``shardkv.first_divergence``). The kinds of
``chip_smoke.shardkv_knob_rows`` in computed mode run as [B] knob rows:
clean, the schedule mode's planted bugs, Puts, open-loop Zipf traffic,
the WrongGroup re-query and ``bug_rotate_tiebreak``, whose replicas
rotate their deficit-fill order. The CLI's storm with ``cfg_interval``
16, seed 2, 120 ticks. On the compared batch it asserts what the
reference's ``test_shardkv_computed_ctrler_clean`` asserts: each resolved
slot's committed flip is one of the two racing proposals, the phantom's
wins somewhere, every computed config is balanced; and CTRL_STALE fires
on the rotate rows while no clean row violates. Then the init draws of
``flip_a`` / ``flip_b`` under both layouts, and the controller walker's
sticky stall from a planted slid shadow window. Tolerance: exact
equality."""

import functools

import jax
import numpy as np
import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import shardkv as jsk
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig as PortCfg
from test_torch_shardkv import BASE
from test_torch_shardkv_live import check_ctrl_rows, check_walker_stall

COMPUTED = {"computed_ctrler": True}


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    # the computed-controller programs crash the persistent compilation
    # cache's serialize (tests/test_tpusim_shardkv.py)
    from conftest import no_persistent_cache

    with no_persistent_cache():
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def test_shardkv_computed_ctrler_equals_the_reference_every_tick():
    with threefry_layout(False):
        pair = check_ctrl_rows(COMPUTED, 5, False, 2)
    final = pair.js
    win = np.asarray(final.win_var)
    fa, fb = np.asarray(final.flip_a), np.asarray(final.flip_b)
    resolved = win >= 0
    resolved[:, 0] = False  # slot 0 is the fixed initial config
    assert resolved.any()
    assert ((win == fa) | (win == fb))[resolved].all()
    assert (win == fb)[resolved].any(), "the phantom never won a slot"
    own = np.asarray(final.cfg_owner)  # [B, NCFG, NS]
    for d, j in zip(*np.nonzero(resolved)):
        counts = np.bincount(own[d, j], minlength=pair.pk.n_groups)
        owners = counts[counts > 0]
        assert owners.max() - owners.min() <= 1, (d, j, counts)


@pytest.mark.parametrize("partitionable", [True, False])
def test_shardkv_computed_ctrler_init_draws_equal_the_reference(
        partitionable):
    """The flip schedule (flip_a, and flip_b always a different gid), the
    placeholder owner rows and the full controller cluster at init."""
    cfg = PortCfg(n_nodes=5, **BASE)
    kw = dict(computed_ctrler=True, n_groups=4, n_configs=9)
    pk, jk = psk.ShardKvConfig(**kw), jsk.ShardKvConfig(**kw)
    with threefry_layout(partitionable):
        pkeys = pengine.cluster_keys(9, 6, "cpu")
        jkeys = jengine._cluster_keys(np.uint32(9), 6)
        from madraft_tpu.tpusim.config import SimConfig as JaxCfg

        jcfg = JaxCfg(n_nodes=5, **BASE)
        js = jax.jit(jax.vmap(functools.partial(
            jsk.init_shardkv_cluster, jcfg, jk)))(jkeys)
        ps = psk.init_shardkv_cluster(cfg, pk, pkeys)
    from test_torch_shardkv import jax_flat

    d = psk.first_divergence(0, jax_flat(js), psk.shardkv_state_to_numpy(ps))
    assert d is None, d
    fa, fb = ps.flip_a, ps.flip_b
    assert ((fa != fb) & (fb >= 0) & (fb < 4)).all()
    assert ps.ctrl.term.shape == (6, 5)


def test_shardkv_computed_ctrler_walker_stall_equals_the_reference():
    with threefry_layout(False):
        check_walker_stall(COMPUTED, 5, 2)
