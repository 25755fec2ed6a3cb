"""The packed carry's schema and the plain versions of kernel K3
(``state.pack_state`` / ``state.unpack_state``) against the live JAX
package: leaf by leaf, dtypes and shapes included, on fresh clusters, on a
storm trajectory and on planted states whose lanes sit at the edges of
``config.packed_bounds`` (maxima, -1 sentinels, NOOP payloads, stamps at
tick + 255, every row-mask bit), at 3, 5 and 7 nodes. Also the bytes per
lane, the derived dtypes and the wide-fallback verdicts. Tolerance: exact
equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread
from madraft_tpu.tpusim import state as jst
from madraft_tpu.tpusim.config import SimConfig as JaxSimConfig
from madraft_tpu_torch.kernels import pack as K3
from madraft_tpu_torch.tpusim import engine, state
from madraft_tpu_torch.tpusim.config import SimConfig

STORM = dict(p_client_cmd=0.2, loss_prob=0.1, p_crash=0.01, p_restart=0.2,
             max_dead=2, p_repartition=0.02, p_heal=0.05)
B = 16


@functools.lru_cache(maxsize=None)
def _jax_pack(cfg):
    return (jax.jit(jax.vmap(functools.partial(jst.pack_state, cfg))),
            jax.jit(jax.vmap(functools.partial(jst.unpack_state, cfg))))


def _host(tree, fields) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in fields}


def _state(n: int, kind: str) -> tuple:
    cfg = SimConfig(n_nodes=n, **STORM)
    keys = engine.cluster_keys(11, B, "cpu")
    s = state.init_cluster(cfg, keys)
    if kind == "storm":
        kn = cfg.knobs("cpu")
        s = engine._advance(cfg, s, keys, kn, 100)
    h = state.state_to_numpy(s)
    if kind == "planted":
        h = state.planted_edge_state(cfg, h, n)
    return cfg, JaxSimConfig(n_nodes=n, **STORM), h


@pytest.mark.parametrize("kind", ["init", "storm", "planted"])
@pytest.mark.parametrize("n", [3, 5, 7])
def test_plain_pack_and_unpack_equal_the_reference(n, kind):
    with single_thread():
        cfg, jcfg, h = _state(n, kind)
        ps = state.state_from_numpy(h)
        pp = state.pack_state(cfg, ps)
        jpack, junpack = _jax_pack(jcfg)
        jp = jpack(jst.ClusterState(*(jnp.asarray(h[f])
                                      for f in jst.ClusterState._fields)))
        want = _host(jp, jst.PackedClusterState._fields)
        got = state.packed_state_to_numpy(pp)
        assert list(got) == list(want)
        for f in want:
            assert got[f].dtype == want[f].dtype, f
            assert got[f].shape == want[f].shape, f
            assert np.array_equal(got[f], want[f]), f
        back = state.state_to_numpy(state.unpack_state(cfg, pp))
        assert state.first_divergence(0, h, back) is None
        jback = _host(junpack(jp), jst.ClusterState._fields)
        assert state.first_divergence(0, jback, back) is None


def test_packed_bytes_per_lane_equal_the_reference():
    # the golden pool's shape: the durability profile with its bug
    from madraft_tpu.tpusim.config import storm_profiles as jax_profiles
    from madraft_tpu_torch.tpusim.config import storm_profiles

    cfg = storm_profiles()["durability"][0].replace(bug="ack_before_fsync")
    jcfg = jax_profiles()["durability"][0].replace(bug="ack_before_fsync")
    p = state.pack_state(cfg, state.init_cluster(
        cfg, engine.cluster_keys(1, 4, "cpu")))
    want = jst.abstract_bytes(jax.eval_shape(
        lambda k: jst.pack_state(jcfg, jst.init_cluster(jcfg, k)),
        jax.random.PRNGKey(0)))
    assert state.tree_bytes(p) / 4 == want == 2612


@pytest.mark.parametrize("max_lane_ticks", [8, 255, 4096, 40000, 2**24])
@pytest.mark.parametrize("n", [3, 5, 16])
def test_packed_spec_equals_the_reference(n, max_lane_ticks):
    got = state.packed_spec(SimConfig(n_nodes=n, max_lane_ticks=max_lane_ticks))
    want = jst.packed_spec(JaxSimConfig(n_nodes=n,
                                        max_lane_ticks=max_lane_ticks))
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if f == "noop_code":
            assert a == b
        else:
            assert str(b).replace("torch.", "") == np.dtype(a).name, f


def _fallback_cases(cls):
    storm = cls(n_nodes=5, **STORM)
    return [
        (storm, 10**6), (cls(n_nodes=17), 10), (storm.replace(delay_max=300), 10),
        (cls(ae_max=300, log_cap=1024), 10), (storm.replace(delay_min=0), 10),
        (storm.replace(p_limp=0.1, limp_mult_max=300), 10),
        (storm.replace(p_limp=0.1, limp_mult_max=100, delay_max=5), 10),
        (storm.replace(p_fsync_stall=0.1, fsync_stall_ticks=70000), 10),
        (storm.replace(eto_skew=20000), 10),
        (storm.replace(heartbeat_ticks=70000), 10),
        (storm, 10), (storm.replace(max_lane_ticks=8), 96),
    ]


def test_packed_layout_reason_gives_the_reference_verdicts():
    verdicts = []
    for (pc, ticks), (jc, _) in zip(_fallback_cases(SimConfig),
                                    _fallback_cases(JaxSimConfig)):
        got = state.packed_layout_reason(pc, pc.knobs(), ticks)
        assert got == jst.packed_layout_reason(jc, jc.knobs(), ticks)
        verdicts.append(got is None)
    assert verdicts.count(True) == 1  # only the plain storm run packs


def test_packed_numpy_round_trip_keeps_every_dtype():
    cfg = SimConfig(n_nodes=5, max_lane_ticks=2**20)  # u32 cmd, i32 ticks
    p = state.pack_state(cfg, state.init_cluster(
        cfg, engine.cluster_keys(2, 3, "cpu")))
    h = state.packed_state_to_numpy(p)
    assert {str(a.dtype) for a in h.values()} >= {
        "uint8", "int8", "uint16", "uint32", "int32"}
    q = state.packed_state_from_numpy(h)
    for f, a, b in zip(state.PackedClusterState._fields, p, q):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_k3_wrappers_take_the_plain_versions_on_the_cpu():
    cfg = SimConfig(n_nodes=5, **STORM)
    s = state.init_cluster(cfg, engine.cluster_keys(3, 4, "cpu"))
    before = (K3.pack_state.launches, K3.unpack_state.launches)
    p = K3.pack_state(cfg, s)
    w = K3.unpack_state(cfg, p)
    assert (K3.pack_state.launches, K3.unpack_state.launches) == before
    for f, a, b in zip(state.PackedClusterState._fields, p,
                       state.pack_state(cfg, s)):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert state.first_divergence(0, state.state_to_numpy(s),
                                  state.state_to_numpy(w)) is None


@pytest.mark.parametrize("n,max_lane_ticks", [(3, 8), (5, 4096), (7, 2**24)])
def test_packed_bounds_and_pool_id_rules_equal_the_reference(n, max_lane_ticks):
    from madraft_tpu.tpusim import config as jc
    from madraft_tpu_torch.tpusim import config as pc

    assert tuple(pc.packed_bounds(SimConfig(
        n_nodes=n, max_lane_ticks=max_lane_ticks))) == tuple(jc.packed_bounds(
            JaxSimConfig(n_nodes=n, max_lane_ticks=max_lane_ticks)))
    for cid in (0, 15, 16, 113, 4095, 4096, 10**6 + 3):
        for lanes, shards in ((16, 1), (16, 2), (64, 4), (4096, 8)):
            assert pc.pool_lane(cid, lanes) == jc.pool_lane(cid, lanes)
            assert pc.pool_generation(cid, lanes) == jc.pool_generation(
                cid, lanes)
            assert pc.pool_shard(cid, lanes, shards) == jc.pool_shard(
                cid, lanes, shards)
    with pytest.raises(ValueError, match="divide evenly"):
        pc.pool_lanes_per_shard(15, 2)
