"""The shardkv layer's drivers against the live JAX package, on the CPU:
``_gen_schedule`` over many keys and shapes under both threefry layouts
(``cfg_interval`` a [B] row), ``shardkv_report`` of the port's final
state against the reference's report of the same state (the schedule
mode, and both controller modes with a planted walker stall), the knob
validators' refusals in the reference's words, ``config.zipf_map`` over
every shard draw at the CLI's ``n_shards`` = 10, ``make_shardkv_sweep_fn``
(each deployment of a [B] knob-row sweep equals a uniform run of its own
row), the nested state's numpy round trip, and the controller modes'
refusals in the reference's words. Tolerance: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import config as jconfig
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import shardkv as jsk
from madraft_tpu.tpusim.state import ClusterState as JaxState
from madraft_tpu_torch.tpusim import config as pconfig
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig

BASE = dict(p_client_cmd=0.0, compact_at_commit=False, log_cap=64,
            compact_every=16, loss_prob=0.1, p_crash=0.01, p_restart=0.2,
            max_dead=1)


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.mark.parametrize("partitionable", [True, False])
def test_gen_schedule_equals_the_reference(partitionable):
    """``_gen_schedule`` over 64 keys a shape against the reference's
    (vmapped, cfg_interval a [B] row), at the CLI's shape, one group, two
    groups with six shards and a long schedule, five groups."""
    with threefry_layout(partitionable):
        keys = jengine._cluster_keys(jnp.uint32(9), 64)
        pkeys = pengine.cluster_keys(9, 64, "cpu")
        ci = np.arange(64, dtype=np.int32) % 50 + 2
        for kw in ({}, {"n_groups": 1}, {"n_groups": 2, "n_shards": 6,
                                         "n_configs": 12},
                   {"n_groups": 5, "n_configs": 9}):
            jk, pk = jsk.ShardKvConfig(**kw), psk.ShardKvConfig(**kw)
            jskn = jk.knobs()
            pskn = pk.knobs()._replace(cfg_interval=torch.from_numpy(ci))
            want = jax.vmap(lambda k, c: jsk._gen_schedule(
                None, jk, k, jskn._replace(cfg_interval=c)))(
                    keys, jnp.asarray(ci))
            got = psk._gen_schedule(pk, pkeys, pskn)
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), g.numpy()), kw


def _as_jax(st: psk.ShardKvState):
    """A port state as the reference's ShardKvState of JAX arrays."""
    flat = {f: jnp.asarray(a) for f, a in psk.shardkv_state_to_numpy(st).items()}
    return jsk.ShardKvState(
        rafts=JaxState(*(flat[f"rafts.{f}"] for f in JaxState._fields)),
        ctrl=JaxState(*(flat[f"ctrl.{f}"] for f in JaxState._fields)),
        **{f: flat[f] for f in psk.SERVICE})


@pytest.mark.parametrize("metrics", [False, True])
def test_report_equals_the_reference_report_of_the_same_state(metrics):
    cfg = SimConfig(n_nodes=3, metrics=metrics, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=16, bug_serve_frozen=True,
                             p_put=0.2)
    final = psk.make_shardkv_fuzz_fn(cfg, kcfg, 6, 90, "cpu")(7)
    got = psk.shardkv_report(final)
    want = jsk.shardkv_report(_as_jax(final))
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            assert np.array_equal(a, b), f
    assert got.installs.sum() > 0 and got.acked_ops.sum() > 0
    assert (got.ann_resolved == 0).all() and not got.ctrl_walker_stalled.any()
    # the numpy round trip of the nested state
    back = psk.shardkv_state_from_numpy(psk.shardkv_state_to_numpy(final))
    assert psk.first_divergence(0, psk.shardkv_state_to_numpy(final),
                                psk.shardkv_state_to_numpy(back)) is None


@pytest.mark.parametrize("kw", [
    {"live_ctrler": True, "bug_stale_ctrler_read": True, "p_phantom": 0.5},
    {"computed_ctrler": True, "bug_rotate_tiebreak": True}])
def test_controller_mode_report_equals_the_reference_report(kw):
    """A controller mode's final state, its walker stall planted on some
    deployments: every report field the reference's, the announces'
    resolved frontier (``ann_resolved``) and the sticky stall among
    them."""
    cfg = SimConfig(n_nodes=3, metrics=True, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=16, **kw)
    final = psk.make_shardkv_fuzz_fn(cfg, kcfg, 6, 90, "cpu")(7)
    final = final._replace(
        ctrl_w_stalled=torch.arange(6) % 3 == 0)
    got = psk.shardkv_report(final)
    want = jsk.shardkv_report(_as_jax(final))
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            assert np.array_equal(a, b), f
    assert (got.ann_resolved >= 2).any() and got.ctrl_walker_stalled.sum() == 2


@pytest.mark.parametrize("case", [
    "prob_range", "p_get_plus_p_put", "queue_cap", "zipf_a", "delay_span",
    "cfg_interval", "bug_dtype"])
def test_knob_validators_refuse_as_the_reference(case):
    jk, pk = jsk.ShardKvConfig().knobs(), psk.ShardKvConfig().knobs()
    change = {
        "prob_range": ("p_pull", 1.5), "p_get_plus_p_put": ("p_put", 0.8),
        "queue_cap": ("open_queue_cap", 9), "zipf_a": ("zipf_a", 0.5),
        "delay_span": ("pull_delay_max", 0), "cfg_interval": (
            "cfg_interval", 1),
        "bug_dtype": ("bug_skip_freeze", 1),
    }[case]
    field, v = change
    jv = getattr(jk, field)
    pv = getattr(pk, field)
    jk = jk._replace(**{field: jnp.asarray(v, jv.dtype if case != "bug_dtype"
                                           else jnp.int32)})
    pk = pk._replace(**{field: torch.tensor(v, dtype=pv.dtype
                                            if case != "bug_dtype"
                                            else torch.int32)})
    with pytest.raises(ValueError) as want:
        jsk._validate_shardkv_knobs(jk)
    with pytest.raises(ValueError) as got:
        psk._validate_shardkv_knobs(pk)
    assert str(got.value) == str(want.value)


def test_zipf_map_equals_jax_over_the_shard_grid():
    draws = np.arange(10, dtype=np.int32)
    for a in (1.0, 1.5, 1.6, 2.0, 3.0):
        want = jax.jit(jconfig.zipf_map, static_argnums=1)(
            jnp.asarray(draws), 10, jnp.float32(a))
        got = pconfig.zipf_map(torch.from_numpy(draws), 10,
                               torch.tensor(a, dtype=torch.float32))
        assert np.array_equal(np.asarray(want), got.numpy()), a


def test_sweep_deployments_equal_uniform_runs_of_their_rows():
    """A [B] knob-row sweep (a bug, Puts and the interval a row) against
    uniform runs of each row's knobs: deployment d of the sweep is
    deployment d of its row's run, every leaf."""
    cfg = SimConfig(n_nodes=3, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=16)
    b, ticks = 4, 40
    i = torch.arange(b)
    rows = kcfg.knobs().broadcast(b)._replace(
        bug_drop_dup_table=i == 1, p_put=torch.where(i == 2, 0.4, 0.0),
        cfg_interval=torch.where(i == 3, 9, 16).int())
    sweep = psk.make_shardkv_sweep_fn(cfg, cfg.knobs(), rows, kcfg, b, ticks,
                                      "cpu")(3)
    got = psk.shardkv_state_to_numpy(sweep)
    for d in range(b):
        row = kcfg.replace(bug_drop_dup_table=d == 1,
                           p_put=0.4 if d == 2 else 0.0,
                           cfg_interval=9 if d == 3 else 16)
        want = psk.shardkv_state_to_numpy(
            psk.make_shardkv_fuzz_fn(cfg, row, b, ticks, "cpu")(3))
        one = {f: x[d:d + 1] for f, x in want.items()}
        mine = {f: x[d:d + 1] for f, x in got.items()}
        assert psk.first_divergence(ticks, one, mine) is None, d
    with pytest.raises(ValueError, match="computed_ctrler"):
        psk.make_shardkv_sweep_fn(cfg, cfg.knobs(), rows._replace(
            bug_rotate_tiebreak=i == 0), kcfg, b, ticks, "cpu")


def test_controller_modes_are_refused_naming_the_item():
    """The controller modes build and run (their reports carry the
    controller's fields); what is refused is refused as the reference
    refuses it, naming the item: both modes at once, a computed mode the
    4A rebalance cannot run, a controller bug without its mode (the
    config, and the sweep's knob rows)."""
    cfg = SimConfig(n_nodes=3, **BASE)
    for kw in ({"live_ctrler": True}, {"computed_ctrler": True}):
        rep = psk.shardkv_report(psk.make_shardkv_fuzz_fn(
            cfg, psk.ShardKvConfig(**kw), 2, 2, "cpu")(1))
        assert (rep.ann_resolved == 0).all()
        assert not rep.ctrl_walker_stalled.any()
    kcfg = psk.ShardKvConfig(live_ctrler=True)
    rows = kcfg.knobs().broadcast(2)._replace(
        bug_rotate_tiebreak=torch.tensor([False, True]))
    with pytest.raises(ValueError, match="computed_ctrler"):
        psk.make_shardkv_sweep_fn(cfg, cfg.knobs(), rows, kcfg, 2, 2, "cpu")
    # the reference's config checks, copied
    for kw, msg in (({"computed_ctrler": True, "live_ctrler": True},
                     "supersedes"),
                    ({"computed_ctrler": True, "bug_stale_ctrler_read": True},
                     "live_ctrler-mode"),
                    ({"computed_ctrler": True, "n_groups": 1}, "n_groups"),
                    ({"computed_ctrler": True, "n_shards": 8}, "N_SHARDS"),
                    ({"bug_rotate_tiebreak": True}, "computed_ctrler"),
                    ({"p_get": 0.7, "p_put": 0.5}, "p_get"),
                    ({"n_clients": 4000}, "overflow")):
        for mod in (jsk, psk):
            with pytest.raises(ValueError, match=msg):
                mod.ShardKvConfig(**kw)
