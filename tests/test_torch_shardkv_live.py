"""The shardkv layer's live-controller mode (``live_ctrler``: the
configs' announces ride a replicated controller raft cluster, groups
learn them through Query mailboxes) against the live JAX package's
``madraft_tpu.tpusim.shardkv`` ``shardkv_step``, tick by tick, on the
CPU, at n = 3 under the partitionable layout, with metrics off
(``test_torch_shardkv_live_metrics.py`` runs the same with metrics on:
a file a compiled program keeps each file under a minute).

The controller cluster ticks beside the groups (``step_cluster`` on the
port's eager route, keyed ``fold_in(key, 21)``) and every
``ShardKvState`` leaf, the full controller cluster's among them, is
compared after every tick (``shardkv.first_divergence``). The kinds of
``chip_smoke.shardkv_knob_rows`` in live mode run side by side as [B]
knob rows: clean, the schedule mode's planted bugs, Puts, open-loop Zipf
traffic, the WrongGroup re-query and ``bug_stale_ctrler_read``, whose
log-tail answers let a group adopt a phantom announce. The storm is the
CLI's (loss 0.1, crash 0.01, one dead at most) with ``cfg_interval`` 16
and ``p_phantom`` 0.5, seed 2: over the 120 ticks the announces resolve,
shards migrate, and the stale-read rows raise CTRL_STALE while no clean
row violates. Then the controller walker's sticky stall from a planted
slid shadow window (the controller never compacts, so a run's own
commits never slide its shadow: the state is planted on both sides, as
``test_torch_ctrler_edges.py`` plants the ctrler's). Tolerance: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from _torch_parity import single_thread, threefry_layout
from madraft_tpu_torch.tpusim import shardkv as psk
from test_torch_shardkv import BUG_BITS, ShardKvPair, jax_flat

TICKS = 120
DEPLOYMENTS = 32
LIVE = {"live_ctrler": True, "p_phantom": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    # the controller modes' programs are among those whose serialize
    # crashes the persistent compilation cache
    from conftest import no_persistent_cache

    with no_persistent_cache():
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def check_ctrl_rows(kw: dict, n: int, metrics: bool, seed: int,
                    b: int = DEPLOYMENTS, ticks: int = TICKS):
    """The mode's kinds as knob rows on both sides: every leaf equal after
    every tick; announces resolve and shards migrate; the mode's bug
    raises CTRL_STALE on some of its rows; no clean kind's row violates.
    Returns the pair."""
    pair = ShardKvPair(kw, n, metrics, b, seed, rows=True)
    d = pair.run(ticks)
    assert d is None, d
    final = pair.js
    cases = chip_smoke.shardkv_row_cases(pair.pk)
    kind = np.arange(b) % len(cases)
    viol = np.asarray(final.violations)
    acked = np.asarray(final.clerk_acked).sum(-1)
    win = np.asarray(final.win_var)
    resolved = np.cumprod(win >= 0, axis=-1).sum(-1) - 1
    assert (resolved >= 2).mean() > 0.5, resolved
    assert np.asarray(final.installs_done).sum() > 0
    for i, name in enumerate(cases):
        m = kind == i
        assert acked[m].sum() > 0, name
        if name == "ctrl_bug":
            assert (viol[m] & psk.VIOLATION_SHARD_CTRL_STALE).any(), (
                f"{name}: CTRL_STALE never fired: {viol[m]}")
        elif name not in BUG_BITS:
            assert not viol[m].any(), f"{name} violated: {viol[m]}"
    # no row of another kind adopts a config the controller never decided
    stale = (viol & psk.VIOLATION_SHARD_CTRL_STALE) != 0
    assert not stale[kind != cases.index("ctrl_bug")].any()
    if metrics:
        assert np.asarray(final.lat_hist).sum() > 0
    return pair


def test_shardkv_live_ctrler_equals_the_reference_every_tick():
    with threefry_layout(True):
        check_ctrl_rows(LIVE, 3, False, 2)


def plant_slid_window(pair: ShardKvPair) -> None:
    """Both sides' controller shadow slid past the walker's frontier
    (shadow_base 5, shadow_len cap + 5): the walker's next entry is gone
    from the window."""
    h = jax_flat(pair.js)
    cap = pair.pcfg.log_cap
    h["ctrl.shadow_len"] = np.full_like(h["ctrl.shadow_len"], cap + 5)
    h["ctrl.shadow_base"] = np.full_like(h["ctrl.shadow_base"], 5)
    js = pair.js
    pair.js = js._replace(
        ctrl=type(js.ctrl)(*(jnp.asarray(h[f"ctrl.{f}"])
                             for f in js.ctrl._fields)))
    pair.ps = psk.shardkv_state_from_numpy(h)


def check_walker_stall(kw: dict, n: int, seed: int):
    """The planted slid window: both sides raise the sticky stall at the
    first tick, keep it, and resolve no announce past config 0, every
    leaf equal for 12 ticks (the kinds as rows: the parity test's
    compiled program)."""
    pair = ShardKvPair(kw, n, False, DEPLOYMENTS, seed, rows=True)
    plant_slid_window(pair)
    d = pair.run(12)
    assert d is None, d
    assert pair.ps.ctrl_w_stalled.all()
    assert (pair.ps.ctrl_w_frontier == 0).all()
    assert (pair.ps.win_var[:, 1:] < 0).all()


def test_shardkv_live_ctrler_walker_stall_equals_the_reference():
    with threefry_layout(True):
        check_walker_stall(LIVE, 3, 2)
