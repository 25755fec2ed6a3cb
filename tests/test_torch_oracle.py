"""The safety oracle of the port's tick (kernel K2's plain version on the
CPU) against the JAX reference on planted divergences.

A mid-run storm state is taken from the reference, divergences are planted
cluster by cluster (two leaders in one term, a log-matching break, a
changed committed entry, equal snapshot boundaries with different prefix
hashes, a node prefix that disagrees with the shadow's fold), and the same
numpy state goes into both ticks through ``state_from_numpy``. Every leaf
of the next state must match, and each planted violation bit must fire.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from _torch_parity import Pair, configs, jax_host, single_thread, threefry_layout
from madraft_tpu_torch.kernels import oracle as oracle_k
from madraft_tpu_torch.tpusim import state as pstate
from madraft_tpu_torch.tpusim import step as pstep

N_CLUSTERS = 16


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def _quiet_pair(seed):
    # the planted tick runs with faults, loss, partitions and clients off
    # and the mailboxes empty, so nothing in the tick repairs the plant
    # before the oracle sees it
    jcfg, pcfg = configs("storm")
    pair = Pair(jcfg, pcfg, seed=seed, n_clusters=N_CLUSTERS)
    assert pair.run(120) is None
    quiet = dict(p_crash=0.0, p_restart=0.0, p_repartition=0.0, p_heal=0.0,
                 loss_prob=0.0, p_client_cmd=0.0)
    jq, pq = configs("storm", **quiet)
    pair.jcfg, pair.pcfg = jq, pq
    pair.jkn, pair.pkn = jq.knobs(), pq.knobs("cpu")
    h = {f: a.copy() for f, a in jax_host(pair.js).items()}
    for f in h:
        if f.endswith("_t") and f != "tick":
            h[f] = np.zeros_like(h[f])
    h["alive"][:] = True
    h["violations"][:] = 0
    h["first_violation_tick"][:] = -1
    return pair, h


def _plant(h):
    """Plant one divergence per cluster; returns {cluster: expected bit}."""
    cap = h["log_term"].shape[-1]
    want = {}
    # c0: two live leaders sharing a term
    h["role"][0, :2] = 2
    h["term"][0, 1] = h["term"][0, 0]
    want[0] = oracle_k.VIOLATION_DUAL_LEADER
    # c1: node 1 holds node 0's log with the last entry's value changed
    # (same index and term, different value)
    for f in ("log_term", "log_val", "log_len", "base", "snap_term",
              "prefix_hash", "commit"):
        h[f][1, 1] = h[f][1, 0]
    last = int(h["log_len"][1, 0])
    assert last > int(h["base"][1, 0])
    h["log_val"][1, 1, (last - 1) % cap] ^= 0x5A5A
    want[1] = oracle_k.VIOLATION_LOG_MATCHING
    # c2: a committed entry the shadow recorded changes in a node's log
    for c in range(2, N_CLUSTERS):
        lo = max(int(h["base"][c, 0]), int(h["shadow_base"][c]))
        hi = min(int(h["commit"][c, 0]), int(h["shadow_len"][c]),
                 int(h["log_len"][c, 0]))
        if hi > lo:
            h["log_val"][c, 0, (hi - 1) % cap] ^= 0x5A5A
            want[c] = oracle_k.VIOLATION_COMMIT_SHADOW
            break
    free = [c for c in range(2, N_CLUSTERS) if c not in want]
    # equal snapshot boundaries, different compacted prefixes
    c3 = free[0]
    h["base"][c3, 1] = h["base"][c3, 0] = max(int(h["base"][c3, 0]), 1)
    h["prefix_hash"][c3, 1] = h["prefix_hash"][c3, 0] ^ 1
    want[c3] = oracle_k.VIOLATION_PREFIX_DIVERGE
    # a node's prefix disagrees with the shadow's fold at the same boundary
    c4 = free[1]
    h["shadow_base"][c4] = h["base"][c4, 0] = max(int(h["base"][c4, 0]), 1)
    h["shadow_prefix_hash"][c4] = h["prefix_hash"][c4, 0] ^ 7
    want[c4] = oracle_k.VIOLATION_PREFIX_DIVERGE
    return want


@pytest.mark.parametrize("seed", [2, 9])
def test_planted_divergences_match_reference(seed):
    with threefry_layout(True):
        pair, h = _quiet_pair(seed)
        want = _plant(h)
        assert oracle_k.VIOLATION_COMMIT_SHADOW in want.values()
        pair.set_state(h)
        assert pair.divergence() is None
        pair.step()
        d = pair.divergence()
    assert d is None, f"first divergence: {d}"
    viol = np.asarray(pair.js.violations)
    for c, bit in want.items():
        assert viol[c] & bit, (c, bit, int(viol[c]))


def test_oracle_plain_is_the_step_oracle():
    # the oracle's own inputs/outputs on a real state: the plain version
    # leaves a clean state clean, only grows the shadow, and carries the
    # violation record through
    with threefry_layout(True):
        pair, h = _quiet_pair(4)
    s = pstate.state_from_numpy(h)
    t = s.tick + 1
    viol, st, sv, sb, sl, sh, vio, fvt, flt = oracle_k.oracle(
        s.alive, s.role, s.term, s.log_term, s.log_val, s.log_len, s.base,
        s.commit, s.prefix_hash, s.shadow_term, s.shadow_val, s.shadow_base,
        s.shadow_len, s.shadow_prefix_hash, s.violations,
        s.first_violation_tick, s.first_leader_tick, t)
    assert viol.dtype == torch.int32 and (viol == 0).all()
    assert (sl >= s.shadow_len).all() and (sb >= s.shadow_base).all()
    assert torch.equal(vio, s.violations)
    assert torch.equal(fvt, s.first_violation_tick)
    has_leader = (s.alive & (s.role == oracle_k.LEADER)).any(-1)
    assert torch.equal(flt, torch.where(
        (s.first_leader_tick < 0) & has_leader, t, s.first_leader_tick))


class _Recorder:
    """Stands in for the step's oracle and keeps each call's outputs."""

    def __init__(self):
        self.outs = []

    def __call__(self, *args):
        out = oracle_k.oracle(*args)
        self.outs.append(out)
        return out


def _assert_tail_is_reference(rec, pair):
    # the oracle's record outputs are the reference's next-state leaves
    # (nothing after the oracle block touches them)
    h = jax_host(pair.js)
    vio, fvt, flt = rec.outs[-1][6:]
    assert np.array_equal(vio.numpy(), h["violations"])
    assert np.array_equal(fvt.numpy(), h["first_violation_tick"])
    assert np.array_equal(flt.numpy(), h["first_leader_tick"])


def test_oracle_tail_matches_reference_on_a_storm_run(monkeypatch):
    # every tick of a run from init: leaders get elected on the way, and
    # the planted quorum bug makes violations fire
    rec = _Recorder()
    monkeypatch.setattr(pstep, "oracle", rec)
    with threefry_layout(True):
        pair = Pair(*configs("storm", majority_override=2), seed=6,
                    n_clusters=N_CLUSTERS)
        for _ in range(90):
            pair.step()
            _assert_tail_is_reference(rec, pair)
    h = jax_host(pair.js)
    assert (h["first_leader_tick"] > 0).any()
    assert (h["violations"] != 0).any() and (h["first_violation_tick"] > 0).any()


@pytest.mark.parametrize("seed", [2, 9])
def test_oracle_tail_matches_reference_on_planted_states(seed, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(pstep, "oracle", rec)
    with threefry_layout(True):
        pair, h = _quiet_pair(seed)
        want = _plant(h)
        h["first_leader_tick"][::2] = -1  # some clusters see their first leader
        pair.set_state(h)
        pair.step()
    _assert_tail_is_reference(rec, pair)
    t = int(h["tick"][0]) + 1
    fvt, flt = rec.outs[-1][7].numpy(), rec.outs[-1][8].numpy()
    assert all(fvt[c] == t for c in want)  # the planted clusters fire now
    assert (flt[::2] == t).any()
