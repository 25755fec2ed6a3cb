"""One lockstep tick of a batch of simulated Raft clusters, in PyTorch.

The batched twin of ``madraft_tpu/tpusim/step.py`` ``step_cluster``: the
same phases in the same order (faults, five delivery passes, timers and
client injection, heartbeat/replication, commit advance, oracle,
compaction, fsync), the same draws from the same threefry words, and the
same integer and float32 arithmetic, so every state leaf matches the
reference bit for bit. The reference's module docstring explains the model.

Where the reference vmaps a single-cluster function, this one carries the
cluster axis first: a ``[n]`` array there is ``[B, n]`` here, ``[n, n]`` is
``[B, n, n]``, a transpose ``.T`` swaps the last two axes, and a per-cluster
scalar is ``[B]`` (``[:, None]`` / ``[:, None, None]`` to meet node axes).

Kernels carry the tick on the card. On every path there
(``engine.tick_route``) the engine runs a chunk of ticks as one launch of
``kernels.tick.tick_chunk`` (K6), the whole of this function in CUDA,
oracle included, and with the metrics plane on (``cfg.metrics``) its
metrics variant, which also carries the submit stamps, the latency fold
and the event counters; this function is K6's plain version. On the eager
route (the CPU, or ``tick="eager"``) the engine calls this function once
a tick, and kernels carry parts of it: ``kernels.threefry.tick_blocks``
draws the words (a chunk of ticks at once, each tick given its ``[B,
total]`` slice; a tick called alone draws its own),
``kernels.oracle.oracle`` (K2) runs the safety oracle with its tail, and
with the metrics plane on the oracle's metrics instance carries the
submit stamps and ``kernels.metrics.latency_fold`` (K4) folds the commit
latencies. The rest of that tick, the metrics plane's stamp updates and
event counters among it, is plain PyTorch.
"""

from __future__ import annotations

import torch

from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.kernels import metrics as K4
from madraft_tpu_torch.kernels.oracle import entry_mix, lane_abs, oracle, xor_reduce
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    CANDIDATE,
    FOLLOWER,
    LATENCY_PHASES,
    LEADER,
    NOOP_CMD,
    SimConfig,
    lane_view,
)
from madraft_tpu_torch.tpusim.state import ClusterState

I32 = torch.int32
F32 = torch.float32
_BIG = 1 << 30  # sentinel above any absolute log index


class _DrawBlock:
    """All of a tick's randomness: ``[B, total]`` threefry words, sliced in
    the reference's fixed order (its ``_DrawBlock`` explains the draws)."""

    def __init__(self, words: torch.Tensor):
        self.bits = words  # int64-held u32 words
        self.off = 0

    def _take(self, shape):
        size = 1
        for d in shape:
            size *= d
        out = self.bits[:, self.off:self.off + size]
        self.off += size
        return out.reshape(out.shape[0], *shape)

    @staticmethod
    def _u01(words):
        """u32 words -> exact float32 uniforms in [0, 1) from bits 8..31."""
        return (words >> 8).to(F32) * (2.0 ** -24)

    def bern(self, p, shape):
        return self._u01(self._take(shape)) < p

    def bern_w(self, p, shape):
        w = self._take(shape)
        return self._u01(w) < p, w

    def randint(self, lo, hi, shape):
        val, _ = self.randint_w(lo, hi, shape)
        return val

    def randint_w(self, lo, hi, shape):
        """lo + floor(u01 * span) in float32, plus the raw words."""
        w = self._take(shape)
        dev = w.device
        lo = torch.as_tensor(lo, dtype=I32, device=dev)
        hi = torch.as_tensor(hi, dtype=I32, device=dev)
        span = (hi - lo).to(F32)
        return lo + torch.floor(self._u01(w) * span).to(I32), w

    def uniform(self, shape):
        return self._u01(self._take(shape))


def _bern8(words, p):
    """Bernoulli(p) from the free low byte of already-consumed words."""
    return (words & 0xFF).to(F32) * (2.0 ** -8) < p


def _randint8(words, lo, span):
    """lo + floor(low_byte / 256 * span), in u32 arithmetic."""
    s = torch.clamp(span.to(torch.int64), min=0)
    return lo + ((((words & 0xFF) * s) & threefry.MASK) >> 8).to(I32)


def _block_total(n: int) -> int:
    return 11 * n + 3 + 3 * n * n


def _timeout_draw(kn, blk, shape, skew):
    return blk.randint(kn.eto_min, kn.eto_max + 1, shape) + skew


def _net_draws(kn, blk, shape):
    """(delay, lost) per send from one word: bits 8..31 decide loss, the
    low byte the delay by multiply-shift."""
    w = blk._take(shape)
    lost = blk._u01(w) < kn.loss_prob
    span = torch.clamp(kn.delay_max + 1 - kn.delay_min, 1, 256).to(torch.int64)
    delay = kn.delay_min + (((w & 0xFF) * span) >> 8).to(I32)
    return delay, lost


def _slot(abs_idx, cap: int):
    """Canonical lane of absolute (1-based) index: (a - 1) mod cap."""
    return (abs_idx - 1) & (cap - 1)


def _row_gather(arr, pos, cap: int):
    """arr[..., i, pos[..., i]] over the lane axis."""
    idx = torch.clamp(pos, 0, cap - 1).to(torch.int64)[..., None]
    return arr.gather(-1, idx)[..., 0]


def _term_at(log_term, snap_term, base, abs_idx, cap):
    """Term of absolute index abs_idx per node; snap_term at the boundary."""
    return torch.where(
        abs_idx <= base, snap_term, _row_gather(log_term, _slot(abs_idx, cap), cap)
    )


def _first_true(mask, me):
    """Index of the first True along the last axis, 0 if none (the
    reference's argmax over a bool vector)."""
    n = mask.shape[-1]
    first = torch.where(mask, me, n).amin(-1)
    return torch.where(first == n, 0, first)


def step_cluster(
    cfg: SimConfig, s: ClusterState, cluster_keys: torch.Tensor, kn=None,
    words=None,
) -> ClusterState:
    """One tick of every cluster in the batch. ``cluster_keys`` [B, 2] are
    the per-cluster PRNG keys (``engine.cluster_keys``); ``kn`` the knobs
    (from ``cfg`` when omitted), each field 0-d or a [B] row of per-cluster
    values (the reference's per-cluster knob layout); ``words`` the tick's
    ``[B, total]`` draw words when drawn ahead
    (``kernels.threefry.tick_blocks`` at ``s.tick + 1``), else the tick
    draws them itself."""
    metrics = cfg.metrics
    # the event counters' pre-tick baselines, taken before the suffix-loss
    # rollback, so a bump is counted net of it
    term0, commit0 = s.term, s.commit
    dev = s.term.device
    if kn is None:
        kn = cfg.knobs(dev)
    # each knob is 0-d (uniform) or a [B] row: k2 / k3 view it against
    # [B, n] / [B, n, n] operands, kn itself meets [B] ones
    k2, k3 = kn.lanes(2), kn.lanes(3)
    n, cap, ae_max = cfg.n_nodes, cfg.log_cap, cfg.ae_max
    t = s.tick + 1  # [B]
    t1, t2 = t[:, None], t[:, None, None]
    total = _block_total(n)
    if words is None:
        words = threefry.tick_block(cluster_keys, t, total, prng.partitionable())
    elif words.shape != (t.shape[0], total):
        raise ValueError(
            f"words must be [B, {total}], got {tuple(words.shape)}")
    blk = _DrawBlock(words)
    me = torch.arange(n, dtype=I32, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    lane = torch.arange(cap, dtype=I32, device=dev)
    skew = me * k2.eto_skew

    def rows(x):  # [B, n] per-node value -> [B, 1, n] along the src axis
        return x[:, None, :]

    def cols(x):  # [B, n] -> [B, n, 1] along the dst axis
        return x[:, :, None]

    # ------------------------------------------------------------------ faults
    rp = torch.clamp(kn.rolling_period, min=1)
    wave = t // rp
    wave_i = wave[:, None] - ((wave[:, None] - me) % n)
    age = t1 - wave_i * lane_view(rp, 2)
    roll_on = k2.rolling_period > 0
    roll_sched = roll_on & (wave_i >= 0)
    roll_down = roll_sched & (age < k2.rolling_down)
    roll_up = roll_sched & (age == k2.rolling_down)

    restart_draw, w_restart = blk.bern_w(k2.p_restart, (n,))
    restart = (~s.alive) & ((restart_draw & ~roll_down) | roll_up)
    crash_draw, w_crash = blk.bern_w(k2.p_crash, (n,))
    crash_bern = s.alive & crash_draw
    dead_after_restart = ((~s.alive) & (~restart)).sum(-1, dtype=I32)
    budget = kn.max_dead - dead_after_restart
    crash = (crash_bern & (torch.cumsum(crash_bern.to(I32), -1, dtype=I32)
                           <= budget[:, None])) | (s.alive & roll_down)
    alive = (s.alive | restart) & ~crash

    role = torch.where(restart, FOLLOWER, s.role)
    if cfg.bug == "forget_voted_for":
        s = s._replace(voted_for=torch.where(restart, -1, s.voted_for))
    rst_tmr, w_rst_tmr = blk.randint_w(k2.eto_min, k2.eto_max + 1, (n,))
    timer = torch.where(restart, rst_tmr + skew, s.timer)
    hb = torch.where(restart, 0, s.hb)
    commit = torch.where(restart, s.base, s.commit)
    compact_floor = torch.where(restart, s.base, s.compact_floor)
    votes = torch.where(cols(restart), False, s.votes)
    next_idx = torch.where(cols(restart), 1, s.next_idx)
    match_idx = torch.where(cols(restart), 0, s.match_idx)

    # limping nodes: draws ride the free low bytes of the words above
    limp_on = alive & (k2.limp_mult_max >= 2) & _bern8(w_crash, k2.p_limp)
    limp_mult = _randint8(w_restart, 2, k2.limp_mult_max - 1)
    limp = torch.where(
        restart, 1,
        torch.where(
            limp_on, limp_mult,
            torch.where(_bern8(w_rst_tmr, k2.p_limp_heal), 1, s.limp),
        ),
    )

    # partition schedule: one mutually exclusive event per tick
    u_part = blk.uniform(())
    w_colors = blk._take((n,))
    colors = _DrawBlock._u01(w_colors) < 0.5
    asym_dst = blk.randint(0, n, ())
    asym_off = blk.randint(1, n, ())
    part_adj = cols(colors) == rows(colors)
    th1 = kn.p_repartition
    th2 = th1 + kn.p_heal
    th3 = th2 + kn.p_leader_part
    th4 = th3 + kn.p_asym_cut
    do_part = u_part < th1
    do_heal = (~do_part) & (u_part < th2)
    lead_pre = alive & (s.role == LEADER)
    lid = _first_true(lead_pre, me)  # first live leader (0 if none)
    lcol = (me == lid[:, None]) | (me == ((lid + 1) % n)[:, None])
    lpart_adj = cols(lcol) == rows(lcol)
    do_lpart = (u_part >= th2) & (u_part < th3) & lead_pre.any(-1)
    do_asym = (u_part >= th3) & (u_part < th4)
    cut = ((me[:, None] == asym_dst[:, None, None])
           & (me[None, :] == ((asym_dst + asym_off) % n)[:, None, None]))
    adj = (
        torch.where(
            do_part[:, None, None], part_adj,
            torch.where(
                do_heal[:, None, None], True,
                torch.where(do_lpart[:, None, None], lpart_adj,
                            s.adj & ~(cut & do_asym[:, None, None])),
            ),
        )
        | eye
    )

    # lossy persistence: a crash may drop the un-fsynced suffix
    lose = crash & (_bern8(w_colors, k2.p_lose_unsynced))
    term = torch.where(lose, s.durable_term, s.term)
    voted_for = torch.where(lose, s.durable_voted_for, s.voted_for)
    log_len = torch.where(lose, s.durable_len, s.log_len)

    log_term, log_val = s.log_term, s.log_val
    log_tick = s.log_tick  # metrics: submit stamps ride with the log
    base, snap_term, prefix_hash = s.base, s.snap_term, s.prefix_hash
    durable_len = s.durable_len
    durable_term, durable_voted_for = s.durable_term, s.durable_voted_for
    rv_rsp_t, rv_rsp_term, rv_rsp_granted = s.rv_rsp_t, s.rv_rsp_term, s.rv_rsp_granted
    ae_rsp_t, ae_rsp_term = s.ae_rsp_t, s.ae_rsp_term
    ae_rsp_success, ae_rsp_match = s.ae_rsp_success, s.ae_rsp_match
    delivered = torch.zeros_like(s.msg_count)
    snap_installed_src = torch.full_like(s.snap_installed_src, -1)
    snap_installed_len = torch.zeros_like(s.snap_installed_len)
    snap_install_count = s.snap_install_count

    p_src = (me + t1) % n  # round-robin priority per src, [B, n]

    def pick_one(mail_t, extra_ok=True):
        """-> (pick [B, dst, src] one-hot, deferred mask, due)."""
        due = (mail_t == t2) & cols(alive)
        ok = due & adj & extra_ok
        pmask = torch.where(ok, rows(p_src), n)
        pick = ok & (rows(p_src) == pmask.amin(-1)[:, :, None])
        return pick, ok & ~pick, due

    def picked(pick, field):
        """field value of the picked source per dst (0 where none)."""
        return torch.where(pick, field, 0).sum(-1, dtype=I32)

    def count(pick):
        return pick.sum((-2, -1), dtype=I32)

    # ---------------------------------------------------- deliver: RV responses
    pick, defer, due = pick_one(rv_rsp_t)
    stale = rv_rsp_t <= t2
    rv_rsp_t = torch.where(defer, t2 + 1, torch.where(stale, 0, rv_rsp_t))
    got = pick.any(-1)
    d_rv_rsp = count(pick)
    delivered = delivered + d_rv_rsp
    mterm = picked(pick, rv_rsp_term)
    higher = got & (mterm > term)
    term = torch.where(higher, mterm, term)
    role = torch.where(higher, FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    accept = (
        got & (pick & rv_rsp_granted).any(-1)
        & (role == CANDIDATE) & (mterm == term)
    )
    votes = votes | (pick & cols(accept))

    # ---------------------------------------------------- deliver: AE responses
    pick, defer, due = pick_one(ae_rsp_t)
    stale = ae_rsp_t <= t2
    ae_rsp_t = torch.where(defer, t2 + 1, torch.where(stale, 0, ae_rsp_t))
    got = pick.any(-1)
    d_ae_rsp = count(pick)
    delivered = delivered + d_ae_rsp
    mterm = picked(pick, ae_rsp_term)
    higher = got & (mterm > term)
    term = torch.where(higher, mterm, term)
    role = torch.where(higher, FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    okl = got & (role == LEADER) & (mterm == term)
    succ_flag = (pick & ae_rsp_success).any(-1)
    succ = okl & succ_flag
    fail = okl & ~succ_flag
    m = cols(picked(pick, ae_rsp_match))
    match_idx = torch.where(
        pick & cols(succ), torch.maximum(match_idx, m), match_idx)
    next_idx = torch.where(
        pick & cols(succ),
        torch.maximum(next_idx, m + 1),
        torch.where(
            pick & cols(fail),
            torch.clamp(torch.minimum(next_idx, m + 1), min=1),
            next_idx,
        ),
    )

    # ------------------------------------------- deliver: install-snapshot
    pick, defer, due = pick_one(s.sn_req_t, extra_ok=rows(alive))
    sn_req_t = torch.where((s.sn_req_t == t2) & ~defer, 0, s.sn_req_t)
    sn_req_t = torch.where(defer, t2 + 1, sn_req_t)
    got = pick.any(-1)
    d_sn = count(pick)
    delivered = delivered + d_sn
    mterm = picked(pick, s.sn_req_term)
    higher = got & (mterm > term)
    term = torch.where(higher, mterm, term)
    role = torch.where(higher, FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    acc = got & (mterm == term)
    role = torch.where(acc & (role == CANDIDATE), FOLLOWER, role)
    snap_tmr, w_snap_tmr = blk.randint_w(k2.eto_min, k2.eto_max + 1, (n,))
    timer = torch.where(acc, snap_tmr + skew, timer)
    slen = picked(pick, rows(s.base))
    sterm_snap = picked(pick, rows(s.snap_term))
    inst = acc & (slen > commit)
    keep = inst & (log_len > slen) & (
        _term_at(log_term, snap_term, base, slen, cap) == sterm_snap
    )
    log_len = torch.where(inst, torch.where(keep, log_len, slen), log_len)
    base = torch.where(inst, slen, base)
    snap_term = torch.where(inst, sterm_snap, snap_term)
    prefix_hash = torch.where(inst, picked(pick, rows(s.prefix_hash)), prefix_hash)
    commit = torch.where(inst, torch.maximum(commit, slen), commit)
    compact_floor = torch.where(inst, slen, compact_floor)
    durable_len = torch.where(inst, log_len, durable_len)
    durable_term = torch.where(inst, term, durable_term)
    durable_voted_for = torch.where(inst, voted_for, durable_voted_for)
    src_id = picked(pick, me)
    snap_installed_src = torch.where(inst, src_id, snap_installed_src)
    snap_installed_len = torch.where(inst, slen, snap_installed_len)
    snap_install_count = snap_install_count + inst.sum(-1, dtype=I32)

    # absolute index held by each lane; base is stable until compaction
    abs_arr = lane_abs(base, cap)  # [B, n, cap]

    # ----------------------------------------------------- deliver: RV requests
    pick, defer, due = pick_one(s.rv_req_t)
    rv_req_t = torch.where((s.rv_req_t == t2) & ~defer, 0, s.rv_req_t)
    rv_req_t = torch.where(defer, t2 + 1, rv_req_t)
    got = pick.any(-1)
    d_rv_req = count(pick)
    delivered = delivered + d_rv_req
    mterm = picked(pick, s.rv_req_term)
    higher = got & (mterm > term)
    term = torch.where(higher, mterm, term)
    role = torch.where(higher, FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    my_llt = torch.where(
        log_len > base, _row_gather(log_term, _slot(log_len, cap), cap), snap_term
    )
    cand_llt = picked(pick, s.rv_req_llt)
    cand_lli = picked(pick, s.rv_req_lli)
    log_ok = (cand_llt > my_llt) | ((cand_llt == my_llt) & (cand_lli >= log_len))
    if cfg.bug == "grant_any_vote":
        log_ok = torch.ones_like(log_ok)
    src_id = picked(pick, me)
    grant = got & (mterm == term) & (
        (voted_for == -1) | (voted_for == src_id)
    ) & log_ok
    voted_for = torch.where(grant, src_id, voted_for)
    grant_tmr, w_grant_tmr = blk.randint_w(k2.eto_min, k2.eto_max + 1, (n,))
    timer = torch.where(grant, grant_tmr + skew, timer)
    if cfg.bug != "ack_before_fsync":
        durable_term = torch.where(got, term, durable_term)
        durable_voted_for = torch.where(got, voted_for, durable_voted_for)
        durable_len = torch.where(got, log_len, durable_len)
    delay, lost = _net_draws(k2, blk, (n,))
    delay = delay * limp
    send = got & ~lost
    resp = pick.transpose(-1, -2) & rows(send)  # slot [candidate, voter]
    rv_rsp_t = torch.where(resp, rows(t1 + delay), rv_rsp_t)
    rv_rsp_term = torch.where(resp, rows(term), rv_rsp_term)
    rv_rsp_granted = torch.where(resp, rows(grant), rv_rsp_granted)

    # ----------------------------------------------------- deliver: AE requests
    pick, defer, due = pick_one(s.ae_req_t)
    ae_req_t = torch.where((s.ae_req_t == t2) & ~defer, 0, s.ae_req_t)
    ae_req_t = torch.where(defer, t2 + 1, ae_req_t)
    got = pick.any(-1)
    d_ae_req = count(pick)
    delivered = delivered + d_ae_req
    mterm = picked(pick, s.ae_req_term)
    higher = got & (mterm > term)
    term = torch.where(higher, mterm, term)
    role = torch.where(higher, FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    acc = got & (mterm == term)
    role = torch.where(acc & (role == CANDIDATE), FOLLOWER, role)
    timer = torch.where(acc, _timeout_draw(k2, blk, (n,), skew), timer)
    prev = picked(pick, s.ae_req_prev)
    mprev_term = picked(pick, s.ae_req_prev_term)
    prev_ok = (prev <= log_len) & (
        (prev <= base)
        | (_term_at(log_term, snap_term, base, prev, cap) == mprev_term)
    )
    success = acc & prev_ok
    # the picked sender's log, base and length at delivery
    pick4 = pick[..., None]
    plog_t = torch.where(pick4, log_term[:, None], 0).sum(-2, dtype=I32)
    plog_v = torch.where(pick4, log_val[:, None], 0).sum(-2, dtype=I32)
    psrc_base = picked(pick, rows(base))
    psrc_len = picked(pick, rows(log_len))
    psrc_snap_term = picked(pick, rows(snap_term))
    cur_prev_term = torch.where(
        prev == psrc_base,
        psrc_snap_term,
        torch.where(lane == _slot(prev, cap)[..., None], plog_t, 0).sum(-1, dtype=I32),
    )
    prev_still = (
        (psrc_base <= prev) & (prev <= psrc_len) & (cur_prev_term == mprev_term)
    )
    nent = torch.where(
        prev_still,
        torch.clamp(torch.minimum(picked(pick, s.ae_req_n), psrc_len - prev), 0, ae_max),
        0,
    )
    e_ar = torch.arange(ae_max, dtype=I32, device=dev)
    abs_e = prev[..., None] + e_ar + 1  # [B, n, e]
    in_batch = (
        success[..., None] & (e_ar < nent[..., None])
        & (abs_e > base[..., None]) & (abs_e <= (base + cap)[..., None])
    )
    if cfg.bug == "no_truncate":
        in_batch = in_batch & (abs_e > log_len[..., None])
    slot_oh = lane == _slot(abs_e, cap)[..., None]  # [B, n, e, cap]
    ent_t = torch.where(slot_oh, plog_t[:, :, None, :], 0).sum(-1, dtype=I32)
    ent_v = torch.where(slot_oh, plog_v[:, :, None, :], 0).sum(-1, dtype=I32)
    old_t = torch.where(slot_oh, log_term[:, :, None, :], 0).sum(-1, dtype=I32)
    conf_e = in_batch & (abs_e <= log_len[..., None]) & (old_t != ent_t)
    conflict_any = conf_e.any(-1)
    first_conf = torch.where(conf_e, abs_e, _BIG).amin(-1)
    durable_len = torch.where(
        conflict_any, torch.minimum(durable_len, first_conf - 1), durable_len
    )
    hit = in_batch[..., None] & slot_oh  # [B, n, e, cap]
    any_hit = hit.any(-2)
    log_term = torch.where(
        any_hit, torch.where(hit, ent_t[..., None], 0).sum(-2, dtype=I32), log_term
    )
    log_val = torch.where(
        any_hit, torch.where(hit, ent_v[..., None], 0).sum(-2, dtype=I32), log_val
    )
    if metrics:
        # the submit stamp replicates with the entry: the picked sender's
        # stamp ring at delivery, through the payload's own one-hots
        plog_s = torch.where(pick4, log_tick[:, None], 0).sum(-2, dtype=I32)
        ent_s = torch.where(slot_oh, plog_s[:, :, None, :], 0).sum(-1, dtype=I32)
        log_tick = torch.where(
            any_hit, torch.where(hit, ent_s[..., None], 0).sum(-2, dtype=I32),
            log_tick)
    batch_end = torch.minimum(prev + nent, base + cap)  # ring overflow: drop tail
    log_len = torch.where(
        success,
        torch.where(conflict_any, batch_end, torch.maximum(log_len, batch_end)),
        log_len,
    )
    commit = torch.where(
        success,
        torch.maximum(
            commit, torch.minimum(picked(pick, s.ae_req_commit), batch_end)
        ),
        commit,
    )
    # failure hint for fast backtracking (term skip)
    over = prev > log_len
    conf_term = _term_at(log_term, snap_term, base, prev, cap)
    cand = (abs_arr <= log_len[..., None]) & (log_term == conf_term[..., None])
    first_abs = torch.where(cand, abs_arr, _BIG).amin(-1)
    has_cand = cand.any(-1)
    hint = torch.where(
        over, log_len,
        torch.maximum(torch.where(has_cand, first_abs - 1, base), base),
    )
    rsp_match = torch.where(success, batch_end, hint)
    if cfg.bug != "ack_before_fsync":
        durable_len = torch.where(got, log_len, durable_len)
        durable_term = torch.where(got, term, durable_term)
        durable_voted_for = torch.where(got, voted_for, durable_voted_for)
    delay, lost = _net_draws(k2, blk, (n,))
    delay = delay * limp
    send = got & ~lost
    # keep-oldest: an occupied response slot keeps its message
    resp = pick.transpose(-1, -2) & rows(send) & (ae_rsp_t == 0)
    ae_rsp_t = torch.where(resp, rows(t1 + delay), ae_rsp_t)
    ae_rsp_term = torch.where(resp, rows(term), ae_rsp_term)
    ae_rsp_success = torch.where(resp, rows(success), ae_rsp_success)
    ae_rsp_match = torch.where(resp, rows(rsp_match), ae_rsp_match)

    # candidate -> leader on majority, with a current-term no-op
    win = alive & (role == CANDIDATE) & (votes.sum(-1, dtype=I32) >= k2.majority)
    role = torch.where(win, LEADER, role)
    next_idx = torch.where(cols(win), cols(log_len + 1), next_idx)
    match_idx = torch.where(cols(win), 0, match_idx)
    hb = torch.where(win, 0, hb)
    nop = win & (log_len - base < cap)
    nop_hit = cols(nop) & (lane == _slot(log_len + 1, cap)[..., None])
    log_term = torch.where(nop_hit, cols(term), log_term)
    log_val = torch.where(nop_hit, NOOP_CMD, log_val)
    if metrics:  # a no-op is not a client op: stamp 0
        log_tick = torch.where(nop_hit, 0, log_tick)
    log_len = torch.where(nop, log_len + 1, log_len)
    durable_len = torch.where(nop, log_len, durable_len)

    # ------------------------------------------------- timers: election timeout
    running = alive & (role != LEADER)
    timer = torch.where(running, timer - 1, timer)
    fired = running & (timer <= 0)
    term = torch.where(fired, term + 1, term)
    role = torch.where(fired, CANDIDATE, role)
    voted_for = torch.where(fired, me, voted_for)
    votes = torch.where(cols(fired), eye, votes)
    timer = torch.where(fired, _timeout_draw(k2, blk, (n,), skew), timer)
    durable_term = torch.where(fired, term, durable_term)
    durable_voted_for = torch.where(fired, voted_for, durable_voted_for)
    durable_len = torch.where(fired, log_len, durable_len)

    llt = torch.where(
        log_len > base, _row_gather(log_term, _slot(log_len, cap), cap), snap_term
    )
    delay, lost = _net_draws(k3, blk, (n, n))
    delay = delay * rows(limp)  # src is the column axis
    send_rv = rows(fired) & ~eye & adj & ~lost  # [dst, src]
    rv_req_t = torch.where(send_rv, t2 + delay, rv_req_t)
    rv_req_term = torch.where(send_rv, rows(term), s.rv_req_term)
    rv_req_lli = torch.where(send_rv, rows(log_len), s.rv_req_lli)
    rv_req_llt = torch.where(send_rv, rows(llt), s.rv_req_llt)

    # --------------------------------------- client command injection at leaders
    lead = alive & (role == LEADER)
    inject = (
        lead & blk.bern(k2.p_client_cmd, (n,))
        & (log_len - base < cap)
        & (log_len - commit < k2.flow_cap)
    )
    cmd_val = s.next_cmd[:, None] * n + me + 1
    inj_hit = cols(inject) & (lane == _slot(log_len + 1, cap)[..., None])
    log_term = torch.where(inj_hit, cols(term), log_term)
    log_val = torch.where(inj_hit, cols(cmd_val), log_val)
    if metrics:  # the submit stamp: the tick the command entered
        log_tick = torch.where(inj_hit, t2, log_tick)
    log_len = torch.where(inject, log_len + 1, log_len)
    durable_len = torch.where(inject, log_len, durable_len)
    next_cmd = s.next_cmd + inject.any(-1).to(I32)

    # -------------------------------------------- leader heartbeat / replication
    hb = torch.where(lead, hb - 1, hb)
    fire_hb = lead & (hb <= 0)
    hb = torch.where(fire_hb, k2.heartbeat_ticks, hb)
    next_t = next_idx.transpose(-1, -2)  # [dst, src]
    need_snap = next_t <= rows(base)
    prev_m = next_t - 1
    n_m = torch.clamp(rows(log_len) - prev_m, 0, ae_max)
    oh_p = lane == _slot(prev_m, cap)[..., None]
    prev_term_m = torch.where(
        prev_m > rows(base),
        torch.where(oh_p, log_term[:, None], 0).sum(-1, dtype=I32),
        rows(snap_term),
    )
    delay, lost = _net_draws(k3, blk, (n, n))
    delay = delay * rows(limp)
    pending = rows(lead) & (next_t <= rows(log_len))
    send_ae = (
        (rows(fire_hb) | pending) & ~eye & adj & ~lost & ~need_snap
        & (ae_req_t == 0)
    )
    ae_req_t = torch.where(send_ae, t2 + delay, ae_req_t)
    ae_req_term = torch.where(send_ae, rows(term), s.ae_req_term)
    ae_req_prev = torch.where(send_ae, prev_m, s.ae_req_prev)
    ae_req_prev_term = torch.where(send_ae, prev_term_m, s.ae_req_prev_term)
    ae_req_n = torch.where(send_ae, n_m, s.ae_req_n)
    ae_req_commit = torch.where(send_ae, rows(commit), s.ae_req_commit)
    delay_sn, lost_sn = _net_draws(k3, blk, (n, n))
    delay_sn = delay_sn * rows(limp)
    send_sn = (
        rows(fire_hb) & ~eye & adj & ~lost_sn & need_snap & (sn_req_t == 0)
    )
    sn_req_t = torch.where(send_sn, t2 + delay_sn, sn_req_t)
    sn_req_term = torch.where(send_sn, rows(term), s.sn_req_term)
    next_idx = torch.where(send_sn.transpose(-1, -2), cols(base + 1), next_idx)

    # ------------------------------------------------------------ commit advance
    mi = torch.where(eye, cols(log_len), match_idx)
    srt = torch.sort(mi, dim=-1, descending=True).values
    kth_at = torch.clamp(kn.majority - 1, 0, n - 1).to(torch.int64)
    if kth_at.dim():  # one quorum a cluster: gather each row's own rank
        kth = srt.gather(-1, kth_at.view(-1, 1, 1).expand(-1, n, 1))[..., 0]
    else:
        kth = torch.index_select(srt, -1, kth_at.reshape(1))[..., 0]
    cur_term_ok = (kth > base) & (
        _term_at(log_term, snap_term, base, kth, cap) == term
    )
    if cfg.bug == "commit_any_term":
        cur_term_ok = kth > base
    commit = torch.where(lead & cur_term_ok, torch.maximum(commit, kth), commit)

    # ------------------------------------------------------------------- oracle
    (_, shadow_term, shadow_val, shadow_base, shadow_len, shadow_prefix_hash,
     violations, first_violation_tick, first_leader_tick, *shadow_sub) = oracle(
        alive, role, term, log_term, log_val, log_len, base, commit,
        prefix_hash, s.shadow_term, s.shadow_val, s.shadow_base,
        s.shadow_len, s.shadow_prefix_hash, s.violations,
        s.first_violation_tick, s.first_leader_tick, t,
        **({"log_tick": log_tick} if metrics else {}))
    metric_leaves = {}
    if metrics:
        # the commit-latency fold: an injected command's ack is the tick the
        # shadow first records it; no-ops carry stamp 0 and are skipped. Its
        # whole latency is the replicate phase (born at a leader, acked at
        # commit), the other rows fold zeros
        shadow_sub = shadow_sub[0]
        lats = t1 - shadow_sub
        zeros = torch.zeros_like(lats)
        phases = torch.stack([lats if name == "replicate" else zeros
                              for name in LATENCY_PHASES], dim=1)
        none = torch.full_like(lats, -1)
        lat_hist, phase_hist, phase_ticks, lat_ticks, worst = K4.latency_fold(
            lats, shadow_sub > 0, phases, none, none, shadow_sub, s.lat_hist,
            s.phase_hist, s.phase_ticks, s.lat_ticks,
            (s.worst_lat, s.worst_phases, s.worst_key, s.worst_client,
             s.worst_sub))
        metric_leaves = dict(
            log_tick=log_tick, shadow_sub=shadow_sub, lat_hist=lat_hist,
            phase_hist=phase_hist, phase_ticks=phase_ticks,
            lat_ticks=lat_ticks, worst_lat=worst[0], worst_phases=worst[1],
            worst_key=worst[2], worst_client=worst[3], worst_sub=worst[4])

    # -------------------------------------------------------------- compaction
    boundary = torch.where(
        k2.compact_at_commit, commit, torch.minimum(compact_floor, commit)
    )
    do_compact = alive & (boundary - base >= k2.compact_every)
    new_snap_term = _term_at(log_term, snap_term, base, boundary, cap)
    out_lanes = cols(do_compact) & (abs_arr <= cols(boundary))
    prefix_hash = prefix_hash ^ xor_reduce(
        torch.where(out_lanes, entry_mix(log_term, log_val, abs_arr), 0)
    )
    snap_term = torch.where(do_compact, new_snap_term, snap_term)
    base = torch.where(do_compact, boundary, base)
    durable_len = torch.where(
        do_compact, torch.maximum(durable_len, boundary), durable_len
    )

    # ------------------------------------------------------- background fsync
    stall_on = (
        alive & (k2.fsync_stall_ticks >= 1)
        & _bern8(w_snap_tmr, k2.p_fsync_stall)
    )
    fsync_stall = torch.where(
        restart, 0,
        torch.where(
            stall_on, _randint8(w_grant_tmr, 1, k2.fsync_stall_ticks),
            torch.clamp(s.fsync_stall - 1, min=0),
        ),
    )
    do_fsync = alive & ((t1 + me) % k2.fsync_every == 0) & (fsync_stall == 0)
    durable_len = torch.where(do_fsync, log_len, durable_len)
    durable_term = torch.where(do_fsync, term, durable_term)
    durable_voted_for = torch.where(do_fsync, voted_for, durable_voted_for)

    if metrics:  # one increment per node per event per tick
        metric_leaves["ev_counts"] = s.ev_counts + torch.stack([
            win.sum(-1, dtype=I32),                  # elections_won
            (term > term0).sum(-1, dtype=I32),       # term_bumps
            crash.sum(-1, dtype=I32),                # crashes
            restart.sum(-1, dtype=I32),              # restarts
            d_rv_req, d_rv_rsp, d_ae_req, d_ae_rsp, d_sn,
            (commit > commit0).sum(-1, dtype=I32),   # commit_advances
        ], dim=1)

    return s._replace(
        tick=t,
        term=term, voted_for=voted_for, role=role, timer=timer, hb=hb, alive=alive,
        limp=limp, fsync_stall=fsync_stall,
        log_term=log_term, log_val=log_val, log_len=log_len,
        base=base, snap_term=snap_term, prefix_hash=prefix_hash,
        commit=commit, compact_floor=compact_floor,
        durable_len=durable_len, durable_term=durable_term,
        durable_voted_for=durable_voted_for,
        votes=votes, next_idx=next_idx, match_idx=match_idx, adj=adj,
        rv_req_t=rv_req_t, rv_req_term=rv_req_term,
        rv_req_lli=rv_req_lli, rv_req_llt=rv_req_llt,
        rv_rsp_t=rv_rsp_t, rv_rsp_term=rv_rsp_term, rv_rsp_granted=rv_rsp_granted,
        ae_req_t=ae_req_t, ae_req_term=ae_req_term, ae_req_prev=ae_req_prev,
        ae_req_prev_term=ae_req_prev_term, ae_req_n=ae_req_n,
        ae_req_commit=ae_req_commit,
        ae_rsp_t=ae_rsp_t, ae_rsp_term=ae_rsp_term,
        ae_rsp_success=ae_rsp_success, ae_rsp_match=ae_rsp_match,
        sn_req_t=sn_req_t, sn_req_term=sn_req_term,
        snap_installed_src=snap_installed_src,
        snap_installed_len=snap_installed_len,
        next_cmd=next_cmd,
        shadow_term=shadow_term, shadow_val=shadow_val,
        shadow_base=shadow_base, shadow_len=shadow_len,
        shadow_prefix_hash=shadow_prefix_hash,
        violations=violations, first_violation_tick=first_violation_tick,
        first_leader_tick=first_leader_tick,
        msg_count=s.msg_count + delivered,
        snap_install_count=snap_install_count,
        **metric_leaves,
    )
