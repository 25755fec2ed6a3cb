"""The shard-controller (4A) service layer on top of the raft tick: the
replicated config service, its clerks, the truth walker and the four
controller oracles for a batch of clusters, the twin of the reference's
``madraft_tpu/tpusim/ctrler.py`` (whose module docstring explains the
model: Join / Leave / Move / Query, the closed-form canonical rebalance
and the oracles CTRL_DIVERGE, CTRL_BALANCE, CTRL_MINIMAL and CTRL_QUERY).

A ctrler tick is the raft tick, then the service tick
(``_ctrler_service_tick``). On the card (``engine.tick_route``) both run
inside one launch of K6-ctrler for up to ``engine.KERNEL_CHUNK`` ticks
(``kernels.ctrler.ctrler_chunk``: kernel K6 with the service tick after
each raft tick on the same tile; with the metrics plane on,
K6-metrics-ctrler, which folds the clerks' latencies and phases inside
the kernel). On the CPU, or with ``tick="eager"``, the raft tick is
``step.step_cluster`` and the service tick this module's
``_ctrler_service_tick``, the plain version of K10
(``kernels.ctrler.ctrler_tick``, the per-tick kernel K6-ctrler is held
against).

Batch-first like the rest of the port: a reference leaf ``[NC]`` is
``[B, NC]`` here, ``[N, NG]`` is ``[B, N, NG]`` and a scalar leaf is
``[B]``. Every knob of ``CtrlerKnobs`` (and of the raft ``Knobs``) is 0-d,
one value for the batch, or a ``[B]`` row, one value a cluster
(``make_ctrler_sweep_fn``).

The reference's packed controller carry (``ctrler_packed_layout`` ..
``ctrler_step_packed``) is not ported: it changes no report bit, and the
port ticks the wide state (``"state_layout": "wide"`` in the telemetry).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import ctrler as K10
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels.oracle import lane_abs
from madraft_tpu_torch.tpusim import metrics as _m
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    LEADER,
    NOOP_CMD,
    Knobs,
    SimConfig,
    check_service_cfg,
    lane_view,
)
from madraft_tpu_torch.tpusim.kv import _wrap_i32
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    durable_after_append,
    init_cluster,
    service_state_from_numpy,
    service_state_to_numpy,
)
from madraft_tpu_torch.tpusim.step import _row_gather, _slot, step_cluster

I32 = torch.int32
F32 = torch.float32
BOOL = torch.bool

# The controller oracles' violation bits (beside config's and kv's)
VIOLATION_CTRL_DIVERGE = 2048   # replicas disagree at equal apply cursors
VIOLATION_CTRL_BALANCE = 4096   # a Join/Leave config is unbalanced or orphans a shard
VIOLATION_CTRL_MINIMAL = 8192   # a Join/Leave moved more shards than necessary
VIOLATION_CTRL_QUERY = 16384    # a Query observed a config != the history's truth

N_SHARDS = 10     # the reference's N_SHARDS
_SEQ_LIM = 1 << 10  # the op packing's seq field: 10 bits
_BIG = 1 << 30

_JOIN, _LEAVE, _MOVE, _QUERY = 0, 1, 2, 3  # op kinds

# PRNG sites (fold_in data under the tick's key), as the reference's
_S_CLERK_START, _S_CLERK_KIND = 24, 27

_HASH_W = 1000003
# W^(NS-s) mod 2^32 as wrapping int32 values: the config hash is the
# vectorised form of the Horner fold h = ((bits+1)*W + o_0)*W + o_1 ...
_HASH_POW = np.array(
    [pow(_HASH_W, N_SHARDS - s, 1 << 32) for s in range(N_SHARDS + 1)],
    dtype=np.uint64,
).astype(np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True)
class CtrlerConfig:
    """Knobs of the 4A layer, field for field the reference's
    ``CtrlerConfig`` (its comments explain each): ``n_gids`` /
    ``n_clients`` / ``n_configs`` / ``join_max`` / ``apply_max`` /
    ``walk_max`` shape the run, the rest are dynamic ``CtrlerKnobs``."""

    n_gids: int = 5
    n_clients: int = 4
    n_configs: int = 24
    join_max: int = 3
    p_op: float = 0.3
    p_query: float = 0.3
    p_move: float = 0.1
    p_retry: float = 0.5
    apply_max: int = 4
    walk_max: int = 6
    bug_rotate_tiebreak: bool = False
    bug_greedy_rebalance: bool = False
    bug_full_reshuffle: bool = False

    def __post_init__(self):
        if self.p_query + self.p_move > 1.0:
            raise ValueError(
                f"p_query ({self.p_query}) + p_move ({self.p_move}) must stay "
                "<= 1 (one uniform draw splits Query/Move/Join-Leave)"
            )
        if self.n_gids < 2 or self.n_gids > N_SHARDS:
            raise ValueError(f"n_gids must be in [2, {N_SHARDS}], got {self.n_gids}")
        if self.join_max < 1 or self.join_max > self.n_gids:
            raise ValueError(
                f"join_max must be in [1, n_gids={self.n_gids}], "
                f"got {self.join_max}"
            )
        top = _pack(self, self.n_clients - 1, _SEQ_LIM - 1, self._arg_lim - 1,
                    _QUERY)
        if top >= NOOP_CMD:
            raise ValueError(
                f"n_clients ({self.n_clients}) x arg space ({self._arg_lim}) "
                f"overflow the op packing (max {top} >= NOOP_CMD {NOOP_CMD})"
            )

    @property
    def _arg_lim(self) -> int:
        # gid-set bitmask | shard*NG+gid | config num (+1 for "latest")
        return max(1 << self.n_gids, N_SHARDS * self.n_gids,
                   self.n_configs + 1)

    def replace(self, **kw) -> "CtrlerConfig":
        return dataclasses.replace(self, **kw)

    def knobs(self, device=None) -> "CtrlerKnobs":
        """The dynamic knobs as 0-d tensors on ``device`` (CPU if None)."""
        def f32(v):
            return torch.tensor(v, dtype=F32, device=device)

        def b(v):
            return torch.tensor(v, dtype=BOOL, device=device)

        return CtrlerKnobs(
            p_op=f32(self.p_op), p_query=f32(self.p_query),
            p_move=f32(self.p_move), p_retry=f32(self.p_retry),
            bug_rotate_tiebreak=b(self.bug_rotate_tiebreak),
            bug_greedy_rebalance=b(self.bug_greedy_rebalance),
            bug_full_reshuffle=b(self.bug_full_reshuffle),
        )

    def static_key(self) -> "CtrlerConfig":
        return CtrlerConfig(
            n_gids=self.n_gids, n_clients=self.n_clients,
            n_configs=self.n_configs, join_max=self.join_max,
            apply_max=self.apply_max, walk_max=self.walk_max,
        )


class CtrlerKnobs(NamedTuple):
    """The 4A layer's dynamic knobs (see CtrlerConfig): float32
    probabilities and bool bugs, each 0-d or a [B] row."""

    p_op: torch.Tensor
    p_query: torch.Tensor
    p_move: torch.Tensor
    p_retry: torch.Tensor
    bug_rotate_tiebreak: torch.Tensor
    bug_greedy_rebalance: torch.Tensor
    bug_full_reshuffle: torch.Tensor

    def to(self, device) -> "CtrlerKnobs":
        return CtrlerKnobs(*(x.to(device) for x in self))

    def lanes(self, ndim: int) -> "CtrlerKnobs":
        """Each field against a [B, ...] operand of ``ndim`` dims
        (``config.lane_view``)."""
        return CtrlerKnobs(*(lane_view(x, ndim) for x in self))

    def broadcast(self, n_clusters: int) -> "CtrlerKnobs":
        """Per-cluster rows: every field ``[n_clusters]``."""
        return CtrlerKnobs(*(x.expand(n_clusters).clone() for x in self))


def _pack(cfg: CtrlerConfig, client, seq, arg, kind):
    return (((client * _SEQ_LIM + seq) * cfg._arg_lim + arg) * 4 + kind) + 1


def _unpack(cfg: CtrlerConfig, val):
    """(client, seq, arg, kind) of packed ops: floor division and modulo,
    as the reference's ``//`` and ``%`` (an empty slot's 0 gives kind 3,
    arg ``arg_lim - 1`` and client -1, which the callers clip)."""
    v = val - 1
    kind = torch.remainder(v, 4)
    v = torch.div(v, 4, rounding_mode="floor")
    arg = torch.remainder(v, cfg._arg_lim)
    cs = torch.div(v, cfg._arg_lim, rounding_mode="floor")
    return (torch.div(cs, _SEQ_LIM, rounding_mode="floor"),
            torch.remainder(cs, _SEQ_LIM), arg, kind)


def _counts(owner: torch.Tensor, ng: int) -> torch.Tensor:
    """Per-group shard loads [..., NG] of owner [..., NS]."""
    gid = torch.arange(ng, dtype=I32, device=owner.device)
    return (owner[..., None, :] == gid[:, None]).sum(-1, dtype=I32)


def _retained_targets(ng: int, member, owner_oh, valid):
    """Retained loads and balanced targets [..., NG] (ceil targets to the
    r biggest retainers, ties by lowest gid), the one ranking
    ``_rebalance`` and ``_min_moves`` share. member [..., NG], owner_oh
    [..., NS, NG], valid [..., NS]."""
    gid = torch.arange(ng, dtype=I32, device=member.device)
    k = member.sum(-1, dtype=I32)
    ksafe = torch.clamp(k, min=1)
    retained = (owner_oh & valid[..., None]).sum(-2, dtype=I32)
    q = torch.div(N_SHARDS, ksafe, rounding_mode="floor")
    r = torch.remainder(N_SHARDS, ksafe)
    sort_key = torch.where(member, (N_SHARDS - retained) * ng + gid, _BIG)
    rank = (sort_key[..., None, :] < sort_key[..., :, None]).sum(-1, dtype=I32)
    target = torch.where(member, q[..., None] + (rank < r[..., None]).to(I32),
                         0)
    return retained, target


def _rebalance(ng: int, member, owner, tie_rot, greedy, reshuffle):
    """The canonical deterministic rebalance in closed form (the
    reference's ``_rebalance`` docstring states the four steps), batched:
    member [..., NG] bool, owner [..., NS] (-1 = unowned), tie_rot /
    greedy / reshuffle [...] or 0-d. Returns the new owner [..., NS]."""
    dev = member.device
    gid = torch.arange(ng, dtype=I32, device=dev)
    sid = torch.arange(N_SHARDS, dtype=I32, device=dev)
    k = member.sum(-1, dtype=I32)
    ksafe = torch.clamp(k, min=1)
    owner_oh = owner[..., :, None] == gid  # [..., NS, NG]; -1 matches nothing
    valid = (owner_oh & member[..., None, :]).any(-1)
    own0 = torch.where(valid, owner, -1)
    own0_oh = owner_oh & valid[..., None]
    retained, target = _retained_targets(ng, member, owner_oh, valid)
    keep_g = torch.minimum(retained, target)
    need_g = target - keep_g

    # the keep set: shard s stays iff its ordinal among its group's shards
    # is below keep_g[owner(s)]
    own_eq = ((own0[..., None, :] == own0[..., :, None])
              & (own0[..., :, None] >= 0))  # [..., s, t]
    ord_s = (own_eq & (sid[None, :] < sid[:, None])).sum(-1, dtype=I32)
    keep_lim = torch.where(own0_oh, keep_g[..., None, :], 0).sum(-1, dtype=I32)
    keep_s = (own0 >= 0) & (ord_s < keep_lim)

    # the m-th moving shard goes to the member at the m-th deficit slot,
    # members ordered by (gid + rot) % ng
    moving = (~keep_s).to(I32)
    m_ord = torch.cumsum(moving, -1, dtype=I32) - moving
    rot = torch.as_tensor(tie_rot, dtype=I32, device=dev)
    akey = torch.where(member, torch.remainder(gid + rot[..., None], ng), _BIG)
    start = torch.where(akey[..., None, :] < akey[..., :, None],
                        need_g[..., None, :], 0).sum(-1, dtype=I32)
    in_slot = (member[..., None, :]
               & (m_ord[..., :, None] >= start[..., None, :])
               & (m_ord[..., :, None] < (start + need_g)[..., None, :]))
    dst_s = torch.where(in_slot, gid, 0).sum(-1, dtype=I32)
    k1 = (k >= 1)[..., None]
    own = torch.where(k1, torch.where(keep_s, own0, dst_s), -1)

    # bug_greedy_rebalance: every orphan to the least-loaded member
    gkey = torch.where(member, retained * ng + torch.remainder(akey, ng), _BIG)
    gmin = gkey.amin(-1, keepdim=True)
    dst0 = torch.where(gkey == gmin, gid, 0).sum(-1, dtype=I32)
    own_greedy = torch.where((own0 < 0) & k1, dst0[..., None], own0)

    # bug_full_reshuffle: shard s -> the (s mod k)-th member, round robin
    mrank = (member[..., None, :] & (akey[..., None, :] < akey[..., :, None])
             ).sum(-1, dtype=I32)
    rs_oh = member[..., None, :] & (
        mrank[..., None, :] == torch.remainder(sid, ksafe[..., None])[..., None])
    own_rs = torch.where(k1, torch.where(rs_oh, gid, 0).sum(-1, dtype=I32), -1)

    greedy = torch.as_tensor(greedy, device=dev)[..., None]
    reshuffle = torch.as_tensor(reshuffle, device=dev)[..., None]
    return torch.where(reshuffle, own_rs,
                       torch.where(greedy, own_greedy, own)).to(I32)


def _min_moves(ng: int, member, owner):
    """The closed-form minimal move count [...] of a membership change:
    the orphans, plus what overloaded members must shed down to the
    best-case targets. member [..., NG], owner [..., NS]."""
    gid = torch.arange(ng, dtype=I32, device=member.device)
    owner_oh = owner[..., :, None] == gid
    valid = (owner_oh & member[..., None, :]).any(-1)
    orphans = (~valid).sum(-1, dtype=I32)
    retained, target = _retained_targets(ng, member, owner_oh, valid)
    shed = torch.where(member, torch.clamp(retained - target, min=0), 0).sum(
        -1, dtype=I32)
    return orphans + shed


def _hash_config(member, owner, num):
    """int32 hash [...] of a config (member [..., NG], owner [..., NS] and
    its num [...]): the reference's multiply-sum, computed in int64 and
    wrapped once (every step wraps mod 2^32 there)."""
    dev = member.device
    ng = member.shape[-1]
    pw = torch.as_tensor(_HASH_POW.astype(np.int64), device=dev)
    bits = (member.to(torch.int64)
            << torch.arange(ng, dtype=torch.int64, device=dev)).sum(-1)
    h = (bits + 1) * pw[0] + ((owner.to(torch.int64) + 2) * pw[1:]).sum(-1)
    return _wrap_i32(h * 31 + torch.as_tensor(num, device=dev).to(torch.int64))


def _apply_entry(kcfg: CtrlerConfig, tie_rot, greedy, reshuffle,
                 member, owner, hist, cfg_num, last_seq, val, live):
    """Apply one log entry to every controller state machine instance of
    the batch (the reference's ``_apply_entry``), shared by the nodes'
    apply machines ([B, n]) and the truth walker ([B]); only ``tie_rot``
    differs. member [..., NG], owner [..., NS], hist [..., NCFG], cfg_num
    [...], last_seq [..., NC], val / live [...]. Returns the new (member,
    owner, hist, cfg_num, last_seq) and (fresh, client, seq, q_obs,
    viol), q_obs >= 0 only for an applied Query."""
    ng, ncfg, nc = kcfg.n_gids, kcfg.n_configs, kcfg.n_clients
    dev = val.device
    gids = torch.arange(ng, dtype=I32, device=dev)
    client, seq, arg, kind = _unpack(kcfg, val)
    client = torch.clamp(client, 0, nc - 1)
    is_op = live & (val != NOOP_CMD)
    cl_oh = torch.arange(nc, dtype=I32, device=dev) == client[..., None]
    prev = torch.where(cl_oh, last_seq, 0).sum(-1, dtype=I32)
    fresh = is_op & (seq > prev)
    last_seq = torch.where(cl_oh & is_op[..., None],
                           torch.maximum(prev, seq)[..., None], last_seq)

    room = cfg_num < ncfg - 1
    mask = ((arg[..., None] >> gids) & 1) > 0  # [..., NG] the gid set
    mv_gid = torch.clamp(torch.remainder(arg, ng), 0, ng - 1)
    mv_shard = torch.clamp(torch.div(arg, ng, rounding_mode="floor"), 0,
                           N_SHARDS - 1)
    mem_at_mv = ((gids == mv_gid[..., None]) & member).any(-1)
    do_join = fresh & (kind == _JOIN) & room & (mask & ~member).any(-1)
    do_leave = fresh & (kind == _LEAVE) & room & (mask & member).any(-1)
    new_member = torch.where(
        do_join[..., None], member | mask,
        torch.where(do_leave[..., None], member & ~mask, member))
    do_move = fresh & (kind == _MOVE) & room & mem_at_mv
    do_rebal = do_join | do_leave

    reb = _rebalance(ng, new_member, owner, tie_rot, greedy, reshuffle)
    sids = torch.arange(N_SHARDS, dtype=I32, device=dev)
    moved_owner = torch.where(sids == mv_shard[..., None], mv_gid[..., None],
                              owner)
    new_owner = torch.where(do_rebal[..., None], reb,
                            torch.where(do_move[..., None], moved_owner, owner))
    new_cfg = do_rebal | do_move
    cfg_num2 = torch.where(new_cfg, cfg_num + 1, cfg_num)

    # the balance and minimality oracles on Join/Leave transitions (k >= 1)
    k2 = new_member.sum(-1, dtype=I32)
    cnt2 = _counts(new_owner, ng)
    no_oh = new_owner[..., :, None] == gids
    owners_ok = (no_oh & new_member[..., None, :]).any(-1).all(-1)
    cmax = torch.where(new_member, cnt2, -1).amax(-1)
    cmin = torch.where(new_member, cnt2, _BIG).amin(-1)
    bal_bad = do_rebal & (k2 >= 1) & (~owners_ok | (cmax - cmin > 1))
    moved = (new_owner != owner).sum(-1, dtype=I32)
    min_bad = do_rebal & (k2 >= 1) & (moved != _min_moves(ng, new_member,
                                                          owner))
    viol = (torch.where(bal_bad, VIOLATION_CTRL_BALANCE, 0)
            | torch.where(min_bad, VIOLATION_CTRL_MINIMAL, 0)).to(I32)

    slots = torch.arange(ncfg, dtype=I32, device=dev)
    hist = torch.where(
        (slots == cfg_num2[..., None]) & new_cfg[..., None],
        _hash_config(new_member, new_owner, cfg_num2)[..., None], hist)
    member = torch.where(new_cfg[..., None], new_member, member)
    owner = torch.where(new_cfg[..., None], new_owner, owner)

    # Query: the config at min(num, latest), masked to 31 bits
    is_q = fresh & (kind == _QUERY)
    eff = torch.minimum(arg, cfg_num2)
    hist_at = torch.where(slots == eff[..., None], hist, 0).sum(-1, dtype=I32)
    q_obs = torch.where(is_q, hist_at & 0x7FFFFFFF, -1)
    return (member, owner, hist, cfg_num2, last_seq, fresh, client, seq,
            q_obs, viol)


class CtrlerState(NamedTuple):
    """A batch's raft state plus the 4A service layer, the reference's
    ``CtrlerState`` with a leading cluster axis; its comments explain
    each leaf. The four metric stamps are zero-size with metrics off."""

    raft: ClusterState
    clerk_seq: torch.Tensor      # [B, NC]
    clerk_out: torch.Tensor      # [B, NC] bool
    clerk_arg: torch.Tensor      # [B, NC]
    clerk_kind: torch.Tensor     # [B, NC]
    clerk_acked: torch.Tensor    # [B, NC]
    clerk_q_obs: torch.Tensor    # [B, NC]
    queries_done: torch.Tensor   # [B, NC]
    clerk_sub: torch.Tensor      # [B, NC | 0]
    clerk_app: torch.Tensor      # [B, NC | 0]
    clerk_cmt: torch.Tensor      # [B, NC | 0]
    clerk_apl: torch.Tensor      # [B, NC | 0]
    applied: torch.Tensor        # [B, N]
    last_seq: torch.Tensor       # [B, N, NC]
    member: torch.Tensor         # [B, N, NG] bool
    owner: torch.Tensor          # [B, N, NS]
    cfg_num: torch.Tensor        # [B, N]
    hist: torch.Tensor           # [B, N, NCFG]
    snap_last_seq: torch.Tensor  # [B, N, NC]
    snap_member: torch.Tensor    # [B, N, NG] bool
    snap_owner: torch.Tensor     # [B, N, NS]
    snap_cfg_num: torch.Tensor   # [B, N]
    snap_hist: torch.Tensor      # [B, N, NCFG]
    w_frontier: torch.Tensor     # [B]
    w_last_seq: torch.Tensor     # [B, NC]
    w_member: torch.Tensor       # [B, NG] bool
    w_owner: torch.Tensor        # [B, NS]
    w_cfg_num: torch.Tensor      # [B]
    w_hist: torch.Tensor         # [B, NCFG]
    w_q_seq: torch.Tensor        # [B, NC]
    w_q_obs: torch.Tensor        # [B, NC]
    w_stalled: torch.Tensor      # [B] bool


# the service leaves, in order (CtrlerState's fields after ``raft``)
SERVICE = CtrlerState._fields[1:]
# every leaf of a ctrler state as one flat name space: the raft leaves,
# then the service leaves (ctrler_state_to_numpy / first_divergence)
CTRLER_FIELDS = ClusterState._fields + SERVICE


def _hist0(kcfg: CtrlerConfig, device) -> torch.Tensor:
    """[NCFG] the history at init: config 0 (no groups, every shard
    unowned) hashed at num 0, the rest 0."""
    h0 = _hash_config(torch.zeros(kcfg.n_gids, dtype=BOOL, device=device),
                      torch.full((N_SHARDS,), -1, dtype=I32, device=device),
                      0)
    hist0 = torch.zeros(kcfg.n_configs, dtype=I32, device=device)
    hist0[0] = h0
    return hist0


def init_ctrler_cluster(cfg: SimConfig, kcfg: CtrlerConfig,
                        keys: torch.Tensor, kn=None) -> CtrlerState:
    """Fresh ctrler clusters at tick 0, one per key row of ``keys``
    [B, 2]."""
    dev = keys.device
    b = keys.shape[0]
    n, nc = cfg.n_nodes, kcfg.n_clients
    ng, ncfg = kcfg.n_gids, kcfg.n_configs
    mc = nc if cfg.metrics else 0
    hist0 = _hist0(kcfg, dev)

    def full(shape, v=0, dtype=I32):
        return torch.full((b, *shape), v, dtype=dtype, device=dev)

    def rows(x, shape):
        return x.expand(b, *shape).clone()

    return CtrlerState(
        raft=init_cluster(cfg, keys, kn),
        clerk_seq=full((nc,)), clerk_out=full((nc,), False, BOOL),
        clerk_arg=full((nc,)), clerk_kind=full((nc,)),
        clerk_acked=full((nc,)), clerk_q_obs=full((nc,), -1),
        queries_done=full((nc,)),
        clerk_sub=full((mc,)), clerk_app=full((mc,)), clerk_cmt=full((mc,)),
        clerk_apl=full((mc,)),
        applied=full((n,)), last_seq=full((n, nc)),
        member=full((n, ng), False, BOOL), owner=full((n, N_SHARDS), -1),
        cfg_num=full((n,)), hist=rows(hist0, (n, ncfg)),
        snap_last_seq=full((n, nc)), snap_member=full((n, ng), False, BOOL),
        snap_owner=full((n, N_SHARDS), -1), snap_cfg_num=full((n,)),
        snap_hist=rows(hist0, (n, ncfg)),
        w_frontier=full(()), w_last_seq=full((nc,)),
        w_member=full((ng,), False, BOOL), w_owner=full((N_SHARDS,), -1),
        w_cfg_num=full(()), w_hist=rows(hist0, (ncfg,)),
        w_q_seq=full((nc,)), w_q_obs=full((nc,), -1),
        w_stalled=full((), False, BOOL),
    )


def _ctrler_service_tick(cfg: SimConfig, kcfg: CtrlerConfig, ks: CtrlerState,
                         pre_alive: torch.Tensor, pre_base: torch.Tensor,
                         s: ClusterState, keys: torch.Tensor, kn: Knobs,
                         ckn: CtrlerKnobs) -> CtrlerState:
    """The service share of one tick for every cluster, given the stepped
    raft state ``s`` and the pre-tick ``alive`` / ``base``: the
    reference's ``_ctrler_service_tick`` (its comments explain each
    step), batch-first. Kernel K10's plain version."""
    n, cap, nc = cfg.n_nodes, cfg.log_cap, kcfg.n_clients
    ng, jm = kcfg.n_gids, kcfg.join_max
    dev = s.tick.device
    b = s.tick.shape[0]
    me = torch.arange(n, dtype=I32, device=dev)
    cl_ids = torch.arange(nc, dtype=I32, device=dev)
    t = s.tick
    t2 = t[:, None]
    key = prng.fold_in(keys, t)
    k1, k2 = ckn.lanes(1), ckn.lanes(2)  # against [B] / [B, m] operands
    metrics = cfg.metrics

    # 1. crash / restart: the live machine resets to the persisted snapshot
    fresh_node = (~pre_alive & s.alive) | ~s.alive
    fz = fresh_node[..., None]
    applied = torch.where(fresh_node, s.base, ks.applied)
    last_seq = torch.where(fz, ks.snap_last_seq, ks.last_seq)
    member = torch.where(fz, ks.snap_member, ks.member)
    owner = torch.where(fz, ks.snap_owner, ks.owner)
    cfg_num = torch.where(fresh_node, ks.snap_cfg_num, ks.cfg_num)
    hist = torch.where(fz, ks.snap_hist, ks.hist)

    # 2. compaction this tick: capture the live tables as the snapshot
    inst = s.snap_installed_src >= 0
    comp = (s.base != pre_base) & ~inst & s.alive
    cz = comp[..., None]
    snap_last_seq = torch.where(cz, last_seq, ks.snap_last_seq)
    snap_member = torch.where(cz, member, ks.snap_member)
    snap_owner = torch.where(cz, owner, ks.snap_owner)
    snap_cfg_num = torch.where(comp, cfg_num, ks.snap_cfg_num)
    snap_hist = torch.where(cz, hist, ks.snap_hist)

    # 3. install-snapshot: adopt the sender's PRE-tick snapshot tables
    src_oh = (me == s.snap_installed_src[..., None])[..., None]  # [B, dst, src, 1]

    def adopt(snap):
        return torch.where(src_oh, snap[:, None, :, :], 0).sum(2, dtype=I32)

    ad_last_seq = adopt(ks.snap_last_seq)
    ad_member = adopt(ks.snap_member.to(I32)) > 0
    ad_owner = adopt(ks.snap_owner + 1) - 1  # the -1 sentinel survives
    ad_cfg_num = torch.where(src_oh[..., 0], ks.snap_cfg_num[:, None, :],
                             0).sum(2, dtype=I32)
    ad_hist = adopt(ks.snap_hist)
    iz = inst[..., None]
    applied = torch.where(inst, s.base, applied)
    last_seq = torch.where(iz, ad_last_seq, last_seq)
    member = torch.where(iz, ad_member, member)
    owner = torch.where(iz, ad_owner, owner)
    cfg_num = torch.where(inst, ad_cfg_num, cfg_num)
    hist = torch.where(iz, ad_hist, hist)
    snap_last_seq = torch.where(iz, ad_last_seq, snap_last_seq)
    snap_member = torch.where(iz, ad_member, snap_member)
    snap_owner = torch.where(iz, ad_owner, snap_owner)
    snap_cfg_num = torch.where(inst, ad_cfg_num, snap_cfg_num)
    snap_hist = torch.where(iz, ad_hist, snap_hist)

    # ---------------------------------------------------------- apply machines
    viol = torch.zeros(b, dtype=I32, device=dev)
    clerk_q_obs = ks.clerk_q_obs
    # the rotate bug's per-node tie-break rotation (0 when off)
    node_rot = torch.where(k2.bug_rotate_tiebreak, me, 0).expand(b, n)
    greedy_n, reshuffle_n = k2.bug_greedy_rebalance, k2.bug_full_reshuffle
    for _ in range(kcfg.apply_max):
        can = s.alive & (applied < s.commit)
        val = _row_gather(s.log_val, _slot(applied + 1, cap), cap)  # [B, n]
        (member, owner, hist, cfg_num, last_seq,
         fresh, client, seq, q_obs, v) = _apply_entry(
            kcfg, node_rot, greedy_n, reshuffle_n, member, owner, hist,
            cfg_num, last_seq, val, can)
        for bit in (VIOLATION_CTRL_BALANCE, VIOLATION_CTRL_MINIMAL):
            viol |= torch.where(((v & bit) != 0).any(-1), bit, 0).to(I32)
        # the first node to apply a Query yields its answer (replica
        # agreement is CTRL_DIVERGE's)
        m = ((fresh & (q_obs >= 0))[:, None, :]
             & (client[:, None, :] == cl_ids[None, :, None])
             & (seq[:, None, :] == ks.clerk_seq[:, :, None]))  # [B, nc, n]
        cand = torch.where(m, q_obs[:, None, :], -1).amax(-1)
        clerk_q_obs = torch.where((clerk_q_obs < 0) & (cand >= 0), cand,
                                  clerk_q_obs)
        applied = torch.where(can, applied + 1, applied)

    # ------------------------------------------------------------ truth walker
    w_frontier, w_last_seq = ks.w_frontier, ks.w_last_seq
    w_member, w_owner = ks.w_member, ks.w_owner
    w_cfg_num, w_hist = ks.w_cfg_num, ks.w_hist
    w_q_seq, w_q_obs = ks.w_q_seq, ks.w_q_obs
    w_stalled = ks.w_stalled
    sh_abs = lane_abs(s.shadow_base, cap)  # [B, cap]
    lane1 = torch.arange(cap, dtype=I32, device=dev)
    zero_rot = torch.zeros(b, dtype=I32, device=dev)
    for _ in range(kcfg.walk_max):
        canw = w_frontier < s.shadow_len
        posw = _slot(w_frontier + 1, cap)
        in_win = ((lane1 == posw[:, None])
                  & (sh_abs == (w_frontier + 1)[:, None])).any(-1)
        # an entry needed but already overwritten: the stall is sticky
        w_stalled = w_stalled | (canw & ~in_win)
        canw = canw & in_win
        val = _row_gather(s.shadow_val[:, None, :], posw[:, None], cap)[:, 0]
        (w_member, w_owner, w_hist, w_cfg_num, w_last_seq,
         fresh, client, seq, q_obs, v) = _apply_entry(
            kcfg, zero_rot, k1.bug_greedy_rebalance, k1.bug_full_reshuffle,
            w_member, w_owner, w_hist, w_cfg_num, w_last_seq, val, canw)
        viol |= v
        hit_q = ((cl_ids == client[:, None]) & fresh[:, None]
                 & (q_obs >= 0)[:, None])
        w_q_seq = torch.where(hit_q, seq[:, None], w_q_seq)
        w_q_obs = torch.where(hit_q, q_obs[:, None], w_q_obs)
        w_frontier = torch.where(canw, w_frontier + 1, w_frontier)

    # ----------------------------------------------------------------- oracles
    # divergence: an alive node exactly at the walker frontier must equal
    # the canonical state machine bit for bit
    at_frontier = s.alive & (applied == w_frontier[:, None])  # [B, n]
    m_all = ((member == w_member[:, None, :]).all(-1)
             & (owner == w_owner[:, None, :]).all(-1)
             & (cfg_num == w_cfg_num[:, None])
             & (hist == w_hist[:, None, :]).all(-1)
             & (last_seq == w_last_seq[:, None, :]).all(-1))
    viol |= torch.where((at_frontier & ~m_all).any(-1),
                        VIOLATION_CTRL_DIVERGE, 0).to(I32)

    # ------------------------------------------------------------------ clerks
    want = _pack(kcfg, cl_ids, ks.clerk_seq, ks.clerk_arg, ks.clerk_kind)
    sh_live = sh_abs <= s.shadow_len[:, None]
    in_shadow = ((s.shadow_val[:, None, :] == want[..., None])
                 & sh_live[:, None, :]).any(-1)
    is_q = ks.clerk_kind == _QUERY
    q_ready = (clerk_q_obs >= 0) & (w_q_seq == ks.clerk_seq)
    clerk_cmt, clerk_apl = ks.clerk_cmt, ks.clerk_apl
    if metrics:
        clerk_cmt = torch.where(ks.clerk_out & in_shadow & (clerk_cmt == 0),
                                t2, clerk_cmt)
        clerk_apl = torch.where(ks.clerk_out & q_ready & (clerk_apl == 0),
                                t2, clerk_apl)
    newly_acked = ks.clerk_out & in_shadow & (~is_q | q_ready)
    done_q = newly_acked & is_q
    # historical-query correctness: the served config equals the walker's
    # answer for the same (client, seq)
    viol |= torch.where((done_q & (clerk_q_obs != w_q_obs)).any(-1),
                        VIOLATION_CTRL_QUERY, 0).to(I32)
    clerk_acked = torch.where(newly_acked, ks.clerk_seq, ks.clerk_acked)
    clerk_out = ks.clerk_out & ~newly_acked
    queries_done = ks.queries_done + done_q.to(I32)
    r = s
    lat_hist, phase_hist, phase_ticks, lat_ticks = (
        r.lat_hist, r.phase_hist, r.phase_ticks, r.lat_ticks)
    worst = (r.worst_lat, r.worst_phases, r.worst_key, r.worst_client,
             r.worst_sub)
    if metrics:
        # the ack is the clerk's reply: its submit->ack latency, phases and
        # the worst-op register (key -1: controller ops have no key)
        e2e = t2 - ks.clerk_sub
        lat_hist = _m.fold_latencies(lat_hist, e2e, newly_acked)
        ph = _m.clerk_phase_matrix(t2, ks.clerk_sub, ks.clerk_app, clerk_cmt,
                                   clerk_apl, is_q)
        phase_hist, phase_ticks, lat_ticks = _m.fold_phases(
            phase_hist, phase_ticks, lat_ticks, ph, e2e, newly_acked)
        worst = _m.update_worst(worst, e2e, newly_acked, ph,
                                torch.full_like(e2e, -1),
                                cl_ids.expand(b, nc), ks.clerk_sub)

    # start fresh ops / retry pending ones
    kk = prng.split(prng.fold_in(key, _S_CLERK_START), 7)  # [B, 7, 2]
    start = (~clerk_out & prng.bernoulli(kk[:, 0], ckn.p_op, nc)
             & (ks.clerk_seq < _SEQ_LIM - 1))
    clerk_seq = torch.where(start, ks.clerk_seq + 1, ks.clerk_seq)
    u_kind = prng.uniform(prng.fold_in(key, _S_CLERK_KIND), nc)
    pq, pm = k2.p_query, k2.p_move
    new_kind = torch.where(
        u_kind < pq, _QUERY,
        torch.where(u_kind < pq + pm, _MOVE,
                    # Join / Leave split the residual mass evenly
                    torch.where(u_kind < pq + pm + (1.0 - pq - pm) * 0.5,
                                _JOIN, _LEAVE))).to(I32)
    raw = prng.randint(kk[:, 1], nc, 0, N_SHARDS * ng)
    qnum = prng.randint(kk[:, 4], nc, 0, kcfg.n_configs + 1)
    # the (nc, join_max) draw is one flat stream, row-major
    gsel = prng.randint(kk[:, 5], nc * jm, 0, ng).view(b, nc, jm)
    gcnt = prng.randint(kk[:, 6], nc, 1, jm + 1)
    gids = torch.arange(ng, dtype=I32, device=dev)
    gmask = ((gids == gsel[..., None])
             & (torch.arange(jm, dtype=I32, device=dev)[:, None]
                < gcnt[..., None, None])).any(-2)  # [B, nc, NG]
    mask_arg = (gmask.to(I32) << gids).sum(-1, dtype=I32)
    new_arg = torch.where(
        new_kind == _QUERY,
        torch.where(torch.remainder(raw, 4) == 0, kcfg._arg_lim - 1, qnum),
        torch.where(new_kind == _MOVE, raw, mask_arg))
    clerk_kind = torch.where(start, new_kind, ks.clerk_kind)
    clerk_arg = torch.where(start, new_arg, ks.clerk_arg)
    clerk_q_obs = torch.where(start, -1, clerk_q_obs)
    clerk_sub, clerk_app = ks.clerk_sub, ks.clerk_app
    if metrics:
        # the latency window opens at the op's start
        clerk_sub = torch.where(start, t2, clerk_sub)
        clerk_app = torch.where(start, 0, clerk_app)
        clerk_cmt = torch.where(start, 0, clerk_cmt)
        clerk_apl = torch.where(start, 0, clerk_apl)
    clerk_out = clerk_out | start
    retry = clerk_out & (start | prng.bernoulli(kk[:, 2], ckn.p_retry, nc))
    target = prng.randint(kk[:, 3], nc, 0, n)

    violations = s.violations | viol
    first_violation_tick = torch.where(
        (s.first_violation_tick < 0) & (viol != 0), t, s.first_violation_tick)

    # submit: append at the targeted node iff it believes it is the leader,
    # one clerk after another (clerk c's append moves the log_len that
    # clerk c + 1 reads)
    log_term, log_val, log_len = s.log_term, s.log_val, s.log_len
    lane = torch.arange(cap, dtype=I32, device=dev)
    flow_cap = lane_view(kn.flow_cap, 2)
    landed = []
    for c in range(nc):
        ok = ((me == target[:, c:c + 1]) & retry[:, c:c + 1] & s.alive
              & (s.role == LEADER) & (log_len - s.base < cap)
              & (log_len - s.commit < flow_cap))
        v = _pack(kcfg, c, clerk_seq[:, c], clerk_arg[:, c], clerk_kind[:, c])
        hit = ok[..., None] & (lane == _slot(log_len + 1, cap)[..., None])
        log_term = torch.where(hit, s.term[..., None], log_term)
        log_val = torch.where(hit, v[:, None, None], log_val)
        log_len = torch.where(ok, log_len + 1, log_len)
        landed.append(ok.any(-1))
    if metrics:
        clerk_app = torch.where(torch.stack(landed, -1) & clerk_out
                                & (clerk_app == 0), t2, clerk_app)

    raft = s._replace(
        log_term=log_term, log_val=log_val, log_len=log_len,
        durable_len=durable_after_append(s, log_len),
        violations=violations, first_violation_tick=first_violation_tick,
        compact_floor=applied,
        lat_hist=lat_hist, phase_hist=phase_hist, phase_ticks=phase_ticks,
        lat_ticks=lat_ticks, worst_lat=worst[0], worst_phases=worst[1],
        worst_key=worst[2], worst_client=worst[3], worst_sub=worst[4],
    )
    return CtrlerState(
        raft=raft, clerk_seq=clerk_seq, clerk_out=clerk_out,
        clerk_arg=clerk_arg, clerk_kind=clerk_kind, clerk_acked=clerk_acked,
        clerk_q_obs=clerk_q_obs, queries_done=queries_done,
        clerk_sub=clerk_sub, clerk_app=clerk_app, clerk_cmt=clerk_cmt,
        clerk_apl=clerk_apl, applied=applied, last_seq=last_seq,
        member=member, owner=owner, cfg_num=cfg_num, hist=hist,
        snap_last_seq=snap_last_seq, snap_member=snap_member,
        snap_owner=snap_owner, snap_cfg_num=snap_cfg_num,
        snap_hist=snap_hist, w_frontier=w_frontier, w_last_seq=w_last_seq,
        w_member=w_member, w_owner=w_owner, w_cfg_num=w_cfg_num,
        w_hist=w_hist, w_q_seq=w_q_seq, w_q_obs=w_q_obs, w_stalled=w_stalled,
    )


def ctrler_step(cfg: SimConfig, kcfg: CtrlerConfig, ks: CtrlerState,
                keys: torch.Tensor, kn: Knobs, ckn: CtrlerKnobs,
                tick: str = "kernel", table=None,
                ctable=None) -> CtrlerState:
    """One ctrler tick of every cluster: the raft tick, then the service
    tick, routed by ``engine.tick_route``: on the card one K6-ctrler
    launch of one tick (``K10.ctrler_chunk``), with ``table`` / ``ctable``
    the knob tables a caller running many ticks builds once
    (``K6.knob_table``, ``K10.knob_table``); on the CPU, or with
    ``tick="eager"``, ``step_cluster`` and the plain service tick."""
    from madraft_tpu_torch.tpusim.engine import tick_route

    if tick_route(ks.raft.tick.device, tick) == "kernel":
        return K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, 1, table,
                                ctable)
    pre = ks.raft
    s = step_cluster(cfg, pre, keys, kn)
    return K10.ctrler_tick(cfg, kcfg, ks, pre.alive, pre.base, s, keys, kn,
                           ckn, plain=True)


def _advance_ctrler(cfg: SimConfig, kcfg: CtrlerConfig, ks: CtrlerState,
                    keys: torch.Tensor, kn: Knobs, ckn: CtrlerKnobs,
                    n_ticks: int, tick: str = "kernel") -> CtrlerState:
    """n_ticks ctrler ticks, routed as ``ctrler_step`` says: on the card
    K6-ctrler launches of up to ``engine.KERNEL_CHUNK`` ticks (both knob
    tables built once here), else a ``ctrler_step`` a tick. Every ctrler
    run goes through this function, so ``functools.partial(
    _advance_ctrler, tick="eager")`` in its place runs a whole program on
    the eager route (the A/B's baseline)."""
    from madraft_tpu_torch.tpusim.engine import KERNEL_CHUNK, tick_route

    if tick_route(ks.raft.tick.device, tick) == "kernel":
        b = keys.shape[0]
        table = K6.knob_table(kn, b)
        ctable = K10.knob_table(kn, ckn, b)
        for done in range(0, n_ticks, KERNEL_CHUNK):
            ks = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn,
                                  min(KERNEL_CHUNK, n_ticks - done), table,
                                  ctable)
        return ks
    for _ in range(n_ticks):
        ks = ctrler_step(cfg, kcfg, ks, keys, kn, ckn, tick)
    return ks


# ------------------------------------------------------------------- drivers
class CtrlerFuzzReport(NamedTuple):
    """Host-side summary of one ctrler fuzz run, the reference's fields."""

    violations: np.ndarray
    first_violation_tick: np.ndarray
    acked_ops: np.ndarray
    queries_done: np.ndarray
    configs_created: np.ndarray
    committed: np.ndarray
    msg_count: np.ndarray
    snap_installs: np.ndarray
    walker_stalled: np.ndarray
    lat_hist: Optional[np.ndarray] = None
    ev_counts: Optional[np.ndarray] = None
    phase_hist: Optional[np.ndarray] = None
    phase_ticks: Optional[np.ndarray] = None
    lat_ticks: Optional[np.ndarray] = None
    worst_lat: Optional[np.ndarray] = None
    worst_phases: Optional[np.ndarray] = None
    worst_key: Optional[np.ndarray] = None
    worst_client: Optional[np.ndarray] = None
    worst_sub: Optional[np.ndarray] = None

    @property
    def n_violating(self) -> int:
        return int((self.violations != 0).sum())

    def violating_clusters(self) -> np.ndarray:
        return np.nonzero(self.violations != 0)[0]


def ctrler_report(final: CtrlerState) -> CtrlerFuzzReport:
    r = final.raft
    has_metrics = r.lat_hist.numel() > 0

    def h(x):
        return x.cpu().numpy()

    def m(x):
        return h(x) if has_metrics else None

    return CtrlerFuzzReport(
        violations=h(r.violations),
        first_violation_tick=h(r.first_violation_tick),
        acked_ops=h(final.clerk_acked.sum(-1, dtype=I32)),
        queries_done=h(final.queries_done.sum(-1, dtype=I32)),
        configs_created=h(final.w_cfg_num),
        committed=h(r.shadow_len),
        msg_count=h(r.msg_count),
        snap_installs=h(r.snap_install_count),
        walker_stalled=h(final.w_stalled),
        lat_hist=m(r.lat_hist), ev_counts=m(r.ev_counts),
        phase_hist=m(r.phase_hist), phase_ticks=m(r.phase_ticks),
        lat_ticks=m(r.lat_ticks), worst_lat=m(r.worst_lat),
        worst_phases=m(r.worst_phases), worst_key=m(r.worst_key),
        worst_client=m(r.worst_client), worst_sub=m(r.worst_sub),
    )


class CtrlerFuzzProgram:
    """``fn(seed) -> final batched CtrlerState`` for one config and shape,
    the ``engine.FuzzProgram`` interface (``compile_timed`` builds the
    kernels, the run's K6-ctrler build among them, before the first
    tick). ``kn`` / ``ckn`` override the configs' knobs (the
    sweep's [B] rows)."""

    def __init__(self, cfg: SimConfig, kcfg: CtrlerConfig, n_clusters: int,
                 n_ticks: int, device, kn: Optional[Knobs] = None,
                 ckn: Optional[CtrlerKnobs] = None):
        from madraft_tpu_torch.tpusim.engine import (
            _validate_knobs,
            check_card_shape,
            resolve_device,
        )

        check_service_cfg(cfg, "ctrler")
        self.cfg, self.kcfg = cfg, kcfg
        self.n_clusters, self.n_ticks = n_clusters, n_ticks
        self.device = resolve_device(device)
        check_card_shape(self.device, cfg, K10, kcfg)
        self.kn = cfg.knobs(self.device) if kn is None else kn.to(self.device)
        self.ckn = (kcfg.knobs(self.device) if ckn is None
                    else ckn.to(self.device))
        _validate_knobs(self.kn)
        _validate_ctrler_knobs(self.ckn)
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        from madraft_tpu_torch.tpusim.engine import _build_kernels

        if self.compile_s is None:
            self.compile_s = _build_kernels(
                self.device, self.cfg.metrics,
                extra=(K6.variant(self.cfg.metrics, False, ctrler=True),))
        return self.compile_s

    def __call__(self, seed) -> CtrlerState:
        from madraft_tpu_torch.tpusim.engine import cluster_keys

        keys = cluster_keys(seed, self.n_clusters, self.device)
        ks = init_ctrler_cluster(self.cfg, self.kcfg, keys, self.kn)
        return _advance_ctrler(self.cfg, self.kcfg, ks, keys, self.kn,
                               self.ckn, self.n_ticks)


def make_ctrler_fuzz_fn(cfg: SimConfig, kcfg: CtrlerConfig, n_clusters: int,
                        n_ticks: int, device=None) -> CtrlerFuzzProgram:
    """Build fn(seed) -> final batched CtrlerState (uniform knobs)."""
    return CtrlerFuzzProgram(cfg, kcfg, n_clusters, n_ticks, device)


def ctrler_fuzz(cfg: SimConfig, kcfg: CtrlerConfig, seed: int,
                n_clusters: int, n_ticks: int,
                device=None) -> CtrlerFuzzReport:
    """Fuzz the 4A config service over n_clusters independent clusters;
    cluster c draws from fold_in(PRNGKey(seed), c)."""
    return ctrler_report(make_ctrler_fuzz_fn(cfg, kcfg, n_clusters, n_ticks,
                                             device)(seed))


def _validate_ctrler_knobs(ckn: CtrlerKnobs) -> None:
    """Eager rejection of service-knob values that would silently
    misbehave in the tick, in the reference's words."""
    from madraft_tpu_torch.tpusim.engine import (
        validate_bool_bugs,
        validate_probs,
    )

    k = CtrlerKnobs(*(x.cpu().numpy() for x in ckn))
    validate_probs(k, ("p_op", "p_query", "p_move", "p_retry"), "ctrler")
    if (k.p_query + k.p_move > 1.0).any():
        raise ValueError(
            "p_query + p_move must stay <= 1 per cluster (one uniform draw "
            "splits Query/Move/Join-Leave)"
        )
    validate_bool_bugs(
        k, ("bug_rotate_tiebreak", "bug_greedy_rebalance",
            "bug_full_reshuffle"), "ctrler")


def make_ctrler_sweep_fn(cfg: SimConfig, knobs: Knobs, cknobs: CtrlerKnobs,
                         kcfg: CtrlerConfig, n_clusters: int, n_ticks: int,
                         device=None) -> CtrlerFuzzProgram:
    """Like make_ctrler_fuzz_fn, but every cluster runs its own raft AND
    service knob row (fields 0-d or [n_clusters]): fault intensity, op
    mix and the planted rebalance bugs become per-cluster data in one
    run."""
    from madraft_tpu_torch.tpusim.engine import (
        _validate_knobs,
        resolve_device,
        validate_service_raft_knobs,
    )

    check_service_cfg(cfg, "ctrler")
    dev = resolve_device(device)
    knobs, cknobs = knobs.to(dev), cknobs.to(dev)
    _validate_knobs(knobs)
    validate_service_raft_knobs(knobs)
    _validate_ctrler_knobs(cknobs)
    return CtrlerFuzzProgram(cfg, kcfg, n_clusters, n_ticks, dev,
                             kn=knobs.broadcast(n_clusters),
                             ckn=cknobs.broadcast(n_clusters))


def ctrler_replay_cluster(cfg: SimConfig, kcfg: CtrlerConfig, seed: int,
                          cluster_id: int, n_ticks: int,
                          device=None) -> CtrlerState:
    """Re-run one cluster alone from its (seed, cluster_id) stream; its
    final state with a batch axis of 1."""
    from madraft_tpu_torch.tpusim.engine import (
        check_card_shape,
        cluster_keys,
        resolve_device,
    )

    check_service_cfg(cfg, "ctrler")
    dev = resolve_device(device)
    check_card_shape(dev, cfg, K10, kcfg)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    keys = cluster_keys(seed, 1, dev, id0=int(cluster_id))
    ks = init_ctrler_cluster(cfg, kcfg, keys, kn)
    return _advance_ctrler(cfg, kcfg, ks, keys, kn, ckn, n_ticks)


# ---------------------------------------------------------- carry-across
# a ctrler state as one flat mapping of field -> host numpy array
# (CTRLER_FIELDS: the raft leaves by their names, then the service leaves),
# and back
ctrler_state_to_numpy = service_state_to_numpy


def ctrler_state_from_numpy(arrays: dict, device=None) -> CtrlerState:
    """``state.service_state_from_numpy`` of a ``CtrlerState``."""
    return service_state_from_numpy(CtrlerState, arrays, device)


def first_divergence(tick: int, want: dict, got: dict):
    """``state.first_divergence`` over every ctrler leaf
    (``CTRLER_FIELDS``)."""
    from madraft_tpu_torch.tpusim.state import first_divergence as _first

    return _first(tick, want, got, CTRLER_FIELDS)
