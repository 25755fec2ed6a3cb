"""The kv service layer on top of the raft tick: clerks, apply machines and
the kv oracles for a batch of clusters, the twin of the reference's
``madraft_tpu/tpusim/kv.py`` (whose module docstring explains the model).

A kv tick is the raft tick, then the service tick (``_kv_service_tick``):
the clerks' submits append to the log that the next raft tick reads, so
the two alternate every tick. On the card (``engine.tick_route``) both
run inside one launch of K6-kv for up to ``engine.KERNEL_CHUNK`` ticks
(``kernels.kv.kv_chunk``: kernel K6 with the service tick after each raft
tick on the same tile; with the metrics plane on, K6-metrics-kv, which
folds the clerks' latencies, the per-key and per-client axes among them,
inside the kernel). On the CPU, with ``tick="eager"``, or for a shape past
the kernels' limits, the raft tick is ``step.step_cluster`` and the
service tick this module's ``_kv_service_tick``, the plain version of K9
(``kernels.kv.kv_tick``, the per-tick kernel K6-kv is held against).

Batch-first like the rest of the port: a reference leaf ``[NC]`` is
``[B, NC]`` here, ``[N, NK]`` is ``[B, N, NK]``. Every knob of
``KvKnobs`` (and of the raft ``Knobs``) is 0-d, one value for the batch,
or a ``[B]`` row, one value a cluster (``make_kv_sweep_fn``).

The reference's packed kv carry (``kv_packed_layout`` .. ``kv_step_packed``)
is not ported: it changes no report bit, and the port ticks the wide
state (``"state_layout": "wide"`` in the telemetry), as on the raw verbs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import kv as K9
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels.oracle import lane_abs
from madraft_tpu_torch.tpusim import metrics as _m
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    LEADER,
    NOOP_CMD,
    OPEN_QUEUE_SLOTS,
    check_service_cfg,
    Knobs,
    SimConfig,
    lane_view,
    metrics_dims,
    zipf_map,
)
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    durable_after_append,
    init_cluster,
    service_state_from_numpy,
    service_state_to_numpy,
)
from madraft_tpu_torch.tpusim.step import (
    _first_true,
    _row_gather,
    _slot,
    step_cluster,
)

I32 = torch.int32
F32 = torch.float32
BOOL = torch.bool

# The kv oracles' violation bits (beside config.VIOLATION_*)
VIOLATION_EXACTLY_ONCE = 8   # duplicate or out-of-order apply of a client op
VIOLATION_KV_DIVERGE = 16    # equal apply cursors, different kv state
VIOLATION_STALE_READ = 32    # a Get observed a state outside its invoke..return

_SEQ_LIM = 1 << 15  # the op packing's seq field: 15 bits
_APPEND, _GET, _PUT = 0, 1, 2  # op kinds

# PRNG sites (fold_in data under the tick's key), as the reference's
_S_CLERK_START = 8
_S_CLERK_KIND = 14
_S_CLERK_HINT = 15


@dataclasses.dataclass(frozen=True)
class KvConfig:
    """Knobs of the kv layer, field for field the reference's ``KvConfig``
    (its comments explain each): ``n_clients`` / ``n_keys`` /
    ``apply_max`` shape the run, the rest are dynamic ``KvKnobs``."""

    n_clients: int = 4
    n_keys: int = 4
    p_op: float = 0.3
    p_get: float = 0.3
    p_put: float = 0.0
    p_retry: float = 0.5
    apply_max: int = 4
    bug_skip_dedup: bool = False
    bug_apply_uncommitted: bool = False
    bug_stale_read: bool = False
    p_follow_hint: float = 0.0
    retry_wait: int = 0
    bug_stale_hint: bool = False
    open_rate: float = 0.0
    open_queue_cap: int = 0
    zipf_a: float = 1.0

    def __post_init__(self):
        if self.p_get + self.p_put > 1.0:
            raise ValueError(
                f"p_get ({self.p_get}) + p_put ({self.p_put}) must stay <= 1 "
                "(one uniform draw splits Get/Put/Append; an over-unity pair "
                "would silently starve Appends)"
            )
        if not 0.0 <= self.open_rate <= 1.0:
            raise ValueError(f"open_rate {self.open_rate} not in [0, 1] "
                             "(per-tick arrival probability)")
        if not 0 <= self.open_queue_cap <= OPEN_QUEUE_SLOTS:
            raise ValueError(
                f"open_queue_cap {self.open_queue_cap} not in "
                f"[0, {OPEN_QUEUE_SLOTS}] (the arrival-stamp ring size)"
            )
        if self.zipf_a < 1.0:
            raise ValueError(f"zipf_a {self.zipf_a} must be >= 1.0 "
                             "(1.0 = uniform)")
        top = _pack(self, self.n_clients - 1, _SEQ_LIM - 1, self.n_keys - 1, 3)
        if top >= NOOP_CMD:
            raise ValueError(
                f"n_clients ({self.n_clients}) x n_keys ({self.n_keys}) "
                f"overflow the op packing (max {top} >= NOOP_CMD {NOOP_CMD})"
            )

    def replace(self, **kw) -> "KvConfig":
        return dataclasses.replace(self, **kw)

    def knobs(self, device=None) -> "KvKnobs":
        """The dynamic knobs as 0-d tensors on ``device`` (CPU if None)."""
        def f32(v):
            return torch.tensor(v, dtype=F32, device=device)

        def i32(v):
            return torch.tensor(v, dtype=I32, device=device)

        def b(v):
            return torch.tensor(v, dtype=BOOL, device=device)

        return KvKnobs(
            p_op=f32(self.p_op), p_get=f32(self.p_get), p_put=f32(self.p_put),
            p_retry=f32(self.p_retry), p_follow_hint=f32(self.p_follow_hint),
            retry_wait=i32(self.retry_wait),
            bug_skip_dedup=b(self.bug_skip_dedup),
            bug_apply_uncommitted=b(self.bug_apply_uncommitted),
            bug_stale_read=b(self.bug_stale_read),
            bug_stale_hint=b(self.bug_stale_hint),
            open_rate=f32(self.open_rate),
            open_queue_cap=i32(self.open_queue_cap),
            zipf_a=f32(self.zipf_a),
        )

    def static_key(self) -> "KvConfig":
        return KvConfig(n_clients=self.n_clients, n_keys=self.n_keys,
                        apply_max=self.apply_max)


class KvKnobs(NamedTuple):
    """The kv layer's dynamic knobs (see KvConfig): float32 probabilities,
    int32 counts and bool bugs, each 0-d or a [B] row."""

    p_op: torch.Tensor
    p_get: torch.Tensor
    p_put: torch.Tensor
    p_retry: torch.Tensor
    p_follow_hint: torch.Tensor
    retry_wait: torch.Tensor
    bug_skip_dedup: torch.Tensor
    bug_apply_uncommitted: torch.Tensor
    bug_stale_read: torch.Tensor
    bug_stale_hint: torch.Tensor
    open_rate: torch.Tensor
    open_queue_cap: torch.Tensor
    zipf_a: torch.Tensor

    def to(self, device) -> "KvKnobs":
        return KvKnobs(*(x.to(device) for x in self))

    def lanes(self, ndim: int) -> "KvKnobs":
        """Each field against a [B, ...] operand of ``ndim`` dims
        (``config.lane_view``)."""
        return KvKnobs(*(lane_view(x, ndim) for x in self))

    def broadcast(self, n_clusters: int) -> "KvKnobs":
        """Per-cluster rows: every field ``[n_clusters]``."""
        return KvKnobs(*(x.expand(n_clusters).clone() for x in self))


class KvState(NamedTuple):
    """A batch's raft state plus the kv service layer, the reference's
    ``KvState`` with a leading cluster axis; its comments explain each
    leaf. The metric leaves (``open_stamp`` .. ``client_lat_hist``) are
    zero-size with metrics off."""

    raft: ClusterState
    clerk_seq: torch.Tensor      # [B, NC]
    clerk_out: torch.Tensor      # [B, NC] bool
    clerk_key: torch.Tensor      # [B, NC]
    clerk_kind: torch.Tensor     # [B, NC]
    clerk_acked: torch.Tensor    # [B, NC]
    clerk_leader: torch.Tensor   # [B, NC]
    clerk_wait: torch.Tensor     # [B, NC]
    open_arr: torch.Tensor       # [B, NC]
    open_srv: torch.Tensor       # [B, NC]
    open_drop: torch.Tensor      # [B, NC]
    open_stamp: torch.Tensor     # [B, NC | 0, OPEN_QUEUE_SLOTS]
    clerk_sub: torch.Tensor      # [B, NC | 0]
    clerk_app: torch.Tensor      # [B, NC | 0]
    clerk_cmt: torch.Tensor      # [B, NC | 0]
    clerk_apl: torch.Tensor      # [B, NC | 0]
    client_retries: torch.Tensor  # [B, NC | 0]
    key_lat_hist: torch.Tensor   # [B, NK | 0, HB]
    client_lat_hist: torch.Tensor  # [B, NC | 0, HB]
    truth_count: torch.Tensor    # [B, NK]
    truth_max_seq: torch.Tensor  # [B, NC]
    clerk_get_lo: torch.Tensor   # [B, NC]
    clerk_get_obs: torch.Tensor  # [B, NC]
    clerk_last_obs: torch.Tensor  # [B, NC]
    gets_done: torch.Tensor      # [B, NC]
    applied: torch.Tensor        # [B, N]
    last_seq: torch.Tensor       # [B, N, NC]
    apply_count: torch.Tensor    # [B, N, NC]
    key_hash: torch.Tensor       # [B, N, NK]
    key_count: torch.Tensor      # [B, N, NK]
    snap_last_seq: torch.Tensor  # [B, N, NC]
    snap_apply_count: torch.Tensor  # [B, N, NC]
    snap_key_hash: torch.Tensor  # [B, N, NK]
    snap_key_count: torch.Tensor  # [B, N, NK]


# the service leaves, in order (KvState's fields after ``raft``)
SERVICE = KvState._fields[1:]
# every leaf of a kv state as one flat name space: the raft leaves, then
# the service leaves (kv_state_to_numpy / first_divergence)
KV_FIELDS = ClusterState._fields + SERVICE


def _pack(cfg: KvConfig, client, seq, key, kind):
    return (((client * _SEQ_LIM + seq) * cfg.n_keys + key) * 4 + kind) + 1


def _unpack(cfg: KvConfig, val):
    """(client, seq, key, kind) of packed ops: floor division and modulo,
    as the reference's ``//`` and ``%`` (an empty slot's 0 gives client
    -1, which the callers clip)."""
    v = val - 1
    kind = torch.remainder(v, 4)
    v = torch.div(v, 4, rounding_mode="floor")
    key = torch.remainder(v, cfg.n_keys)
    cs = torch.div(v, cfg.n_keys, rounding_mode="floor")
    return (torch.div(cs, _SEQ_LIM, rounding_mode="floor"),
            torch.remainder(cs, _SEQ_LIM), key, kind)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (XLA's int32 overflow)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


def _onehot_get(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, R] read at idx [B, m] as the reference's one-hot sum: an
    index outside [0, R) reads 0."""
    r = torch.arange(table.shape[-1], dtype=I32, device=table.device)
    return torch.where(idx[..., None] == r, table[:, None, :], 0).sum(
        -1, dtype=I32)


def init_kv_cluster(cfg: SimConfig, kcfg: KvConfig, keys: torch.Tensor,
                    kn=None) -> KvState:
    """Fresh kv clusters at tick 0, one per key row of ``keys`` [B, 2]."""
    dev = keys.device
    b = keys.shape[0]
    n, nc, nk = cfg.n_nodes, kcfg.n_clients, kcfg.n_keys
    mc = nc if cfg.metrics else 0
    mk = nk if cfg.metrics else 0
    hb = metrics_dims(cfg)[0]

    def full(shape, v=0, dtype=I32):
        return torch.full((b, *shape), v, dtype=dtype, device=dev)

    return KvState(
        raft=init_cluster(cfg, keys, kn),
        clerk_seq=full((nc,)), clerk_out=full((nc,), False, BOOL),
        clerk_key=full((nc,)), clerk_kind=full((nc,)),
        clerk_acked=full((nc,)), clerk_leader=full((nc,), -1),
        clerk_wait=full((nc,)),
        open_arr=full((nc,)), open_srv=full((nc,)), open_drop=full((nc,)),
        open_stamp=full((mc, OPEN_QUEUE_SLOTS)),
        clerk_sub=full((mc,)), clerk_app=full((mc,)), clerk_cmt=full((mc,)),
        clerk_apl=full((mc,)), client_retries=full((mc,)),
        key_lat_hist=full((mk, hb)), client_lat_hist=full((mc, hb)),
        truth_count=full((nk,)), truth_max_seq=full((nc,)),
        clerk_get_lo=full((nc,)), clerk_get_obs=full((nc,), -1),
        clerk_last_obs=full((nc,), -1), gets_done=full((nc,)),
        applied=full((n,)),
        last_seq=full((n, nc)), apply_count=full((n, nc)),
        key_hash=full((n, nk)), key_count=full((n, nk)),
        snap_last_seq=full((n, nc)), snap_apply_count=full((n, nc)),
        snap_key_hash=full((n, nk)), snap_key_count=full((n, nk)),
    )


def _kv_service_tick(cfg: SimConfig, kcfg: KvConfig, ks: KvState,
                     pre_alive: torch.Tensor, pre_base: torch.Tensor,
                     pre_shadow_len: torch.Tensor, s: ClusterState,
                     keys: torch.Tensor, kn: Knobs, kkn: KvKnobs) -> KvState:
    """The service share of one tick for every cluster, given the stepped
    raft state ``s`` and the pre-tick ``alive`` / ``base`` /
    ``shadow_len``: the reference's ``_kv_service_tick`` (its comments
    explain each step), batch-first. Kernel K9's plain version."""
    n, cap = cfg.n_nodes, cfg.log_cap
    nc, nk = kcfg.n_clients, kcfg.n_keys
    dev = s.tick.device
    b = s.tick.shape[0]
    me = torch.arange(n, dtype=I32, device=dev)
    cl_ids = torch.arange(nc, dtype=I32, device=dev)
    k_ids = torch.arange(nk, dtype=I32, device=dev)
    t = s.tick
    t2 = t[:, None]
    key = prng.fold_in(keys, t)
    k1, k2 = kkn.lanes(1), kkn.lanes(2)  # against [B] / [B, m] operands
    metrics = cfg.metrics

    # committed truth per key, deduped (the new shadow lanes this tick)
    sh_abs = lane_abs(s.shadow_base, cap)  # [B, cap]
    sh_client, sh_seq, sh_key, sh_kind = _unpack(kcfg, s.shadow_val)
    sh_client = torch.clamp(sh_client, 0, nc - 1)
    sh_new = ((sh_abs > pre_shadow_len[:, None]) & (sh_abs <= s.shadow_len[:, None])
              & (s.shadow_val != NOOP_CMD))
    cl_oh_sh = sh_client[..., None] == cl_ids  # [B, cap, nc]
    prev_max_at = torch.where(cl_oh_sh, ks.truth_max_seq[:, None, :], 0).sum(
        -1, dtype=I32)
    dup_earlier = (sh_new[:, None, :] & (sh_abs[:, None, :] < sh_abs[:, :, None])
                   & (s.shadow_val[:, None, :] == s.shadow_val[:, :, None])
                   ).any(-1)
    sh_first = sh_new & (sh_seq > prev_max_at) & ~dup_earlier
    truth_count = ks.truth_count + (
        (sh_first & (sh_kind != _GET))[:, None, :]
        & (sh_key[:, None, :] == k_ids[None, :, None])).sum(-1, dtype=I32)
    truth_max_seq = torch.maximum(
        ks.truth_max_seq,
        torch.where(sh_new[..., None] & cl_oh_sh, sh_seq[..., None], 0
                    ).amax(1))

    # 1. crash / restart: the live apply machine resets to the snapshot
    fresh = (~pre_alive & s.alive) | ~s.alive
    f3 = fresh[..., None]
    applied = torch.where(fresh, s.base, ks.applied)
    last_seq = torch.where(f3, ks.snap_last_seq, ks.last_seq)
    apply_count = torch.where(f3, ks.snap_apply_count, ks.apply_count)
    key_hash = torch.where(f3, ks.snap_key_hash, ks.key_hash)
    key_count = torch.where(f3, ks.snap_key_count, ks.key_count)

    # 2. compaction this tick: capture the live tables as the snapshot
    inst = s.snap_installed_src >= 0
    comp = ((s.base != pre_base) & ~inst & s.alive)[..., None]
    snap_last_seq = torch.where(comp, last_seq, ks.snap_last_seq)
    snap_apply_count = torch.where(comp, apply_count, ks.snap_apply_count)
    snap_key_hash = torch.where(comp, key_hash, ks.snap_key_hash)
    snap_key_count = torch.where(comp, key_count, ks.snap_key_count)

    # 3. install-snapshot: adopt the sender's PRE-tick snapshot tables
    src_oh = (me == s.snap_installed_src[..., None])[..., None]  # [B, dst, src, 1]

    def adopt(snap):
        return torch.where(src_oh, snap[:, None, :, :], 0).sum(2, dtype=I32)

    ad = [adopt(x) for x in (ks.snap_last_seq, ks.snap_apply_count,
                             ks.snap_key_hash, ks.snap_key_count)]
    i3 = inst[..., None]
    applied = torch.where(inst, s.base, applied)
    last_seq, apply_count, key_hash, key_count = (
        torch.where(i3, a, x) for a, x in zip(
            ad, (last_seq, apply_count, key_hash, key_count)))
    snap_last_seq, snap_apply_count, snap_key_hash, snap_key_count = (
        torch.where(i3, a, x) for a, x in zip(
            ad, (snap_last_seq, snap_apply_count, snap_key_hash,
                 snap_key_count)))

    # ---------------------------------------------------------- apply machines
    viol = torch.zeros(b, dtype=I32, device=dev)
    limit = torch.where(k2.bug_apply_uncommitted, s.log_len, s.commit)
    clerk_get_obs = ks.clerk_get_obs
    for _ in range(kcfg.apply_max):
        can = s.alive & (applied < limit)
        val = _row_gather(s.log_val, _slot(applied + 1, cap), cap)  # [B, n]
        client, seq, k, kind = _unpack(kcfg, val)
        client = torch.clamp(client, 0, nc - 1)
        is_op = can & (val != NOOP_CMD)
        cl_oh = client[..., None] == cl_ids  # [B, n, nc]
        prev = torch.where(cl_oh, last_seq, 0).sum(-1, dtype=I32)
        dup = seq <= prev
        viol |= torch.where(
            ~k1.bug_stale_read & (is_op & ~dup & (seq > prev + 1)).any(-1),
            VIOLATION_EXACTLY_ONCE, 0).to(I32)
        do = is_op & (k2.bug_skip_dedup | ~dup)
        mut = do & (kind != _GET)
        k_oh = (k[..., None] == k_ids) & mut[..., None]  # [B, n, nk]
        key_hash = torch.where(
            k_oh, _wrap_i32(key_hash.to(torch.int64) * 1000003
                            + val[..., None].to(torch.int64)), key_hash)
        key_count = torch.where(k_oh, key_count + 1, key_count)
        apply_count = torch.where(cl_oh & do[..., None], apply_count + 1,
                                  apply_count)
        last_seq = torch.where(cl_oh & is_op[..., None],
                               torch.maximum(prev, seq)[..., None], last_seq)
        obs_node = torch.where(k[..., None] == k_ids, key_count, 0).sum(
            -1, dtype=I32)  # [B, n]
        get_apply = do & (kind == _GET)
        m = (get_apply[:, None, :] & (client[:, None, :] == cl_ids[None, :, None])
             & (seq[:, None, :] == ks.clerk_seq[:, :, None]))  # [B, nc, n]
        cand = torch.where(m, obs_node[:, None, :], -1).amax(-1)
        clerk_get_obs = torch.where((clerk_get_obs < 0) & (cand >= 0), cand,
                                    clerk_get_obs)
        applied = torch.where(can, applied + 1, applied)

    # exactly-once: ops applied per client == highest seq applied
    viol |= torch.where(
        ~k1.bug_stale_read
        & (s.alive[..., None] & (apply_count != last_seq)).any(-1).any(-1),
        VIOLATION_EXACTLY_ONCE, 0).to(I32)
    # state-machine agreement: equal cursors => identical applied state
    same_cursor = ((applied[:, :, None] == applied[:, None, :])
                   & (applied[:, :, None] > 0)
                   & s.alive[:, :, None] & s.alive[:, None, :])
    hash_eq = ((key_hash[:, :, None, :] == key_hash[:, None, :, :])
               & (key_count[:, :, None, :] == key_count[:, None, :, :])).all(-1)
    viol |= torch.where((same_cursor & ~hash_eq).any(-1).any(-1),
                        VIOLATION_KV_DIVERGE, 0).to(I32)

    # ------------------------------------------------------------------ clerks
    truth_at = _onehot_get(truth_count, ks.clerk_key)  # [B, nc]
    want = _pack(kcfg, cl_ids, ks.clerk_seq, ks.clerk_key, ks.clerk_kind)
    sh_live = sh_abs <= s.shadow_len[:, None]
    in_shadow = ((s.shadow_val[:, None, :] == want[..., None])
                 & sh_live[:, None, :]).any(-1)
    is_get = ks.clerk_kind == _GET
    clerk_cmt, clerk_apl = ks.clerk_cmt, ks.clerk_apl
    if metrics:
        clerk_cmt = torch.where(ks.clerk_out & in_shadow & (clerk_cmt == 0),
                                t2, clerk_cmt)
        clerk_apl = torch.where(ks.clerk_out & (clerk_get_obs >= 0)
                                & (clerk_apl == 0), t2, clerk_apl)
    newly_acked = ks.clerk_out & in_shadow & (~is_get | (clerk_get_obs >= 0))
    done_get = newly_acked & is_get
    viol |= torch.where(
        (done_get & ((clerk_get_obs < ks.clerk_get_lo)
                     | (clerk_get_obs > truth_at))).any(-1),
        VIOLATION_STALE_READ, 0).to(I32)
    clerk_acked = torch.where(newly_acked, ks.clerk_seq, ks.clerk_acked)
    clerk_out = ks.clerk_out & ~newly_acked
    gets_done = ks.gets_done + done_get.to(I32)
    clerk_last_obs = torch.where(done_get, clerk_get_obs, ks.clerk_last_obs)
    r = s
    lat_hist, phase_hist, phase_ticks, lat_ticks = (
        r.lat_hist, r.phase_hist, r.phase_ticks, r.lat_ticks)
    worst = (r.worst_lat, r.worst_phases, r.worst_key, r.worst_client,
             r.worst_sub)
    key_lat_hist, client_lat_hist = ks.key_lat_hist, ks.client_lat_hist
    cl_b = cl_ids.expand(b, nc)
    if metrics:
        e2e = t2 - ks.clerk_sub
        lat_hist = _m.fold_latencies(lat_hist, e2e, newly_acked)
        ph = _m.clerk_phase_matrix(t2, ks.clerk_sub, ks.clerk_app, clerk_cmt,
                                   clerk_apl, is_get)
        phase_hist, phase_ticks, lat_ticks = _m.fold_phases(
            phase_hist, phase_ticks, lat_ticks, ph, e2e, newly_acked)
        worst = _m.update_worst(worst, e2e, newly_acked, ph, ks.clerk_key,
                                cl_b, ks.clerk_sub)
        key_lat_hist = _m.fold_latencies_by(key_lat_hist, e2e, newly_acked,
                                            ks.clerk_key)
        client_lat_hist = _m.fold_latencies_by(client_lat_hist, e2e,
                                               newly_acked, cl_b)

    # start fresh ops / retry pending ones
    kk = prng.split(prng.fold_in(key, _S_CLERK_START), 4)  # [B, 4, 2]
    w_start = prng.bits(kk[:, 0], nc)  # [B, nc] u32 words
    u_start = (((w_start >> 9) | 0x3F800000).to(I32).view(F32) - 1.0)
    openloop = k2.open_queue_cap > 0
    arrive = openloop & (
        (w_start & 0x1FF).to(F32) * (2.0 ** -9) < k2.open_rate)
    drop = arrive & (ks.open_arr - ks.open_srv >= k2.open_queue_cap)
    enq = arrive & ~drop
    open_arr = ks.open_arr + enq.to(I32)
    open_drop = ks.open_drop + drop.to(I32)
    open_stamp = ks.open_stamp
    slots = torch.arange(OPEN_QUEUE_SLOTS, dtype=I32, device=dev)
    if metrics:
        slot_e = slots == torch.remainder(ks.open_arr, OPEN_QUEUE_SLOTS)[..., None]
        open_stamp = torch.where(enq[..., None] & slot_e, t[:, None, None],
                                 ks.open_stamp)
    start = (~clerk_out
             & torch.where(openloop, open_arr > ks.open_srv,
                           u_start < k2.p_op)
             & (ks.clerk_seq < _SEQ_LIM - 1))
    open_srv = ks.open_srv + (openloop & start).to(I32)
    clerk_seq = torch.where(start, ks.clerk_seq + 1, ks.clerk_seq)
    clerk_key = torch.where(
        start, zipf_map(prng.randint(kk[:, 1], nc, 0, nk), nk, k2.zipf_a),
        ks.clerk_key)
    u_kind = prng.uniform(prng.fold_in(key, _S_CLERK_KIND), nc)
    clerk_kind = torch.where(
        start,
        torch.where(u_kind < k2.p_get, _GET,
                    torch.where(u_kind < k2.p_get + k2.p_put, _PUT, _APPEND)),
        ks.clerk_kind).to(I32)
    truth_at_new = _onehot_get(truth_count, clerk_key)
    clerk_get_lo = torch.where(start, truth_at_new, ks.clerk_get_lo)
    clerk_get_obs = torch.where(start, -1, clerk_get_obs)
    clerk_sub, clerk_app = ks.clerk_sub, ks.clerk_app
    if metrics:
        slot_d = slots == torch.remainder(ks.open_srv, OPEN_QUEUE_SLOTS)[..., None]
        arr_t = torch.where(slot_d, open_stamp, 0).sum(-1, dtype=I32)
        clerk_sub = torch.where(start, torch.where(openloop, arr_t, t2),
                                clerk_sub)
        clerk_app = torch.where(start, 0, clerk_app)
        clerk_cmt = torch.where(start, 0, clerk_cmt)
        clerk_apl = torch.where(start, 0, clerk_apl)
    clerk_out = clerk_out | start
    retry = clerk_out & (
        start | (prng.bernoulli(kk[:, 2], kkn.p_retry, nc)
                 & (ks.clerk_wait <= 0)))
    client_retries = ks.client_retries
    if metrics:
        client_retries = client_retries + retry.to(I32)
    target = prng.randint(kk[:, 3], nc, 0, n)
    kk_h = prng.split(prng.fold_in(key, _S_CLERK_HINT), 2)
    follow = (prng.bernoulli(kk_h[:, 0], kkn.p_follow_hint, nc)
              & (ks.clerk_leader >= 0))
    target = torch.where(follow, torch.clamp(ks.clerk_leader, 0, n - 1), target)

    # bug mode: the contacted node serves a Get from its own applied state
    tgt_oh = me == target[..., None]  # [B, nc, n]
    local_cnt = torch.where(
        tgt_oh[..., None] & (k_ids == clerk_key[..., None, None]),
        key_count[:, None, :, :], 0).sum((-1, -2), dtype=I32)  # [B, nc]
    tgt_alive = (tgt_oh & s.alive[:, None, :]).any(-1)
    served = (k2.bug_stale_read & retry & ~start & (clerk_kind == _GET)
              & tgt_alive)
    viol |= torch.where(
        (served & ((local_cnt < clerk_get_lo)
                   | (local_cnt > truth_at_new))).any(-1),
        VIOLATION_STALE_READ, 0).to(I32)
    clerk_acked = torch.where(served, clerk_seq, clerk_acked)
    clerk_out = clerk_out & ~served
    gets_done = gets_done + served.to(I32)
    retry = retry & ~served
    clerk_last_obs = torch.where(served, local_cnt, clerk_last_obs)
    if metrics:
        e2e_s = t2 - clerk_sub
        lat_hist = _m.fold_latencies(lat_hist, e2e_s, served)
        zeros = torch.zeros_like(e2e_s)
        ph_s = torch.stack([zeros, zeros, e2e_s, zeros], dim=-2)
        phase_hist, phase_ticks, lat_ticks = _m.fold_phases(
            phase_hist, phase_ticks, lat_ticks, ph_s, e2e_s, served)
        worst = _m.update_worst(worst, e2e_s, served, ph_s, clerk_key, cl_b,
                                clerk_sub)
        key_lat_hist = _m.fold_latencies_by(key_lat_hist, e2e_s, served,
                                            clerk_key)
        client_lat_hist = _m.fold_latencies_by(client_lat_hist, e2e_s,
                                               served, cl_b)

    violations = s.violations | viol
    first_violation_tick = torch.where(
        (s.first_violation_tick < 0) & (viol != 0), t, s.first_violation_tick)

    # submit: append at the targeted node iff it believes it is the leader,
    # one client after another (client c's append moves the log_len that
    # client c + 1 reads)
    log_term, log_val, log_len = s.log_term, s.log_val, s.log_len
    lane = torch.arange(cap, dtype=I32, device=dev)
    flow_cap = lane_view(kn.flow_cap, 2)
    landed = []
    for c in range(nc):
        ok = ((me == target[:, c:c + 1]) & retry[:, c:c + 1] & s.alive
              & (s.role == LEADER) & (log_len - s.base < cap)
              & (log_len - s.commit < flow_cap))
        v = _pack(kcfg, c, clerk_seq[:, c], clerk_key[:, c], clerk_kind[:, c])
        hit = ok[..., None] & (lane == _slot(log_len + 1, cap)[..., None])
        log_term = torch.where(hit, s.term[..., None], log_term)
        log_val = torch.where(hit, v[:, None, None], log_val)
        log_len = torch.where(ok, log_len + 1, log_len)
        landed.append(ok.any(-1))
    if metrics:
        clerk_app = torch.where(torch.stack(landed, -1) & clerk_out
                                & (clerk_app == 0), t2, clerk_app)

    # the submit's reply teaches the clerk where the leader is
    is_lead_n = s.alive & (s.role == LEADER)  # [B, n]
    any_lead = is_lead_n.any(-1, keepdim=True)
    lead_term = torch.where(is_lead_n, s.term, -1).amax(-1, keepdim=True)
    lead_node = _first_true(is_lead_n & (s.term == lead_term), me)[:, None]
    hint_ok = any_lead & (s.term == lead_term)
    ring = torch.remainder(me + 1, n).expand(b, n)
    ring = torch.where(any_lead & (ring == lead_node),
                       torch.remainder(ring + 1, n), ring)
    hint_n = torch.where(k2.bug_stale_hint, ring,
                         torch.where(hint_ok, lead_node, -1))
    tgt_is_lead = (tgt_oh & is_lead_n[:, None, :]).any(-1)
    tgt_hint = torch.where(tgt_oh, hint_n[:, None, :], 0).sum(-1, dtype=I32)
    clerk_leader = torch.where(
        ~retry, ks.clerk_leader,
        torch.where(tgt_is_lead, target, torch.where(tgt_alive, tgt_hint, -1)))
    clerk_wait = torch.where(retry & tgt_is_lead, k2.retry_wait,
                             torch.clamp(ks.clerk_wait - 1, min=0)).to(I32)

    raft = s._replace(
        log_term=log_term, log_val=log_val, log_len=log_len,
        durable_len=durable_after_append(s, log_len),
        violations=violations, first_violation_tick=first_violation_tick,
        compact_floor=applied,
        lat_hist=lat_hist, phase_hist=phase_hist, phase_ticks=phase_ticks,
        lat_ticks=lat_ticks, worst_lat=worst[0], worst_phases=worst[1],
        worst_key=worst[2], worst_client=worst[3], worst_sub=worst[4],
    )
    return KvState(
        raft=raft, clerk_seq=clerk_seq, clerk_out=clerk_out,
        clerk_key=clerk_key, clerk_kind=clerk_kind, clerk_acked=clerk_acked,
        clerk_leader=clerk_leader, clerk_wait=clerk_wait, open_arr=open_arr,
        open_srv=open_srv, open_drop=open_drop, open_stamp=open_stamp,
        clerk_sub=clerk_sub, clerk_app=clerk_app, clerk_cmt=clerk_cmt,
        clerk_apl=clerk_apl, client_retries=client_retries,
        key_lat_hist=key_lat_hist, client_lat_hist=client_lat_hist,
        truth_count=truth_count, truth_max_seq=truth_max_seq,
        clerk_get_lo=clerk_get_lo, clerk_get_obs=clerk_get_obs,
        clerk_last_obs=clerk_last_obs, gets_done=gets_done, applied=applied,
        last_seq=last_seq, apply_count=apply_count, key_hash=key_hash,
        key_count=key_count, snap_last_seq=snap_last_seq,
        snap_apply_count=snap_apply_count, snap_key_hash=snap_key_hash,
        snap_key_count=snap_key_count,
    )


def kv_step(cfg: SimConfig, kcfg: KvConfig, ks: KvState, keys: torch.Tensor,
            kn: Knobs, kkn: KvKnobs, tick: str = "kernel", table=None,
            ktable=None) -> KvState:
    """One kv tick of every cluster: the raft tick, then the service tick,
    routed by ``engine.tick_route``: on the card one K6-kv launch of one
    tick (``K9.kv_chunk``), with ``table`` / ``ktable`` the knob tables a
    caller running many ticks builds once (``K6.knob_table``,
    ``K9.knob_table``); on the CPU, or with ``tick="eager"``,
    ``step_cluster`` and the plain service tick."""
    from madraft_tpu_torch.tpusim.engine import tick_route

    if tick_route(ks.raft.tick.device, tick) == "kernel":
        return K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn, 1, table, ktable)
    pre = ks.raft
    s = step_cluster(cfg, pre, keys, kn)
    return K9.kv_tick(cfg, kcfg, ks, pre.alive, pre.base, pre.shadow_len, s,
                      keys, kn, kkn, plain=True)


def _advance_kv(cfg: SimConfig, kcfg: KvConfig, ks: KvState,
                keys: torch.Tensor, kn: Knobs, kkn: KvKnobs, n_ticks: int,
                tick: str = "kernel") -> KvState:
    """n_ticks kv ticks, routed as ``kv_step`` says: on the card K6-kv
    launches of up to ``engine.KERNEL_CHUNK`` ticks (both knob tables
    built once here), else a ``kv_step`` a tick. Every kv run goes through
    this function, so ``functools.partial(_advance_kv, tick="eager")`` in
    its place runs a whole program on the eager route (the A/B's
    baseline)."""
    from madraft_tpu_torch.tpusim.engine import KERNEL_CHUNK, tick_route

    if tick_route(ks.raft.tick.device, tick) == "kernel":
        b = keys.shape[0]
        table = K6.knob_table(kn, b)
        ktable = K9.knob_table(kn, kkn, b)
        for done in range(0, n_ticks, KERNEL_CHUNK):
            ks = K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn,
                             min(KERNEL_CHUNK, n_ticks - done), table,
                             ktable)
        return ks
    for _ in range(n_ticks):
        ks = kv_step(cfg, kcfg, ks, keys, kn, kkn, tick)
    return ks


# ------------------------------------------------------------------- drivers
class KvFuzzReport(NamedTuple):
    """Host-side summary of one kv fuzz run, the reference's fields."""

    violations: np.ndarray
    first_violation_tick: np.ndarray
    acked_ops: np.ndarray
    acked_gets: np.ndarray
    committed: np.ndarray
    msg_count: np.ndarray
    snap_installs: np.ndarray
    lat_hist: Optional[np.ndarray] = None
    ev_counts: Optional[np.ndarray] = None
    phase_hist: Optional[np.ndarray] = None
    phase_ticks: Optional[np.ndarray] = None
    lat_ticks: Optional[np.ndarray] = None
    key_hist: Optional[np.ndarray] = None
    client_hist: Optional[np.ndarray] = None
    client_retries: Optional[np.ndarray] = None
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


def kv_report(final: KvState) -> KvFuzzReport:
    r = final.raft
    has_metrics = r.lat_hist.numel() > 0

    def h(x):
        return x.cpu().numpy()

    def m(x):
        return h(x) if has_metrics else None

    return KvFuzzReport(
        violations=h(r.violations),
        first_violation_tick=h(r.first_violation_tick),
        acked_ops=h(final.clerk_acked.sum(-1, dtype=I32)),
        acked_gets=h(final.gets_done.sum(-1, dtype=I32)),
        committed=h(r.shadow_len),
        msg_count=h(r.msg_count),
        snap_installs=h(r.snap_install_count),
        lat_hist=m(r.lat_hist), ev_counts=m(r.ev_counts),
        phase_hist=m(r.phase_hist), phase_ticks=m(r.phase_ticks),
        lat_ticks=m(r.lat_ticks), key_hist=m(final.key_lat_hist),
        client_hist=m(final.client_lat_hist),
        client_retries=m(final.client_retries),
        worst_lat=m(r.worst_lat), worst_phases=m(r.worst_phases),
        worst_key=m(r.worst_key), worst_client=m(r.worst_client),
        worst_sub=m(r.worst_sub),
    )


class KvFuzzProgram:
    """``fn(seed) -> final batched KvState`` for one config and shape, the
    ``engine.FuzzProgram`` interface (``compile_timed`` builds the kernels,
    the run's K6-kv build among them, before the first tick).
    ``kn`` / ``kkn`` override the configs' knobs (the sweep's [B] rows)."""

    def __init__(self, cfg: SimConfig, kcfg: KvConfig, n_clusters: int,
                 n_ticks: int, device, kn: Optional[Knobs] = None,
                 kkn: Optional[KvKnobs] = None):
        from madraft_tpu_torch.tpusim.engine import (
            _validate_knobs,
            check_card_shape,
            resolve_device,
        )

        check_service_cfg(cfg, "KV")
        self.cfg, self.kcfg = cfg, kcfg
        self.n_clusters, self.n_ticks = n_clusters, n_ticks
        self.device = resolve_device(device)
        check_card_shape(self.device, cfg, K9, kcfg)
        self.kn = cfg.knobs(self.device) if kn is None else kn.to(self.device)
        self.kkn = (kcfg.knobs(self.device) if kkn is None
                    else kkn.to(self.device))
        _validate_knobs(self.kn)
        _validate_kv_knobs(self.kkn)
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        from madraft_tpu_torch.tpusim.engine import _build_kernels

        if self.compile_s is None:
            self.compile_s = _build_kernels(
                self.device, self.cfg.metrics,
                extra=(K6.variant(self.cfg.metrics, False, kv=True),))
        return self.compile_s

    def __call__(self, seed) -> KvState:
        from madraft_tpu_torch.tpusim.engine import cluster_keys

        keys = cluster_keys(seed, self.n_clusters, self.device)
        ks = init_kv_cluster(self.cfg, self.kcfg, keys, self.kn)
        return _advance_kv(self.cfg, self.kcfg, ks, keys, self.kn, self.kkn,
                           self.n_ticks)


def make_kv_fuzz_fn(cfg: SimConfig, kcfg: KvConfig, n_clusters: int,
                    n_ticks: int, device=None) -> KvFuzzProgram:
    """Build fn(seed) -> final batched KvState (uniform knobs)."""
    return KvFuzzProgram(cfg, kcfg, n_clusters, n_ticks, device)


def kv_fuzz(cfg: SimConfig, kcfg: KvConfig, seed: int, n_clusters: int,
            n_ticks: int, device=None) -> KvFuzzReport:
    """Fuzz the kv service over n_clusters independent clusters; cluster c
    draws from fold_in(PRNGKey(seed), c)."""
    return kv_report(make_kv_fuzz_fn(cfg, kcfg, n_clusters, n_ticks,
                                     device)(seed))


def _validate_kv_knobs(kkn: KvKnobs) -> None:
    """Eager rejection of service-knob values that would silently misbehave
    in the tick, in the reference's words."""
    from madraft_tpu_torch.tpusim.engine import (
        validate_bool_bugs,
        validate_probs,
    )

    k = KvKnobs(*(x.cpu().numpy() for x in kkn))
    validate_probs(
        k, ("p_op", "p_get", "p_put", "p_retry", "p_follow_hint",
            "open_rate"), "kv")
    if (k.p_get + k.p_put > 1.0).any():
        raise ValueError(
            "p_get + p_put must stay <= 1 per cluster (one uniform draw "
            "splits Get/Put/Append)"
        )
    if ((k.open_queue_cap < 0) | (k.open_queue_cap > OPEN_QUEUE_SLOTS)).any():
        raise ValueError(
            f"open_queue_cap must stay in [0, {OPEN_QUEUE_SLOTS}] (the "
            "arrival-stamp ring size; 0 = closed loop)"
        )
    if (k.zipf_a < 1.0).any():
        raise ValueError(
            "zipf_a must be >= 1.0 (1.0 = the uniform key draw; larger "
            "values skew toward key 0)"
        )
    validate_bool_bugs(
        k, ("bug_skip_dedup", "bug_apply_uncommitted", "bug_stale_read",
            "bug_stale_hint"), "kv")


def make_kv_sweep_fn(cfg: SimConfig, knobs: Knobs, kknobs: KvKnobs,
                     kcfg: KvConfig, n_clusters: int, n_ticks: int,
                     device=None) -> KvFuzzProgram:
    """Like make_kv_fuzz_fn, but every cluster runs its own raft AND kv
    knob row (fields 0-d or [n_clusters]): workload mixes and planted
    bugs become per-cluster data in one run."""
    from madraft_tpu_torch.tpusim.engine import (
        _validate_knobs,
        resolve_device,
        validate_service_raft_knobs,
    )

    check_service_cfg(cfg, "KV")
    dev = resolve_device(device)
    knobs, kknobs = knobs.to(dev), kknobs.to(dev)
    _validate_knobs(knobs)
    validate_service_raft_knobs(knobs)
    _validate_kv_knobs(kknobs)
    return KvFuzzProgram(cfg, kcfg, n_clusters, n_ticks, dev,
                         kn=knobs.broadcast(n_clusters),
                         kkn=kknobs.broadcast(n_clusters))


def kv_replay_cluster(cfg: SimConfig, kcfg: KvConfig, seed: int,
                      cluster_id: int, n_ticks: int, device=None) -> KvState:
    """Re-run one cluster alone from its (seed, cluster_id) stream; its
    final state with a batch axis of 1."""
    from madraft_tpu_torch.tpusim.engine import (
        check_card_shape,
        cluster_keys,
        resolve_device,
    )

    check_service_cfg(cfg, "KV")
    dev = resolve_device(device)
    check_card_shape(dev, cfg, K9, kcfg)
    kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
    keys = cluster_keys(seed, 1, dev, id0=int(cluster_id))
    ks = init_kv_cluster(cfg, kcfg, keys, kn)
    return _advance_kv(cfg, kcfg, ks, keys, kn, kkn, n_ticks)


# ---------------------------------------------------------- carry-across
# a kv state as one flat mapping of field -> host numpy array (KV_FIELDS:
# the raft leaves by their names, then the service leaves), and back
kv_state_to_numpy = service_state_to_numpy


def kv_state_from_numpy(arrays: dict, device=None) -> KvState:
    """``state.service_state_from_numpy`` of a ``KvState``."""
    return service_state_from_numpy(KvState, arrays, device)


def first_divergence(tick: int, want: dict, got: dict):
    """``state.first_divergence`` over every kv leaf (``KV_FIELDS``)."""
    from madraft_tpu_torch.tpusim.state import first_divergence as _first

    return _first(tick, want, got, KV_FIELDS)
