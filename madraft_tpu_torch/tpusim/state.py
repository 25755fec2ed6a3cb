"""The state of a batch of simulated Raft clusters as tensors.

``ClusterState`` has the reference's fields in the reference's order
(``madraft_tpu/tpusim/state.py`` ``ClusterState``), each with a leading
cluster axis: where the reference's single-cluster leaf is ``[N]`` the
port's is ``[B, N]``, and a scalar becomes ``[B]``. Integers are int32 and
flags bool, as there. The metric leaves (``log_tick`` .. ``worst_sub``)
have the shapes of ``config.metrics_dims``: zero-size with metrics off.

The log is the reference's canonical ring: absolute (1-based) index ``a``
lives in lane ``(a - 1) mod log_cap``; ``base`` is the snapshot boundary.

``PackedClusterState`` is the reference's packed schema, batch-first, with
its dtypes: narrow integers sized by ``config.packed_bounds``, tick-relative
u8 mailbox stamps, bitfield words for role, alive and the [n, n] flags.
``pack_state``/``unpack_state`` here are the plain versions of kernel K3
(``kernels/pack.py``); the round trip is exact for every state inside the
bounds, which ``packed_layout_reason`` checks for a run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    FOLLOWER,
    NOOP_CMD,
    SimConfig,
    metrics_dims,
    packed_bounds,
)

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool
U8 = torch.uint8
U16 = torch.uint16
U32 = torch.uint32

# The reference's trace/replay artifact schema version (its state.py);
# metrics-off leaves match it.
STATE_SCHEMA_VERSION = 4


class ClusterState(NamedTuple):
    """All tensors of a batch of B clusters (leading axis B)."""

    tick: torch.Tensor            # [B] current tick
    term: torch.Tensor            # [B, N] current term (persistent)
    voted_for: torch.Tensor       # [B, N] -1 = none (persistent)
    role: torch.Tensor            # [B, N] 0 follower / 1 candidate / 2 leader
    timer: torch.Tensor           # [B, N] ticks until election timeout
    hb: torch.Tensor              # [B, N] ticks until next leader heartbeat
    alive: torch.Tensor           # [B, N] bool
    limp: torch.Tensor            # [B, N] send-delay multiplier (1 = healthy)
    fsync_stall: torch.Tensor     # [B, N] ticks the background fsync stalls
    log_term: torch.Tensor        # [B, N, CAP]
    log_val: torch.Tensor         # [B, N, CAP]
    log_len: torch.Tensor         # [B, N] absolute length
    base: torch.Tensor            # [B, N] snapshot boundary
    snap_term: torch.Tensor       # [B, N] term at index base
    prefix_hash: torch.Tensor     # [B, N] hash of entries 1..base
    commit: torch.Tensor          # [B, N] committed count (absolute)
    durable_len: torch.Tensor     # [B, N] fsync watermark of the log
    durable_term: torch.Tensor    # [B, N] fsynced term
    durable_voted_for: torch.Tensor  # [B, N] fsynced vote
    compact_floor: torch.Tensor   # [B, N] service cap on the boundary
    votes: torch.Tensor           # [B, N, N] bool: candidate i holds j's grant
    next_idx: torch.Tensor        # [B, N, N]
    match_idx: torch.Tensor       # [B, N, N]
    adj: torch.Tensor             # [B, N, N] bool, [dst, src] link usable
    rv_req_t: torch.Tensor        # [B, N, N] mailboxes [dst, src]; 0 = empty
    rv_req_term: torch.Tensor
    rv_req_lli: torch.Tensor
    rv_req_llt: torch.Tensor
    rv_rsp_t: torch.Tensor
    rv_rsp_term: torch.Tensor
    rv_rsp_granted: torch.Tensor  # bool
    ae_req_t: torch.Tensor
    ae_req_term: torch.Tensor
    ae_req_prev: torch.Tensor
    ae_req_prev_term: torch.Tensor
    ae_req_n: torch.Tensor
    ae_req_commit: torch.Tensor
    ae_rsp_t: torch.Tensor
    ae_rsp_term: torch.Tensor
    ae_rsp_success: torch.Tensor  # bool
    ae_rsp_match: torch.Tensor
    sn_req_t: torch.Tensor
    sn_req_term: torch.Tensor
    snap_installed_src: torch.Tensor  # [B, N] src installed from (-1)
    snap_installed_len: torch.Tensor  # [B, N]
    next_cmd: torch.Tensor        # [B] per-cluster command counter
    shadow_term: torch.Tensor     # [B, CAP] committed-entry shadow
    shadow_val: torch.Tensor      # [B, CAP]
    shadow_base: torch.Tensor     # [B]
    shadow_len: torch.Tensor      # [B]
    shadow_prefix_hash: torch.Tensor  # [B]
    violations: torch.Tensor      # [B] sticky bitmask
    first_violation_tick: torch.Tensor  # [B] -1 = none
    first_leader_tick: torch.Tensor     # [B] -1 = none
    msg_count: torch.Tensor       # [B] delivered messages
    snap_install_count: torch.Tensor  # [B]
    # metrics plane (config.metrics_dims; zero-size with metrics off)
    log_tick: torch.Tensor        # [B, N, CAP] submit stamp of each entry
    #                               (0 = no-op or not a client command)
    shadow_sub: torch.Tensor      # [B, CAP] this tick's shadow-record
    #                               stamps (a per-tick scratch)
    lat_hist: torch.Tensor        # [B, HB] submit->commit latency buckets
    ev_counts: torch.Tensor       # [B, len(METRIC_EVENTS)] event counters
    phase_hist: torch.Tensor      # [B, P, HB] per-phase histograms
    phase_ticks: torch.Tensor     # [B, P] exact ticks per phase
    lat_ticks: torch.Tensor       # [B, 1] exact latency ticks
    worst_lat: torch.Tensor       # [B, 1] the worst op's latency
    worst_phases: torch.Tensor    # [B, P] its phases
    worst_key: torch.Tensor       # [B, 1] its key (-1: raft command)
    worst_client: torch.Tensor    # [B, 1] its client (-1: raft command)
    worst_sub: torch.Tensor       # [B, 1] its submit tick (0 = empty)


# the metric leaves are ClusterState's last fields, from this index on
METRIC_LEAF0 = ClusterState._fields.index("log_tick")


def term_rank_commit_delta(term, commit, term_rank_levels: int,
                           commit_delta_levels: int) -> tuple:
    """The quantized term order and commit lag of node rows [B, n]: the
    count of nodes with a strictly smaller term, and commit - min(commit),
    each clipped below its level count."""
    rank = torch.clamp(
        (term[:, None, :] < term[:, :, None]).sum(-1, dtype=I32),
        0, term_rank_levels - 1)
    delta = torch.clamp(commit - commit.amin(-1, keepdim=True),
                        0, commit_delta_levels - 1)
    return rank, delta


def abstract_node_tuple(s: ClusterState, term_rank_levels: int,
                        commit_delta_levels: int) -> tuple:
    """The per-node abstract state the coverage fingerprint folds (the
    reference's ``abstract_node_tuple``, whose docstring explains it):
    role, alive, term-rank and commit-delta, four int32 [B, n] tensors."""
    rank, delta = term_rank_commit_delta(s.term, s.commit, term_rank_levels,
                                         commit_delta_levels)
    return s.role, s.alive.to(I32), rank, delta


def init_cluster(cfg: SimConfig, keys: torch.Tensor, kn=None) -> ClusterState:
    """Fresh clusters at tick 0, one per key row of ``keys`` [B, 2], with
    election timers drawn by ``randint`` like the reference's init; ``kn``
    may hold [B] knob rows (one value a cluster)."""
    dev = keys.device
    if kn is None:
        kn = cfg.knobs(dev)
    b = keys.shape[0]
    n, cap = cfg.n_nodes, cfg.log_cap
    hb, evn, mcap, nph, reg = metrics_dims(cfg)

    def full(shape, v, dtype=I32):
        return torch.full((b, *shape), v, dtype=dtype, device=dev)

    k2 = kn.lanes(2)  # a knob row meets the [B, n] draws as [B, 1]
    timer = prng.randint(keys, n, k2.eto_min, k2.eto_max + 1) \
        + torch.arange(n, dtype=I32, device=dev) * k2.eto_skew.to(I32)
    return ClusterState(
        tick=full((), 0),
        term=full((n,), 0),
        voted_for=full((n,), -1),
        role=full((n,), FOLLOWER),
        timer=timer.to(I32),
        hb=full((n,), 0),
        alive=full((n,), True, BOOL),
        limp=full((n,), 1),
        fsync_stall=full((n,), 0),
        log_term=full((n, cap), 0),
        log_val=full((n, cap), 0),
        log_len=full((n,), 0),
        base=full((n,), 0),
        snap_term=full((n,), 0),
        prefix_hash=full((n,), 0),
        commit=full((n,), 0),
        durable_len=full((n,), 0),
        durable_term=full((n,), 0),
        durable_voted_for=full((n,), -1),
        compact_floor=full((n,), 0),
        votes=full((n, n), False, BOOL),
        next_idx=full((n, n), 1),
        match_idx=full((n, n), 0),
        adj=full((n, n), True, BOOL),
        rv_req_t=full((n, n), 0), rv_req_term=full((n, n), 0),
        rv_req_lli=full((n, n), 0), rv_req_llt=full((n, n), 0),
        rv_rsp_t=full((n, n), 0), rv_rsp_term=full((n, n), 0),
        rv_rsp_granted=full((n, n), False, BOOL),
        ae_req_t=full((n, n), 0), ae_req_term=full((n, n), 0),
        ae_req_prev=full((n, n), 0), ae_req_prev_term=full((n, n), 0),
        ae_req_n=full((n, n), 0), ae_req_commit=full((n, n), 0),
        ae_rsp_t=full((n, n), 0), ae_rsp_term=full((n, n), 0),
        ae_rsp_success=full((n, n), False, BOOL),
        ae_rsp_match=full((n, n), 0),
        sn_req_t=full((n, n), 0),
        sn_req_term=full((n, n), 0),
        snap_installed_src=full((n,), -1),
        snap_installed_len=full((n,), 0),
        next_cmd=full((), 0),
        shadow_term=full((cap,), 0),
        shadow_val=full((cap,), 0),
        shadow_base=full((), 0),
        shadow_len=full((), 0),
        shadow_prefix_hash=full((), 0),
        violations=full((), 0),
        first_violation_tick=full((), -1),
        first_leader_tick=full((), -1),
        msg_count=full((), 0),
        snap_install_count=full((), 0),
        log_tick=full((n, mcap), 0),
        shadow_sub=full((mcap,), 0),
        lat_hist=full((hb,), 0),
        ev_counts=full((evn,), 0),
        phase_hist=full((nph, hb), 0),
        phase_ticks=full((nph,), 0),
        lat_ticks=full((reg,), 0),
        worst_lat=full((reg,), 0),
        worst_phases=full((nph,), 0),
        worst_key=full((reg,), -1),
        worst_client=full((reg,), -1),
        worst_sub=full((reg,), 0),
    )


def tree_bytes(s) -> int:
    """Total bytes of every leaf of a wide or packed state, or of a state
    that nests one (the kv state's raft part): the state-footprint
    telemetry, live buffer sizes, never a schema estimate."""
    return int(sum(tree_bytes(x) if isinstance(x, tuple)
                   else x.numel() * x.element_size() for x in s))


def durable_after_append(s: ClusterState, new_len: torch.Tensor
                         ) -> torch.Tensor:
    """The fsync watermark after a service layer's submits: it follows the
    log where the log grew (persist at append, the reference's rule)."""
    return torch.where(new_len > s.log_len, new_len, s.durable_len)


def state_from_numpy(arrays, device=None) -> ClusterState:
    """A ``ClusterState`` from numpy arrays with a leading cluster axis, in
    field order or as a mapping of field -> array (e.g. a JAX state batch
    converted with ``np.asarray`` leaf by leaf). Dtypes are checked, not
    cast: int32 and bool leaves only."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in ClusterState._fields]
    arrays = list(arrays)
    if len(arrays) != len(ClusterState._fields):
        raise ValueError(
            f"expected {len(ClusterState._fields)} leaves, got {len(arrays)}")
    out = []
    for name, a in zip(ClusterState._fields, arrays):
        a = np.asarray(a)
        if a.dtype not in (np.int32, np.bool_):
            raise ValueError(f"leaf {name} has dtype {a.dtype}, not int32/bool")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return ClusterState(*out)


def state_to_numpy(s: ClusterState) -> dict:
    """field -> numpy array (on the host), the inverse of state_from_numpy."""
    return {f: getattr(s, f).cpu().numpy() for f in ClusterState._fields}


def service_state_to_numpy(ks) -> dict:
    """A service layer's state (``raft``, then the service leaves: a
    ``kv.KvState`` or ``ctrler.CtrlerState``) as one flat mapping of field
    -> host numpy array, the raft leaves by their names, then the service
    leaves."""
    out = state_to_numpy(ks.raft)
    out.update({f: getattr(ks, f).cpu().numpy() for f in ks._fields[1:]})
    return out


def service_state_from_numpy(cls, arrays: dict, device=None):
    """The inverse of ``service_state_to_numpy``: a state of the service
    state class ``cls`` from a flat mapping of field -> array with a
    leading cluster axis (e.g. a JAX service state's leaves through
    ``np.asarray``). int32 and bool leaves only."""
    raft = state_from_numpy({f: arrays[f] for f in ClusterState._fields},
                            device)
    service = []
    for name in cls._fields[1:]:
        a = np.asarray(arrays[name])
        if a.dtype not in (np.int32, np.bool_):
            raise ValueError(f"leaf {name} has dtype {a.dtype}, not int32/bool")
        service.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return cls(raft, *service)


def nested_state_to_numpy(st, clusters: tuple) -> dict:
    """A service state that nests several ``ClusterState``s (the shardkv
    state's ``rafts`` and ``ctrl``) as one flat mapping of field -> host
    numpy array: each nested cluster's leaves as ``<name>.<field>``, then
    the other leaves by their names."""
    out = {}
    for c in clusters:
        out.update({f"{c}.{f}": a
                    for f, a in state_to_numpy(getattr(st, c)).items()})
    out.update({f: getattr(st, f).cpu().numpy() for f in st._fields
                if f not in clusters})
    return out


def nested_state_from_numpy(cls, arrays: dict, clusters: tuple,
                            device=None):
    """The inverse of ``nested_state_to_numpy``: a state of class ``cls``
    from a flat mapping with a leading batch axis. int32 and bool leaves
    only; a nested cluster's leaves keep their shapes."""
    kw = {c: state_from_numpy({f: arrays[f"{c}.{f}"]
                               for f in ClusterState._fields}, device)
          for c in clusters}
    for name in cls._fields:
        if name in clusters:
            continue
        a = np.asarray(arrays[name])
        if a.dtype not in (np.int32, np.bool_):
            raise ValueError(f"leaf {name} has dtype {a.dtype}, not int32/bool")
        kw[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return cls(**kw)


def first_divergence(tick: int, want: dict, got: dict,
                     fields=ClusterState._fields):
    """The first leaf, in ``fields`` order, where two host states (field ->
    array with a leading cluster axis) differ in dtype, shape or any value.
    Returns None when they are identical, else a dict naming the tick, the
    leaf, the diverging clusters and the first one's two values — what a
    parity failure should print."""
    for name in fields:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        if a.dtype != b.dtype or a.shape != b.shape:
            return {"tick": tick, "leaf": name,
                    "want": f"{a.dtype}{list(a.shape)}",
                    "got": f"{b.dtype}{list(b.shape)}"}
        if not np.array_equal(a, b):
            diff = (a != b).reshape(a.shape[0], -1).any(-1)
            clusters = np.nonzero(diff)[0]
            c = int(clusters[0])
            return {"tick": tick, "leaf": name,
                    "clusters": clusters.tolist(), "cluster": c,
                    "want": a[c].tolist(), "got": b[c].tolist()}
    return None


def packed_state_from_numpy(arrays, device=None) -> "PackedClusterState":
    """A ``PackedClusterState`` from numpy arrays with a leading cluster
    axis (field order or field -> array). Each leaf keeps its own dtype
    (u8/u16/u32/i8/i16/i32), nothing is cast."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in PackedClusterState._fields]
    arrays = list(arrays)
    if len(arrays) != len(PackedClusterState._fields):
        raise ValueError(f"expected {len(PackedClusterState._fields)} "
                         f"leaves, got {len(arrays)}")
    return PackedClusterState(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))


def packed_state_to_numpy(p: "PackedClusterState") -> dict:
    """field -> numpy array (on the host), dtypes kept."""
    return {f: getattr(p, f).cpu().numpy() for f in PackedClusterState._fields}


# ---------------------------------------------------------------------------
# The packed schema (the reference's state.py PackedSpec .. unpack_state).
# ---------------------------------------------------------------------------


class PackedSpec(NamedTuple):
    """Derived dtypes of the packed schema for one SimConfig."""

    tick: torch.dtype         # tick / next_cmd
    term: torch.dtype         # every term-valued field
    index: torch.dtype        # every absolute log-index field
    cmd: torch.dtype          # log_val / shadow_val payloads
    noop_code: int            # the cmd dtype's reserved encoding of NOOP_CMD
    tick_signed: torch.dtype  # first_violation_tick / first_leader_tick
    event: torch.dtype        # ev_counts


_UINTS = ((U8, 255), (U16, 65535), (U32, 2**32 - 1))
_SINTS = ((torch.int8, 127), (torch.int16, 32767), (I32, 2**31 - 1))


def _uint_for(bound: int) -> torch.dtype:
    """Smallest unsigned dtype holding [0, bound]."""
    for dt, hi in _UINTS:
        if bound <= hi:
            return dt
    raise ValueError(f"packed bound {bound} exceeds u32")


def _sint_for(bound: int) -> torch.dtype:
    """Smallest signed dtype holding [-1, bound]."""
    for dt, hi in _SINTS:
        if bound <= hi:
            return dt
    raise ValueError(f"packed bound {bound} exceeds i32")


@functools.lru_cache(maxsize=None)
def packed_spec_for(cfg: SimConfig, index_bound: Optional[int] = None,
                    cmd_bound: Optional[int] = None) -> PackedSpec:
    """PackedSpec with the index/cmd bounds optionally overridden (the
    reference's service-layer hook); both None is the raft-layer spec."""
    b = packed_bounds(cfg)
    cmd_dt = _uint_for((b.cmd if cmd_bound is None else cmd_bound) + 1)
    # + 1 reserves a distinct NOOP sentinel: the cmd dtype's max
    return PackedSpec(
        tick=_uint_for(b.tick),
        term=_uint_for(b.term),
        index=_uint_for(b.index if index_bound is None else index_bound),
        cmd=cmd_dt,
        noop_code=dict(_UINTS)[cmd_dt],
        tick_signed=_sint_for(b.tick),
        event=_uint_for(b.event),
    )


def packed_spec(cfg: SimConfig) -> PackedSpec:
    return packed_spec_for(cfg)


class PackedClusterState(NamedTuple):
    """ClusterState in the packed schema, leading axis B (field order
    mirrors the wide form; ``_bits`` = bitfield word(s), ``_rel`` =
    tick-relative u8 stamp)."""

    tick: torch.Tensor
    term: torch.Tensor
    voted_for: torch.Tensor        # i8, -1 sentinel intact
    role_bits: torch.Tensor        # u32 [B]: 2 bits per node
    timer: torch.Tensor            # u16
    hb: torch.Tensor               # u16
    alive_bits: torch.Tensor       # u32 [B] bitfield
    limp: torch.Tensor             # u8
    fsync_stall: torch.Tensor      # u16
    log_term: torch.Tensor
    log_val: torch.Tensor          # cmd dtype; NOOP_CMD -> noop_code
    log_len: torch.Tensor
    base: torch.Tensor
    snap_term: torch.Tensor
    prefix_hash: torch.Tensor      # i32
    commit: torch.Tensor
    durable_len: torch.Tensor
    durable_term: torch.Tensor
    durable_voted_for: torch.Tensor  # i8
    compact_floor: torch.Tensor
    votes_bits: torch.Tensor       # u32 [B, n] row masks
    next_idx: torch.Tensor
    match_idx: torch.Tensor
    adj_bits: torch.Tensor         # u32 [B, n] row masks
    rv_req_rel: torch.Tensor
    rv_req_term: torch.Tensor
    rv_req_lli: torch.Tensor
    rv_req_llt: torch.Tensor
    rv_rsp_rel: torch.Tensor
    rv_rsp_term: torch.Tensor
    rv_rsp_granted_bits: torch.Tensor  # u32 [B, n]
    ae_req_rel: torch.Tensor
    ae_req_term: torch.Tensor
    ae_req_prev: torch.Tensor
    ae_req_prev_term: torch.Tensor
    ae_req_n: torch.Tensor         # u8
    ae_req_commit: torch.Tensor
    ae_rsp_rel: torch.Tensor
    ae_rsp_term: torch.Tensor
    ae_rsp_success_bits: torch.Tensor  # u32 [B, n]
    ae_rsp_match: torch.Tensor
    sn_req_rel: torch.Tensor
    sn_req_term: torch.Tensor
    snap_installed_src: torch.Tensor   # i8, -1 sentinel intact
    snap_installed_len: torch.Tensor
    next_cmd: torch.Tensor
    shadow_term: torch.Tensor
    shadow_val: torch.Tensor       # cmd dtype; NOOP_CMD -> noop_code
    shadow_base: torch.Tensor
    shadow_len: torch.Tensor
    shadow_prefix_hash: torch.Tensor   # i32
    violations: torch.Tensor           # i32
    first_violation_tick: torch.Tensor  # tick_signed
    first_leader_tick: torch.Tensor     # tick_signed
    msg_count: torch.Tensor            # i32
    snap_install_count: torch.Tensor   # i32
    # metrics plane: zero-size with metrics off
    log_tick: torch.Tensor
    shadow_sub: torch.Tensor
    lat_hist: torch.Tensor
    ev_counts: torch.Tensor
    phase_hist: torch.Tensor
    phase_ticks: torch.Tensor
    lat_ticks: torch.Tensor
    worst_lat: torch.Tensor
    worst_phases: torch.Tensor
    worst_key: torch.Tensor
    worst_client: torch.Tensor
    worst_sub: torch.Tensor


def _bit_weights(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=I64, device=device) << torch.arange(
        n, dtype=I64, device=device)


def _pack_bool_rows(mat: torch.Tensor) -> torch.Tensor:
    """[..., n, n] bool -> [..., n] u32 row masks (bit j of row i =
    mat[..., i, j]). Sums in int64: the CPU's UInt32 has no sum."""
    w = _bit_weights(mat.shape[-1], mat.device)
    return torch.where(mat, w, 0).sum(-1).to(U32)


def _unpack_bool_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] u32 row masks -> [..., n, n] bool."""
    idx = torch.arange(n, dtype=I64, device=rows.device)
    return ((rows.to(I64)[..., None] >> idx) & 1).to(BOOL)


def _lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] per-cluster value shaped to broadcast against ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def pack_state(cfg: SimConfig, s: ClusterState,
               sp: Optional[PackedSpec] = None) -> PackedClusterState:
    """Wide -> packed, exact for every value within config.packed_bounds;
    the plain version of kernel K3's pack. The bitfields and stamps are
    computed in int64 and cast last."""
    if sp is None:
        sp = packed_spec(cfg)
    n = cfg.n_nodes
    t = s.tick.to(I64)
    idx = torch.arange(n, dtype=I64, device=t.device)

    def rel(stamp):  # live stamps are strictly in the future (> tick)
        st = stamp.to(I64)
        return torch.where(st > 0, st - _lanes(t, st), 0).to(U8)

    def cmd(v):
        return torch.where(v == NOOP_CMD, sp.noop_code, v.to(I64)).to(sp.cmd)

    return PackedClusterState(
        tick=s.tick.to(sp.tick),
        term=s.term.to(sp.term),
        voted_for=s.voted_for.to(torch.int8),
        role_bits=(s.role.to(I64) << (2 * idx)).sum(-1).to(U32),
        timer=s.timer.to(U16),
        hb=s.hb.to(U16),
        alive_bits=torch.where(s.alive, _bit_weights(n, t.device), 0)
        .sum(-1).to(U32),
        limp=s.limp.to(U8),
        fsync_stall=s.fsync_stall.to(U16),
        log_term=s.log_term.to(sp.term),
        log_val=cmd(s.log_val),
        log_len=s.log_len.to(sp.index),
        base=s.base.to(sp.index),
        snap_term=s.snap_term.to(sp.term),
        prefix_hash=s.prefix_hash.clone(),
        commit=s.commit.to(sp.index),
        durable_len=s.durable_len.to(sp.index),
        durable_term=s.durable_term.to(sp.term),
        durable_voted_for=s.durable_voted_for.to(torch.int8),
        compact_floor=s.compact_floor.to(sp.index),
        votes_bits=_pack_bool_rows(s.votes),
        next_idx=s.next_idx.to(sp.index),
        match_idx=s.match_idx.to(sp.index),
        adj_bits=_pack_bool_rows(s.adj),
        rv_req_rel=rel(s.rv_req_t),
        rv_req_term=s.rv_req_term.to(sp.term),
        rv_req_lli=s.rv_req_lli.to(sp.index),
        rv_req_llt=s.rv_req_llt.to(sp.term),
        rv_rsp_rel=rel(s.rv_rsp_t),
        rv_rsp_term=s.rv_rsp_term.to(sp.term),
        rv_rsp_granted_bits=_pack_bool_rows(s.rv_rsp_granted),
        ae_req_rel=rel(s.ae_req_t),
        ae_req_term=s.ae_req_term.to(sp.term),
        ae_req_prev=s.ae_req_prev.to(sp.index),
        ae_req_prev_term=s.ae_req_prev_term.to(sp.term),
        ae_req_n=s.ae_req_n.to(U8),
        ae_req_commit=s.ae_req_commit.to(sp.index),
        ae_rsp_rel=rel(s.ae_rsp_t),
        ae_rsp_term=s.ae_rsp_term.to(sp.term),
        ae_rsp_success_bits=_pack_bool_rows(s.ae_rsp_success),
        ae_rsp_match=s.ae_rsp_match.to(sp.index),
        sn_req_rel=rel(s.sn_req_t),
        sn_req_term=s.sn_req_term.to(sp.term),
        snap_installed_src=s.snap_installed_src.to(torch.int8),
        snap_installed_len=s.snap_installed_len.to(sp.index),
        next_cmd=s.next_cmd.to(sp.tick),
        shadow_term=s.shadow_term.to(sp.term),
        shadow_val=cmd(s.shadow_val),
        shadow_base=s.shadow_base.to(sp.index),
        shadow_len=s.shadow_len.to(sp.index),
        shadow_prefix_hash=s.shadow_prefix_hash.clone(),
        violations=s.violations.clone(),
        first_violation_tick=s.first_violation_tick.to(sp.tick_signed),
        first_leader_tick=s.first_leader_tick.to(sp.tick_signed),
        msg_count=s.msg_count.clone(),
        snap_install_count=s.snap_install_count.clone(),
        log_tick=s.log_tick.to(sp.tick),
        shadow_sub=s.shadow_sub.to(sp.tick),
        lat_hist=s.lat_hist.to(sp.index),
        ev_counts=s.ev_counts.to(sp.event),
        phase_hist=s.phase_hist.to(sp.index),
        phase_ticks=s.phase_ticks.clone(),
        lat_ticks=s.lat_ticks.clone(),
        worst_lat=s.worst_lat.to(sp.tick),
        worst_phases=s.worst_phases.to(sp.tick),
        worst_key=s.worst_key.clone(),
        worst_client=s.worst_client.clone(),
        worst_sub=s.worst_sub.to(sp.tick),
    )


def unpack_state(cfg: SimConfig, p: PackedClusterState,
                 sp: Optional[PackedSpec] = None) -> ClusterState:
    """Packed -> wide: the exact inverse of pack_state, restoring the
    int32/bool dtypes the tick runs on; the plain version of kernel K3's
    unpack."""
    if sp is None:
        sp = packed_spec(cfg)
    n = cfg.n_nodes
    t = p.tick.to(I32)
    idx = torch.arange(n, dtype=I64, device=t.device)

    def stamp(r):
        r32 = r.to(I32)
        return torch.where(r32 > 0, _lanes(t, r32) + r32, 0)

    def cmd(v):
        v64 = v.to(I64)
        return torch.where(v64 == sp.noop_code, NOOP_CMD, v64).to(I32)

    def i32(x):
        return x.to(I32)

    return ClusterState(
        tick=t,
        term=i32(p.term),
        voted_for=i32(p.voted_for),
        role=((p.role_bits.to(I64)[:, None] >> (2 * idx)) & 3).to(I32),
        timer=i32(p.timer),
        hb=i32(p.hb),
        alive=((p.alive_bits.to(I64)[:, None] >> idx) & 1).to(BOOL),
        limp=i32(p.limp),
        fsync_stall=i32(p.fsync_stall),
        log_term=i32(p.log_term),
        log_val=cmd(p.log_val),
        log_len=i32(p.log_len),
        base=i32(p.base),
        snap_term=i32(p.snap_term),
        prefix_hash=p.prefix_hash.clone(),
        commit=i32(p.commit),
        durable_len=i32(p.durable_len),
        durable_term=i32(p.durable_term),
        durable_voted_for=i32(p.durable_voted_for),
        compact_floor=i32(p.compact_floor),
        votes=_unpack_bool_rows(p.votes_bits, n),
        next_idx=i32(p.next_idx),
        match_idx=i32(p.match_idx),
        adj=_unpack_bool_rows(p.adj_bits, n),
        rv_req_t=stamp(p.rv_req_rel),
        rv_req_term=i32(p.rv_req_term),
        rv_req_lli=i32(p.rv_req_lli),
        rv_req_llt=i32(p.rv_req_llt),
        rv_rsp_t=stamp(p.rv_rsp_rel),
        rv_rsp_term=i32(p.rv_rsp_term),
        rv_rsp_granted=_unpack_bool_rows(p.rv_rsp_granted_bits, n),
        ae_req_t=stamp(p.ae_req_rel),
        ae_req_term=i32(p.ae_req_term),
        ae_req_prev=i32(p.ae_req_prev),
        ae_req_prev_term=i32(p.ae_req_prev_term),
        ae_req_n=i32(p.ae_req_n),
        ae_req_commit=i32(p.ae_req_commit),
        ae_rsp_t=stamp(p.ae_rsp_rel),
        ae_rsp_term=i32(p.ae_rsp_term),
        ae_rsp_success=_unpack_bool_rows(p.ae_rsp_success_bits, n),
        ae_rsp_match=i32(p.ae_rsp_match),
        sn_req_t=stamp(p.sn_req_rel),
        sn_req_term=i32(p.sn_req_term),
        snap_installed_src=i32(p.snap_installed_src),
        snap_installed_len=i32(p.snap_installed_len),
        next_cmd=i32(p.next_cmd),
        shadow_term=i32(p.shadow_term),
        shadow_val=cmd(p.shadow_val),
        shadow_base=i32(p.shadow_base),
        shadow_len=i32(p.shadow_len),
        shadow_prefix_hash=p.shadow_prefix_hash.clone(),
        violations=p.violations.clone(),
        first_violation_tick=i32(p.first_violation_tick),
        first_leader_tick=i32(p.first_leader_tick),
        msg_count=p.msg_count.clone(),
        snap_install_count=p.snap_install_count.clone(),
        log_tick=i32(p.log_tick),
        shadow_sub=i32(p.shadow_sub),
        lat_hist=i32(p.lat_hist),
        ev_counts=i32(p.ev_counts),
        phase_hist=i32(p.phase_hist),
        phase_ticks=p.phase_ticks.clone(),
        lat_ticks=p.lat_ticks.clone(),
        worst_lat=i32(p.worst_lat),
        worst_phases=i32(p.worst_phases),
        worst_key=p.worst_key.clone(),
        worst_client=p.worst_client.clone(),
        worst_sub=i32(p.worst_sub),
    )


def packed_layout_reason(cfg: SimConfig, kn, ticks_needed: int) -> Optional[str]:
    """None when the packed schema is exact for a run of up to
    ``ticks_needed`` per-lane ticks under knob values ``kn``, else the
    reason the engine falls back to the wide layout (the reference's
    gates and messages, in its order)."""
    if cfg.n_nodes > 16:
        return (
            f"n_nodes {cfg.n_nodes} > 16: role pairs (2 bits/node) and "
            "adjacency/vote row masks must fit one u32 word"
        )
    if cfg.ae_max > 255:
        return f"ae_max {cfg.ae_max} exceeds the u8 ae_req_n field"
    if ticks_needed > cfg.max_lane_ticks:
        return (
            f"run needs {ticks_needed} per-lane ticks > max_lane_ticks "
            f"{cfg.max_lane_ticks} (raise SimConfig.max_lane_ticks to pack "
            "longer horizons; widths re-derive automatically)"
        )
    k = type(kn)(*(np.asarray(x.cpu()) for x in kn))
    b = packed_bounds(cfg)
    if (k.delay_max > b.rel_stamp - 1).any():
        return (
            f"delay_max {k.delay_max} > {b.rel_stamp - 1}: mailbox stamps "
            "are stored tick-relative in one u8 (0 = empty)"
        )
    if (k.delay_min < 1).any():
        # a zero-delay send stamps the current tick, which the relative
        # encoding cannot tell from an empty slot
        return f"delay_min {k.delay_min} < 1: a same-tick stamp would " \
               "pack as an empty mailbox slot"
    if (k.eto_max + (cfg.n_nodes - 1) * k.eto_skew
            > 65535).any():
        return (
            f"eto_max {k.eto_max} + (n-1) * eto_skew {k.eto_skew} exceeds "
            "the u16 timer field"
        )
    if (k.heartbeat_ticks > 65535).any():
        return f"heartbeat_ticks {k.heartbeat_ticks} exceeds the u16 field"
    if (k.limp_mult_max > 255).any():
        return f"limp_mult_max {k.limp_mult_max} exceeds the u8 limp field"
    if ((k.limp_mult_max > 1)
            & (k.delay_max * k.limp_mult_max
               > b.rel_stamp - 1)).any():
        return (
            f"delay_max {k.delay_max} * limp_mult_max {k.limp_mult_max} "
            f"> {b.rel_stamp - 1}: a limping node's stretched delay must "
            "fit the u8 tick-relative mailbox stamp"
        )
    if (k.fsync_stall_ticks > 65535).any():
        return (
            f"fsync_stall_ticks {k.fsync_stall_ticks} exceeds the u16 "
            "fsync_stall field"
        )
    return None


def planted_edge_state(cfg: SimConfig, h: dict, seed: int) -> dict:
    """A host state (field -> array, at least two lanes) shaped like ``h``
    whose lanes sit inside ``config.packed_bounds``: lane 0 at every
    maximum (stamps at tick + 255, every flag and row-mask bit set), lane 1
    at every minimum (-1 sentinels, NOOP payloads, empty slots), the other
    lanes drawn at random from ``seed`` (each at its own tick). The input
    K3 and its plain versions are checked on; not a reachable state."""
    rng = np.random.default_rng(seed)
    b = packed_bounds(cfg)
    n = cfg.n_nodes
    lanes = h["tick"].shape[0]
    tick = rng.integers(0, b.tick + 1, size=lanes)
    tick[0], tick[1] = b.tick, 0
    # field -> (low, high) of its values, inclusive; absolute log indices
    # and counters default to (0, b.index), terms to (0, b.term)
    span = {"voted_for": (-1, n - 1), "durable_voted_for": (-1, n - 1),
            "snap_installed_src": (-1, n - 1), "role": (0, 2),
            "timer": (0, 65535), "hb": (0, 65535), "limp": (1, 255),
            "fsync_stall": (0, 65535), "ae_req_n": (0, cfg.ae_max),
            "first_violation_tick": (-1, b.tick),
            "first_leader_tick": (-1, b.tick), "next_cmd": (0, b.tick),
            "prefix_hash": (-2**31, 2**31 - 1),
            "shadow_prefix_hash": (-2**31, 2**31 - 1),
            "violations": (0, 2**16 - 1), "msg_count": (0, 2**31 - 1),
            "snap_install_count": (0, 2**31 - 1),
            # metric leaves: stamps and latencies in the tick dtype,
            # counters in the event dtype, sums and keys kept i32
            "log_tick": (0, b.tick), "shadow_sub": (0, b.tick),
            "worst_lat": (0, b.tick), "worst_phases": (0, b.tick),
            "worst_sub": (0, b.tick), "ev_counts": (0, b.event),
            "phase_ticks": (-2**31, 2**31 - 1),
            "lat_ticks": (-2**31, 2**31 - 1),
            "worst_key": (-1, 2**31 - 1), "worst_client": (-1, 2**31 - 1)}
    p = {}
    for f, a in h.items():
        lo, hi = span.get(f, (0, b.index))
        if "term" in f or f.endswith("llt"):
            lo, hi = 0, b.term
        if f == "tick":
            p[f] = tick.astype(np.int32)
            continue
        if a.dtype == np.bool_:
            v = rng.integers(0, 2, size=a.shape).astype(bool)
            v[0], v[1] = True, False
        elif f.endswith("_t"):  # mailbox stamps: empty or tick + 1..255
            rel = rng.integers(0, 256, size=a.shape)
            rel[0], rel[1] = 255, 0
            v = np.where(rel > 0, tick.reshape((lanes,) + (1,) * (a.ndim - 1))
                         + rel, 0)
        elif f in ("log_val", "shadow_val"):
            v = rng.integers(0, b.cmd + 1, size=a.shape)
            v = np.where(rng.random(a.shape) < 0.2, NOOP_CMD, v)
            v[0], v[1] = b.cmd, NOOP_CMD
        else:
            v = rng.integers(lo, hi, size=a.shape, endpoint=True)
            v[0], v[1] = hi, lo
        p[f] = v.astype(a.dtype)
    return p
