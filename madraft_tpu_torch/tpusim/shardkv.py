"""The multi-group sharded-kv service layer (Lab 4B) on top of the raft
tick: G raft groups a deployment, the config source, shard migration
(pull, install, GC), the clerks, the truth walker and the shardkv oracles,
for a batch of deployments. The twin of the reference's
``madraft_tpu/tpusim/shardkv.py`` (whose module docstring explains the
model and whose comments explain each step).

The config source is one of three modes (``ShardKvConfig``): the
pre-drawn schedule (the default); ``live_ctrler``, where the configs'
announces ride a replicated controller raft cluster and groups learn them
through Query mailboxes; ``computed_ctrler``, where the controller's
apply machine is the 4A rebalance (``ctrler._rebalance``) over committed
membership flips. In a controller mode ``ctrl`` is a full raft cluster of
the deployment's ``SimConfig``, keyed ``fold_in(key, 21)``; in schedule
mode it is the reference's one-node placeholder, carried and never
stepped (``_ctrl_sim_cfg``).

A deployment tick is the raft tick of every group (and of the controller
cluster in a controller mode), then the service tick
(``_shardkv_service_tick``). On the card (``engine.tick_route``) up to
``engine.KERNEL_CHUNK`` deployment ticks are one launch of K6-shardkv
(``kernels.shardkv.shardkv_chunk``; K6-metrics-shardkv with the metrics
plane on): a deployment a block, its groups' raft ticks (each group keyed
by ``fold_in(key, 100 + g)``) and its controller's, then kernel K11's
service tick, each tick of the chunk. On the CPU, or with
``tick="eager"``, the raft ticks are ``step.step_cluster`` over the
deployments' groups viewed as B x G clusters (and over the B controller
clusters) and the service tick this module's ``_shardkv_service_tick``,
K11's plain version.

Batch-first like the rest of the port: a reference leaf ``[G, N, NS]`` is
``[B, G, N, NS]`` here, a scalar leaf is ``[B]``, ``rafts`` is a
``ClusterState`` of ``[B, G, ...]`` leaves and ``ctrl`` one of ``[B,
...]`` leaves. Every knob of ``ShardKvKnobs`` (and of the raft ``Knobs``)
is 0-d, one value for the batch, or a ``[B]`` row, one value a deployment
(``make_shardkv_sweep_fn``).

Not ported here: the packed deployment carry (the port ticks the wide
state and reports ``"state_layout": "wide"``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import shardkv as K11
from madraft_tpu_torch.kernels.oracle import lane_abs
from madraft_tpu_torch.tpusim import ctrler as _ctrler
from madraft_tpu_torch.tpusim import metrics as _m
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    HIST_BUCKETS,
    LEADER,
    NOOP_CMD,
    OPEN_QUEUE_SLOTS,
    SHARDKV_PHASES,
    Knobs,
    SimConfig,
    check_service_cfg,
    lane_view,
    zipf_map,
)
from madraft_tpu_torch.tpusim.kv import _wrap_i32
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    durable_after_append,
    init_cluster,
    nested_state_from_numpy,
    nested_state_to_numpy,
)
from madraft_tpu_torch.tpusim.step import _row_gather, _slot, step_cluster

I32 = torch.int32
F32 = torch.float32
BOOL = torch.bool

# The shardkv oracles' violation bits (beside config's, kv's and ctrler's)
VIOLATION_SHARD_DIVERGE = 64
VIOLATION_SHARD_OWNERSHIP = 128
VIOLATION_SHARD_STORAGE = 256
VIOLATION_SHARD_STALE_READ = 1024
VIOLATION_SHARD_CTRL_STALE = 32768

_SEQ_LIM = 1 << 13
_BIG = 1 << 30

# entry kinds (the low 3 bits of a log value, less one) and shard phases
_APPEND, _CONFIG, _INSTALL, _DELETE, _GET, _PUT = 0, 1, 2, 3, 4, 5
ABSENT, OWNED, PULLING, FROZEN = 0, 1, 2, 3

# PRNG sites (fold_in data), as the reference's
_S_GROUP = 100  # + g: the group's raft stream
_S_PULL = 17
_S_CLERK = 18
_S_CFGGEN = 19
_S_NET_PULL = 20
_S_CTRL = 21  # the controller cluster's raft stream
_S_ANN = 22   # the announcers' and the Query targets' draws
_S_FLIP = 23  # the computed controller's flip schedule, at init


@dataclasses.dataclass(frozen=True)
class ShardKvConfig:
    """Knobs of the shardkv layer, field for field the reference's
    ``ShardKvConfig`` (its comments explain each): ``n_groups`` /
    ``n_shards`` / ``n_clients`` / ``n_configs`` / ``apply_max`` /
    ``walk_max`` and the two controller modes shape the run, the rest
    are dynamic ``ShardKvKnobs``. Every check of the reference's
    ``__post_init__`` is here."""

    n_groups: int = 3
    n_shards: int = 10
    n_clients: int = 4
    n_configs: int = 6
    cfg_interval: int = 60
    p_op: float = 0.4
    p_get: float = 0.3
    p_put: float = 0.0
    p_retry: float = 0.5
    p_cfg_learn: float = 0.3
    p_pull: float = 0.4
    p_ack: float = 0.4
    pull_delay_min: int = 1
    pull_delay_max: int = 3
    pull_loss: float = 0.1
    apply_max: int = 4
    walk_max: int = 6
    live_ctrler: bool = False
    p_announce: float = 0.5
    p_phantom: float = 0.3
    computed_ctrler: bool = False
    bug_rotate_tiebreak: bool = False
    requery_wrong_group: bool = False
    bug_skip_freeze: bool = False
    bug_drop_dup_table: bool = False
    bug_serve_frozen: bool = False
    bug_stale_ctrler_read: bool = False
    open_rate: float = 0.0
    open_queue_cap: int = 0
    zipf_a: float = 1.0

    def __post_init__(self):
        if self.p_get + self.p_put > 1.0:
            raise ValueError(
                f"p_get ({self.p_get}) + p_put ({self.p_put}) must stay <= 1"
            )
        if not 0.0 <= self.open_rate <= 1.0:
            raise ValueError(f"open_rate {self.open_rate} not in [0, 1]")
        if not 0 <= self.open_queue_cap <= OPEN_QUEUE_SLOTS:
            raise ValueError(
                f"open_queue_cap {self.open_queue_cap} not in "
                f"[0, {OPEN_QUEUE_SLOTS}] (the arrival-stamp ring size)"
            )
        if self.zipf_a < 1.0:
            raise ValueError(f"zipf_a {self.zipf_a} must be >= 1.0 "
                             "(1.0 = uniform)")
        if self.computed_ctrler and self.live_ctrler:
            raise ValueError(
                "computed_ctrler supersedes live_ctrler — enable one"
            )
        if self.computed_ctrler:
            if self.n_groups < 2:
                raise ValueError(
                    f"computed_ctrler needs n_groups >= 2 (got "
                    f"{self.n_groups}): the phantom's competing flip is "
                    "'always a DIFFERENT gid' (init flip_b), which "
                    "degenerates with one group — the announce race would "
                    "be meaningless"
                )
            if self.n_shards != _ctrler.N_SHARDS:
                raise ValueError(
                    f"computed_ctrler reuses the 4A rebalance (ctrler.py), "
                    f"which is fixed at N_SHARDS={_ctrler.N_SHARDS}; got "
                    f"n_shards={self.n_shards}"
                )
            if self.bug_stale_ctrler_read:
                raise ValueError(
                    "bug_stale_ctrler_read is a live_ctrler-mode oracle "
                    "validation; computed_ctrler's planted bug is "
                    "bug_rotate_tiebreak"
                )
        elif self.bug_rotate_tiebreak:
            raise ValueError(
                "bug_rotate_tiebreak plants a per-replica rebalance "
                "divergence in the COMPUTED controller — it needs "
                "computed_ctrler=True (otherwise the knob would silently "
                "do nothing and read as an oracle failure)"
            )
        top = _pack_op(self, self.n_clients - 1, _SEQ_LIM - 1,
                       self.n_shards - 1, 7)
        if top >= NOOP_CMD:
            raise ValueError(
                f"n_clients ({self.n_clients}) x n_shards ({self.n_shards}) "
                f"overflow the op packing (max {top} >= NOOP_CMD {NOOP_CMD})"
            )

    def replace(self, **kw) -> "ShardKvConfig":
        return dataclasses.replace(self, **kw)

    def knobs(self, device=None) -> "ShardKvKnobs":
        """The dynamic knobs as 0-d tensors on ``device`` (CPU if None)."""
        def f32(v):
            return torch.tensor(v, dtype=F32, device=device)

        def i32(v):
            return torch.tensor(v, dtype=I32, device=device)

        def b(v):
            return torch.tensor(v, dtype=BOOL, device=device)

        return ShardKvKnobs(
            cfg_interval=i32(self.cfg_interval), p_op=f32(self.p_op),
            p_get=f32(self.p_get), p_put=f32(self.p_put),
            p_retry=f32(self.p_retry), p_cfg_learn=f32(self.p_cfg_learn),
            p_pull=f32(self.p_pull), p_ack=f32(self.p_ack),
            pull_delay_min=i32(self.pull_delay_min),
            pull_delay_max=i32(self.pull_delay_max),
            pull_loss=f32(self.pull_loss), p_announce=f32(self.p_announce),
            p_phantom=f32(self.p_phantom),
            bug_skip_freeze=b(self.bug_skip_freeze),
            bug_drop_dup_table=b(self.bug_drop_dup_table),
            bug_serve_frozen=b(self.bug_serve_frozen),
            bug_stale_ctrler_read=b(self.bug_stale_ctrler_read),
            bug_rotate_tiebreak=b(self.bug_rotate_tiebreak),
            requery_wrong_group=b(self.requery_wrong_group),
            open_rate=f32(self.open_rate),
            open_queue_cap=i32(self.open_queue_cap),
            zipf_a=f32(self.zipf_a),
        )

    def static_key(self) -> "ShardKvConfig":
        return ShardKvConfig(
            n_groups=self.n_groups, n_shards=self.n_shards,
            n_clients=self.n_clients, n_configs=self.n_configs,
            apply_max=self.apply_max, walk_max=self.walk_max,
            live_ctrler=self.live_ctrler,
            computed_ctrler=self.computed_ctrler,
        )


class ShardKvKnobs(NamedTuple):
    """The shardkv layer's dynamic knobs (see ShardKvConfig): float32
    probabilities, int32 counts and bool bugs, each 0-d or a [B] row."""

    cfg_interval: torch.Tensor
    p_op: torch.Tensor
    p_get: torch.Tensor
    p_put: torch.Tensor
    p_retry: torch.Tensor
    p_cfg_learn: torch.Tensor
    p_pull: torch.Tensor
    p_ack: torch.Tensor
    pull_delay_min: torch.Tensor
    pull_delay_max: torch.Tensor
    pull_loss: torch.Tensor
    p_announce: torch.Tensor
    p_phantom: torch.Tensor
    bug_skip_freeze: torch.Tensor
    bug_drop_dup_table: torch.Tensor
    bug_serve_frozen: torch.Tensor
    bug_stale_ctrler_read: torch.Tensor
    bug_rotate_tiebreak: torch.Tensor
    requery_wrong_group: torch.Tensor
    open_rate: torch.Tensor
    open_queue_cap: torch.Tensor
    zipf_a: torch.Tensor

    def to(self, device) -> "ShardKvKnobs":
        return ShardKvKnobs(*(x.to(device) for x in self))

    def lanes(self, ndim: int) -> "ShardKvKnobs":
        """Each field against a [B, ...] operand of ``ndim`` dims
        (``config.lane_view``)."""
        return ShardKvKnobs(*(lane_view(x, ndim) for x in self))

    def broadcast(self, n_clusters: int) -> "ShardKvKnobs":
        """Per-deployment rows: every field ``[n_clusters]``."""
        return ShardKvKnobs(*(x.expand(n_clusters).clone() for x in self))


def _pack_op(cfg: ShardKvConfig, client, seq, shard, kind):
    return (((client * _SEQ_LIM + seq) * cfg.n_shards + shard) * 8 + kind) + 1


def _pack_config(cfg_idx, var=0, src_lim=2):
    """CONFIG(cfg_idx) with payload cfg_idx * src_lim + var: ``var`` the
    adopted source, the announce variant in live mode (src_lim 2) or the
    controller replica in computed mode (src_lim n), 0 in schedule mode
    (the reference's ``_pack_config``)."""
    return ((cfg_idx * src_lim + var) * 8 + _CONFIG) + 1


def _pack_install(cfg: ShardKvConfig, cfg_idx, shard):
    return ((cfg_idx * cfg.n_shards + shard) * 8 + _INSTALL) + 1


def _pack_delete(cfg: ShardKvConfig, cfg_idx, shard):
    return ((cfg_idx * cfg.n_shards + shard) * 8 + _DELETE) + 1


def _fdiv(a, b):
    """Python's ``//`` (floor division) of int tensors."""
    return torch.div(a, b, rounding_mode="floor")


def _unpack(cfg: ShardKvConfig, val, src_lim=2):
    """(kind, client, seq, shard, cfg_idx_c, cfg_idx_i, var_c) of log
    values, floor division and modulo as the reference's ``//`` and ``%``
    (fields valid per kind; CONFIG's payload is cfg_idx * src_lim + var,
    ``_pack_config``; an empty slot's 0 and the no-op decode as kind 7,
    which matches nothing)."""
    v = val - 1
    kind = torch.remainder(v, 8)
    payload = _fdiv(v, 8)
    shard = torch.remainder(payload, cfg.n_shards)
    cs = _fdiv(payload, cfg.n_shards)
    return (kind, _fdiv(cs, _SEQ_LIM), torch.remainder(cs, _SEQ_LIM), shard,
            _fdiv(payload, src_lim), _fdiv(payload, cfg.n_shards),
            torch.remainder(payload, src_lim))


class ShardKvState(NamedTuple):
    """A batch of deployments: the reference's ``ShardKvState`` with a
    leading deployment axis (its comments explain each leaf). ``rafts``
    holds the G group clusters ([B, G, ...] leaves), ``ctrl`` the
    controller cluster ([B, ...]: the full cluster in a controller mode,
    the one-node placeholder in schedule mode). The controller-mode
    leaves are carried unchanged outside their modes, as the reference
    carries them; the metric leaves are zero-size with metrics off."""

    rafts: ClusterState
    cfg_tick: torch.Tensor          # [B, NCFG]
    cfg_owner: torch.Tensor         # [B, NCFG, NS]
    ctrl: ClusterState
    ctrl_w_frontier: torch.Tensor   # [B]
    ctrl_w_stalled: torch.Tensor    # [B] bool
    win_var: torch.Tensor           # [B, NCFG]
    flip_a: torch.Tensor            # [B, NCFG]
    flip_b: torch.Tensor            # [B, NCFG]
    slot_tick: torch.Tensor         # [B, NCFG]
    cmem: torch.Tensor              # [B, G] bool
    ctrl_node_owner: torch.Tensor   # [B, N, NS]
    ctrl_maps: torch.Tensor         # [B, N, NCFG, NS]
    node_src: torch.Tensor          # [B, G, N]
    snap_src: torch.Tensor          # [B, G, N]
    w_src: torch.Tensor             # [B, G]
    cq_req_t: torch.Tensor          # [B, G]
    cq_req_node: torch.Tensor       # [B, G]
    cq_req_j: torch.Tensor          # [B, G]
    cq_rsp_t: torch.Tensor          # [B, G]
    cq_rsp_j: torch.Tensor          # [B, G]
    cq_rsp_found: torch.Tensor      # [B, G] bool
    cq_rsp_var: torch.Tensor        # [B, G]
    applied: torch.Tensor           # [B, G, N]
    node_cfg: torch.Tensor          # [B, G, N]
    phase: torch.Tensor             # [B, G, N, NS]
    key_hash: torch.Tensor          # [B, G, N, NS]
    key_count: torch.Tensor         # [B, G, N, NS]
    last_seq: torch.Tensor          # [B, G, N, NS, NC]
    snap_cfg: torch.Tensor          # [B, G, N]
    snap_phase: torch.Tensor        # [B, G, N, NS]
    snap_hash: torch.Tensor         # [B, G, N, NS]
    snap_count: torch.Tensor        # [B, G, N, NS]
    snap_last_seq: torch.Tensor     # [B, G, N, NS, NC]
    staged_cfg: torch.Tensor        # [B, G, NS]
    staged_hash: torch.Tensor       # [B, G, NS]
    staged_count: torch.Tensor      # [B, G, NS]
    staged_last_seq: torch.Tensor   # [B, G, NS, NC]
    pull_req_t: torch.Tensor        # [B, G(dst), G(src), NS]
    pull_req_cfg: torch.Tensor
    pull_rsp_t: torch.Tensor
    pull_rsp_cfg: torch.Tensor
    pull_rsp_hash: torch.Tensor
    pull_rsp_count: torch.Tensor
    pull_rsp_last_seq: torch.Tensor  # [B, G, G, NS, NC]
    gcq_req_t: torch.Tensor         # [B, G(gain owner), G(holder), NS]
    gcq_req_cfg: torch.Tensor
    gcq_rsp_t: torch.Tensor         # [B, G(holder), G(gain owner), NS]
    gcq_rsp_cfg: torch.Tensor
    clerk_seq: torch.Tensor         # [B, NC]
    clerk_out: torch.Tensor         # [B, NC] bool
    clerk_shard: torch.Tensor       # [B, NC]
    clerk_kind: torch.Tensor        # [B, NC]
    clerk_cfg: torch.Tensor         # [B, NC]
    clerk_wrong: torch.Tensor       # [B, NC] bool
    clerk_acked: torch.Tensor       # [B, NC]
    clerk_get_lo: torch.Tensor      # [B, NC]
    clerk_get_obs: torch.Tensor     # [B, NC]
    gets_done: torch.Tensor         # [B, NC]
    open_arr: torch.Tensor          # [B, NC]
    open_srv: torch.Tensor          # [B, NC]
    open_drop: torch.Tensor         # [B, NC]
    open_stamp: torch.Tensor        # [B, NC | 0, OPEN_QUEUE_SLOTS]
    clerk_sub: torch.Tensor         # [B, NC | 0]
    lat_hist: torch.Tensor          # [B, HB | 0]
    clerk_app: torch.Tensor         # [B, NC | 0]
    clerk_cmt: torch.Tensor         # [B, NC | 0]
    clerk_apl: torch.Tensor         # [B, NC | 0]
    clerk_mig: torch.Tensor         # [B, NC | 0]
    client_retries: torch.Tensor    # [B, NC | 0]
    phase_hist: torch.Tensor        # [B, 5 | 0, HB | 0]
    phase_ticks: torch.Tensor       # [B, 5 | 0]
    lat_ticks: torch.Tensor         # [B, 1 | 0]
    worst_lat: torch.Tensor         # [B, 1 | 0]
    worst_phases: torch.Tensor      # [B, 5 | 0]
    worst_key: torch.Tensor         # [B, 1 | 0]
    worst_client: torch.Tensor      # [B, 1 | 0]
    worst_sub: torch.Tensor         # [B, 1 | 0]
    key_lat_hist: torch.Tensor      # [B, NS | 0, HB | 0]
    client_lat_hist: torch.Tensor   # [B, NC | 0, HB | 0]
    w_frontier: torch.Tensor        # [B, G]
    w_cfg: torch.Tensor             # [B, G]
    w_phase: torch.Tensor           # [B, G, NS]
    w_hash: torch.Tensor            # [B, G, NS]
    w_count: torch.Tensor           # [B, G, NS]
    w_last_seq: torch.Tensor        # [B, G, NS, NC]
    frz_cfg: torch.Tensor           # [B, NS]
    frz_hash: torch.Tensor          # [B, NS]
    frz_count: torch.Tensor         # [B, NS]
    frz_last_seq: torch.Tensor      # [B, NS, NC]
    truth_count: torch.Tensor       # [B, NS]
    w_clerk_acked: torch.Tensor     # [B, NC]
    installs_done: torch.Tensor     # [B]
    deletes_done: torch.Tensor      # [B]
    max_cfg_lag: torch.Tensor       # [B]
    violations: torch.Tensor        # [B]
    first_violation_tick: torch.Tensor  # [B]


# the service leaves, in order (ShardKvState's fields but the two clusters)
SERVICE = tuple(f for f in ShardKvState._fields if f not in ("rafts", "ctrl"))
# every leaf of a shardkv state as one flat name space: the group rafts'
# leaves as "rafts.<field>", the controller's as "ctrl.<field>", then the
# service leaves (shardkv_state_to_numpy / first_divergence)
SHARDKV_FIELDS = (tuple(f"rafts.{f}" for f in ClusterState._fields)
                  + tuple(f"ctrl.{f}" for f in ClusterState._fields)
                  + SERVICE)


def _ctrl_mode(kcfg: ShardKvConfig) -> bool:
    return kcfg.live_ctrler or kcfg.computed_ctrler


def _ctrl_sim_cfg(cfg: SimConfig, kcfg: ShardKvConfig) -> SimConfig:
    """The SimConfig of the deployment's controller cluster: the real one
    in a controller mode, else the reference's smallest legal placeholder
    (its ``_ctrl_sim_cfg``)."""
    if _ctrl_mode(kcfg):
        return cfg
    return cfg.replace(n_nodes=1, log_cap=4, uncommitted_cap=1,
                       compact_every=1)


def ctrl_keys(keys: torch.Tensor) -> torch.Tensor:
    """[B, 2] the controller clusters' raft keys, ``fold_in(key, 21)``."""
    return prng.fold_in(keys, _S_CTRL)


def group_keys(keys: torch.Tensor, n_groups: int) -> torch.Tensor:
    """[B, G, 2] the groups' raft keys, ``fold_in(key, 100 + g)`` of each
    deployment key of ``keys`` [B, 2]."""
    g = torch.arange(n_groups, dtype=torch.int64, device=keys.device)
    return prng.fold_in(keys[:, None, :], _S_GROUP + g)


def _group_knobs(kn: Knobs, n_groups: int) -> Knobs:
    """The raft knobs against the B x G group clusters: a [B] row repeated
    for each group, a 0-d knob as it is."""
    return Knobs(*(x if x.dim() == 0 else x.repeat_interleave(n_groups)
                   for x in kn))


def _flat(s: ClusterState) -> ClusterState:
    """[B, G, ...] group rafts as [B x G, ...] clusters (a view)."""
    bg = s.tick.numel()
    return ClusterState(*(x.reshape(bg, *x.shape[2:]) for x in s))


def _unflat(s: ClusterState, b: int) -> ClusterState:
    """[B x G, ...] clusters as [B, G, ...] group rafts (a view)."""
    g = s.tick.shape[0] // b
    return ClusterState(*(x.reshape(b, g, *x.shape[1:]) for x in s))


def _gen_schedule(kcfg: ShardKvConfig, keys: torch.Tensor, skn):
    """The config schedule of each deployment (the reference's
    ``_gen_schedule``): activation ticks [B, NCFG] and owner maps
    [B, NCFG, NS], config 0 round-robin, each later one a Join or a Leave
    followed by the orphan and level rebalance. Plain torch, once at
    init, on the keys' device."""
    ncfg, ns, g = kcfg.n_configs, kcfg.n_shards, kcfg.n_groups
    dev = keys.device
    b = keys.shape[0]
    kk = prng.split(prng.fold_in(keys, _S_CFGGEN), 2)
    kt, km = kk[:, 0], kk[:, 1]
    ci = lane_view(skn.cfg_interval.to(dev), 2)
    gaps = prng.randint(kt, ncfg, torch.div(ci, 2, rounding_mode="floor"),
                        torch.div(ci * 3, 2, rounding_mode="floor") + 1)
    cfg_tick = (torch.cumsum(gaps, -1, dtype=I32) - gaps[:, :1]).to(I32)
    gids = torch.arange(g, dtype=I32, device=dev)
    owner = (torch.arange(ns, dtype=I32, device=dev) % g).expand(b, ns).clone()
    members = torch.ones((b, g), dtype=BOOL, device=dev)
    owners = [owner.clone()]

    def counts_of(owner, members):
        c = (owner[:, None, :] == gids[None, :, None]).sum(-1, dtype=I32)
        return torch.where(members, c, 0)

    def set_at(owner, sh, val):
        owner = owner.clone()
        owner[:, sh] = val
        return owner

    steps = prng.split(km, ncfg - 1) if ncfg > 1 else None
    rows = torch.arange(b, device=dev)
    for j in range(ncfg - 1):
        ke_kp = prng.split(steps[:, j], 2)
        ke, kp = ke_kp[:, 0], ke_kp[:, 1]
        n_mem = members.sum(-1, dtype=I32)
        can_join = n_mem < g
        can_leave = n_mem > 1
        do_join = can_join & (prng.bernoulli(ke, torch.tensor(0.5), 1)[:, 0]
                              | ~can_leave)
        pool = torch.where(do_join[:, None], ~members, members)
        r = prng.randint(kp, 1, 0, torch.clamp(pool.sum(-1, dtype=I32),
                                               min=1)[:, None])[:, 0]
        pick = (torch.cumsum(pool.to(I32), -1, dtype=I32) == r[:, None] + 1) \
            & pool
        gsel = torch.argmax(pick.to(I32), -1)
        members = members.clone()
        members[rows, gsel] = do_join
        # orphans -> the least-loaded member, in shard order
        for sh in range(ns):
            c = counts_of(owner, members)
            tgt = torch.argmin(torch.where(members, c, _BIG), -1).to(I32)
            is_orph = ~members.gather(1, owner[:, sh:sh + 1].long())[:, 0]
            owner = set_at(owner, sh, torch.where(is_orph, tgt, owner[:, sh]))
        # level: one shard most -> least loaded while max - min > 1
        for _ in range(ns):
            c = counts_of(owner, members)
            mx = torch.argmax(torch.where(members, c, -1), -1)
            mn = torch.argmin(torch.where(members, c, _BIG), -1)
            need = (c.gather(1, mx[:, None]) - c.gather(1, mn[:, None]))[:, 0] > 1
            ssel = torch.argmax((owner == mx[:, None].to(I32)).to(I32), -1)
            cur = owner.gather(1, ssel[:, None])[:, 0]
            owner = owner.clone()
            owner[rows, ssel] = torch.where(need, mn.to(I32), cur)
        owners.append(owner.clone())
    return cfg_tick, torch.stack(owners, 1).to(I32)


def init_shardkv_cluster(cfg: SimConfig, kcfg: ShardKvConfig,
                         keys: torch.Tensor, kn=None,
                         skn=None) -> ShardKvState:
    """Fresh deployments at tick 0, one per key row of ``keys`` [B, 2];
    ``kn`` / ``skn`` may hold [B] knob rows."""
    dev = keys.device
    b = keys.shape[0]
    if kn is None:
        kn = cfg.knobs(dev)
    if skn is None:
        skn = kcfg.knobs(dev)
    g, n, ns, nc = kcfg.n_groups, cfg.n_nodes, kcfg.n_shards, kcfg.n_clients
    ncfg = kcfg.n_configs
    mc = nc if cfg.metrics else 0
    hb = HIST_BUCKETS if cfg.metrics else 0
    npm = len(SHARDKV_PHASES) if cfg.metrics else 0
    reg = 1 if cfg.metrics else 0

    rafts = _unflat(init_cluster(cfg, group_keys(keys, g).reshape(-1, 2),
                                 _group_knobs(kn, g)), b)
    cfg_tick, cfg_owner = _gen_schedule(kcfg, keys, skn)
    owner0 = cfg_owner[:, 0]  # [B, NS]
    gid = torch.arange(g, dtype=I32, device=dev)
    phase0 = torch.where(owner0[:, None, None, :] == gid[None, :, None, None],
                         OWNED, ABSENT).expand(b, g, n, ns).to(I32)
    if _ctrl_mode(kcfg):
        ctrl = init_cluster(cfg, ctrl_keys(keys), kn)
    else:
        ctrl = init_cluster(_ctrl_sim_cfg(cfg, kcfg), ctrl_keys(keys))

    def full(shape, v=0, dtype=I32):
        return torch.full((b, *shape), v, dtype=dtype, device=dev)

    def neg_first(shape):
        x = full(shape, -1)
        x[:, 0] = 0
        return x

    flip_a, flip_b = full((ncfg,)), full((ncfg,))
    if kcfg.computed_ctrler:
        # config content comes from the controller's apply machine: the
        # rows past config 0 are placeholders the walker overwrites as
        # slots resolve; the two announcers' competing flips per slot
        cfg_owner = owner0[:, None, :].expand(b, ncfg, ns).clone()
        kf = prng.split(prng.fold_in(keys, _S_FLIP), 2)
        flip_a = prng.randint(kf[:, 0], ncfg, 0, g)
        flip_b = torch.remainder(
            flip_a + 1 + prng.randint(kf[:, 1], ncfg, 0, max(g - 1, 1)),
            g).to(I32)
    ctrl_maps = full((n, ncfg, ns))
    ctrl_maps[:, :, 0, :] = owner0[:, None, :]
    return ShardKvState(
        rafts=rafts, cfg_tick=cfg_tick, cfg_owner=cfg_owner, ctrl=ctrl,
        ctrl_w_frontier=full(()), ctrl_w_stalled=full((), False, BOOL),
        win_var=neg_first((ncfg,)), flip_a=flip_a,
        flip_b=flip_b, slot_tick=neg_first((ncfg,)),
        cmem=full((g,), True, BOOL),
        ctrl_node_owner=owner0[:, None, :].expand(b, n, ns).clone(),
        ctrl_maps=ctrl_maps, node_src=full((g, n)), snap_src=full((g, n)),
        w_src=full((g,)), cq_req_t=full((g,)), cq_req_node=full((g,)),
        cq_req_j=full((g,)), cq_rsp_t=full((g,)), cq_rsp_j=full((g,)),
        cq_rsp_found=full((g,), False, BOOL), cq_rsp_var=full((g,)),
        applied=full((g, n)), node_cfg=full((g, n)), phase=phase0.clone(),
        key_hash=full((g, n, ns)), key_count=full((g, n, ns)),
        last_seq=full((g, n, ns, nc)), snap_cfg=full((g, n)),
        snap_phase=phase0.clone(), snap_hash=full((g, n, ns)),
        snap_count=full((g, n, ns)), snap_last_seq=full((g, n, ns, nc)),
        staged_cfg=full((g, ns), -1), staged_hash=full((g, ns)),
        staged_count=full((g, ns)), staged_last_seq=full((g, ns, nc)),
        pull_req_t=full((g, g, ns)), pull_req_cfg=full((g, g, ns)),
        pull_rsp_t=full((g, g, ns)), pull_rsp_cfg=full((g, g, ns)),
        pull_rsp_hash=full((g, g, ns)), pull_rsp_count=full((g, g, ns)),
        pull_rsp_last_seq=full((g, g, ns, nc)),
        gcq_req_t=full((g, g, ns)), gcq_req_cfg=full((g, g, ns)),
        gcq_rsp_t=full((g, g, ns)), gcq_rsp_cfg=full((g, g, ns)),
        clerk_seq=full((nc,)), clerk_out=full((nc,), False, BOOL),
        clerk_shard=full((nc,)), clerk_kind=full((nc,)),
        clerk_cfg=full((nc,)), clerk_wrong=full((nc,), False, BOOL),
        clerk_acked=full((nc,)), clerk_get_lo=full((nc,)),
        clerk_get_obs=full((nc,), -1), gets_done=full((nc,)),
        open_arr=full((nc,)), open_srv=full((nc,)), open_drop=full((nc,)),
        open_stamp=full((mc, OPEN_QUEUE_SLOTS)), clerk_sub=full((mc,)),
        lat_hist=full((hb,)), clerk_app=full((mc,)), clerk_cmt=full((mc,)),
        clerk_apl=full((mc,)), clerk_mig=full((mc,)),
        client_retries=full((mc,)), phase_hist=full((npm, hb)),
        phase_ticks=full((npm,)), lat_ticks=full((reg,)),
        worst_lat=full((reg,)), worst_phases=full((npm,)),
        worst_key=full((reg,), -1), worst_client=full((reg,), -1),
        worst_sub=full((reg,)),
        key_lat_hist=full((ns if cfg.metrics else 0, hb)),
        client_lat_hist=full((mc, hb)),
        w_frontier=full((g,)), w_cfg=full((g,)), w_phase=phase0[:, :, 0].clone(),
        w_hash=full((g, ns)), w_count=full((g, ns)),
        w_last_seq=full((g, ns, nc)), frz_cfg=full((ns,), -1),
        frz_hash=full((ns,)), frz_count=full((ns,)),
        frz_last_seq=full((ns, nc)), truth_count=full((ns,)),
        w_clerk_acked=full((nc,)), installs_done=full(()),
        deletes_done=full(()), max_cfg_lag=full(()), violations=full(()),
        first_violation_tick=full((), -1),
    )


def _phase_matrix(t, sub, app, cmt, apl, mig, is_get) -> torch.Tensor:
    """The exact 5-phase split [B, 5, NC] of ``t - sub`` (the reference's
    ``_shardkv_phase_matrix``: kv's four rows plus the migration wait,
    clipped into the pre-append window)."""
    app_e = torch.maximum(app, sub)
    mig_e = torch.minimum(mig, app_e - sub)
    cmt_e = torch.maximum(cmt, app_e)
    b3 = torch.where(is_get, torch.maximum(apl, cmt_e), cmt_e)
    return torch.stack([app_e - sub - mig_e, cmt_e - app_e, b3 - cmt_e,
                        t - b3, mig_e], dim=-2)


def _at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The one-hot read table[..., idx] over the last axis (an index out
    of range reads 0): table [..., R] broadcasting against idx [...]."""
    r = torch.arange(table.shape[-1], dtype=I32, device=table.device)
    return torch.where(idx[..., None] == r, table, 0).sum(-1, dtype=I32)


def _rows_of(cfg_owner: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """cfg_owner [B, NCFG, NS] at config j [B, ...] (clipped to range) ->
    [B, ..., NS]."""
    ncfg = cfg_owner.shape[1]
    jc = torch.clamp(j, 0, ncfg - 1).long()
    b = cfg_owner.shape[0]
    flat = jc.reshape(b, -1)
    out = cfg_owner.gather(1, flat[..., None].expand(-1, -1,
                                                     cfg_owner.shape[2]))
    return out.reshape(*j.shape, cfg_owner.shape[2])


def _freeze_epoch(cfg_owner: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """The latest config c <= view whose adoption moved shard s away from
    the group (the reference's ``freeze_epoch``; 0 = never froze):
    view [B, G] or [B, G, N] -> [..., NS]."""
    b, ncfg, ns = cfg_owner.shape
    g = view.shape[1]
    dev = view.device
    gid = torch.arange(g, dtype=I32, device=dev)[None, :, None, None]
    away = ((cfg_owner[:, None, :-1] == gid)
            & (cfg_owner[:, None, 1:] != gid))  # [B, G, NCFG-1, NS]
    cnum = torch.arange(1, ncfg, dtype=I32, device=dev)[:, None]  # [NCFG-1, 1]
    if view.dim() == 3:
        away = away[:, :, None]
    elig = away & (cnum <= view[..., None, None])
    return torch.where(elig, cnum, 0).amax(-2).to(I32)


def _net_pair(keys, skn2, size: int):
    """(delay, lost) of ``size`` inter-group sends a deployment from one
    u32 word each: loss from the top 24 bits, delay from the low byte
    (the reference's ``_net_pair``; a [G, G, NS] shape is one row-major
    stream)."""
    w = prng.bits(keys, size)
    lost = ((w >> 8).to(F32) * (2.0 ** -24)) < skn2.pull_loss
    span = torch.clamp(skn2.pull_delay_max + 1 - skn2.pull_delay_min, min=1)
    delay = skn2.pull_delay_min + torch.remainder(w & 0xFF, span)
    return delay.to(I32), lost


def _ctrl_walk(kcfg: ShardKvConfig, cap: int, st: ShardKvState,
               ctrl: ClusterState):
    """The controller walker's walk_max steps over the stepped controller
    cluster's commit shadow, as the reference's live and computed walkers
    (pass 1) take them: returns (frontier, stalled, win_var, found,
    found_flip), ``win_var`` updated in live mode, ``found`` /
    ``found_flip`` the computed mode's resolving flip (at most one a
    tick)."""
    ncfg, g = kcfg.n_configs, kcfg.n_groups
    dev = ctrl.tick.device
    b = ctrl.tick.shape[0]
    win_var = st.win_var
    frontier, stalled = st.ctrl_w_frontier, st.ctrl_w_stalled
    csh_abs = lane_abs(ctrl.shadow_base, cap)  # [B, cap]
    resolved = torch.cumprod((win_var >= 0).to(I32), -1).sum(-1,
                                                               dtype=I32) - 1
    found = torch.zeros(b, dtype=BOOL, device=dev)
    found_flip = torch.zeros(b, dtype=I32, device=dev)
    slots = torch.arange(ncfg, dtype=I32, device=dev)
    for _ in range(kcfg.walk_max):
        canw = frontier < ctrl.shadow_len
        posw = _slot(frontier + 1, cap)
        in_win = _row_gather(csh_abs, posw, cap) == frontier + 1
        stalled = stalled | (canw & ~in_win)
        canw = canw & in_win
        val = _row_gather(ctrl.shadow_val, posw, cap)
        is_op = canw & (val > 0) & (val != NOOP_CMD)
        if kcfg.live_ctrler:
            aj = torch.clamp(_fdiv(val - 1, 2), 0, ncfg - 1)
            av = torch.remainder(val - 1, 2)
            win_var = torch.where((slots == aj[:, None]) & is_op[:, None]
                                  & (win_var < 0), av[:, None], win_var)
        else:
            applies = (is_op & ~found & (_fdiv(val - 1, g) == resolved + 1)
                       & (resolved + 1 < ncfg))
            flip = torch.clamp(torch.remainder(val - 1, g), 0, g - 1)
            found_flip = torch.where(applies, flip, found_flip)
            found = found | applies
        frontier = torch.where(canw, frontier + 1, frontier)
    return frontier, stalled, win_var.to(I32), found, found_flip.to(I32)


def _ctrl_resolve(kcfg: ShardKvConfig, n: int, st: ShardKvState, t,
                  found, found_flip, skn: ShardKvKnobs) -> dict:
    """The computed controller's pass 2: the single resolution of a tick
    (``found``) flips the canonical member mask (never empty), runs the 4A
    rebalance once per replica with its tie rotation (node id under
    ``bug_rotate_tiebreak``, else 0) and writes the maps, replica 0's as
    the canonical config. Returns the new leaves."""
    g, ncfg = kcfg.n_groups, kcfg.n_configs
    dev = st.cmem.device
    gid = torch.arange(g, dtype=I32, device=dev)
    cmem = st.cmem
    resolved = torch.cumprod((st.win_var >= 0).to(I32), -1).sum(
        -1, dtype=I32) - 1
    nm = torch.where(gid == found_flip[:, None], ~cmem, cmem)
    nm = torch.where(nm.any(-1, keepdim=True), nm, cmem)
    new_mem = torch.where(found[:, None], nm, cmem)
    rot = (torch.arange(n, dtype=I32, device=dev)
           * lane_view(skn.bug_rotate_tiebreak, 2).to(I32))  # [B, n]
    b = cmem.shape[0]
    reb = _ctrler._rebalance(g, new_mem[:, None, :].expand(b, n, g),
                             st.ctrl_node_owner, rot, False, False)
    f1 = found[:, None]
    slot_oh = (torch.arange(ncfg, dtype=I32, device=dev)
               == torch.clamp(resolved + 1, 0, ncfg - 1)[:, None]) & f1
    return dict(
        cmem=new_mem,
        ctrl_node_owner=torch.where(found[:, None, None], reb,
                                    st.ctrl_node_owner),
        ctrl_maps=torch.where(slot_oh[:, None, :, None], reb[:, :, None],
                              st.ctrl_maps),
        cfg_owner=torch.where(slot_oh[..., None], reb[:, None, 0],
                              st.cfg_owner),
        win_var=torch.where(slot_oh, found_flip[:, None], st.win_var),
        slot_tick=torch.where(slot_oh, t[:, None], st.slot_tick),
    )


def _announce(kcfg: ShardKvConfig, cap: int, st: ShardKvState,
              ctrl: ClusterState, frontier, t, key, kn: Knobs,
              skn: ShardKvKnobs) -> tuple:
    """The announcers: the truth (variant 0) and the phantom (variant 1)
    each submit the slot-(frontier + 1) proposal to a random controller
    node, once the schedule says the config is due; it lands where that
    node is an alive leader with room. Live mode proposes ANNOUNCE(j,
    variant), computed mode FLIP(j, gid) with the two competing flips.
    Returns the controller cluster with the appends and the draw keys
    ``ka`` ([B, 6, 2])."""
    ncfg, g, n = kcfg.n_configs, kcfg.n_groups, ctrl.term.shape[1]
    dev = ctrl.tick.device
    ka = prng.split(prng.fold_in(key, _S_ANN), 6)
    jnext = torch.clamp(frontier + 1, 0, ncfg - 1)
    can_ann = (frontier + 1 < ncfg) & (_at(st.cfg_tick, jnext) <= t)
    c_term, c_val, c_len = ctrl.log_term, ctrl.log_val, ctrl.log_len
    me = torch.arange(n, dtype=I32, device=dev)
    lane = torch.arange(cap, dtype=I32, device=dev)
    flow_cap = lane_view(kn.flow_cap, 2)
    for var_bit, p_sub in ((0, skn.p_announce), (1, skn.p_phantom)):
        sub = can_ann & prng.bernoulli(ka[:, 2 * var_bit], p_sub, 1)[:, 0]
        tgt = prng.randint(ka[:, 2 * var_bit + 1], 1, 0, n)
        ok = ((me == tgt) & sub[:, None] & ctrl.alive
              & (ctrl.role == LEADER) & (c_len - ctrl.base < cap)
              & (c_len - ctrl.commit < flow_cap))
        if kcfg.computed_ctrler:
            flips = st.flip_b if var_bit else st.flip_a
            av = jnext * g + _at(flips, jnext) + 1
        else:
            av = jnext * 2 + var_bit + 1
        hit = ok[..., None] & (lane == _slot(c_len + 1, cap)[..., None])
        c_term = torch.where(hit, ctrl.term[..., None], c_term)
        c_val = torch.where(hit, av[:, None, None], c_val)
        c_len = torch.where(ok, c_len + 1, c_len)
    return ctrl._replace(log_term=c_term, log_val=c_val, log_len=c_len,
                         durable_len=durable_after_append(ctrl, c_len)), ka


def _query(kcfg: ShardKvConfig, cap: int, st: ShardKvState,
           ctrl: ClusterState, cst: dict, frontier, t, ka, knet, k2,
           gate_advance, lead_any, poll, l_cfg) -> tuple:
    """The Query protocol to the controller, one outstanding Query a group
    ([B, G]): a response that says config l_cfg + 1 exists lets the leader
    advance, adopting the source it names; requests arriving at an alive
    controller node are answered from its committed prefix (or, under
    ``bug_stale_ctrler_read``, from the first announce of the asked
    config in its log tail; in computed mode the answer is the replica
    itself), each hop lossy and delayed; idle groups with a leader and a
    poll ask a random node for config l_cfg + 1. Returns (can_advance,
    adopt_var, the new cq_* leaves)."""
    ncfg, n, g = kcfg.n_configs, ctrl.term.shape[1], l_cfg.shape[1]
    dev = ctrl.tick.device
    t2 = t[:, None]
    win_var = cst["win_var"]
    rsp_arr = st.cq_rsp_t == t2
    adopt = rsp_arr & st.cq_rsp_found & (st.cq_rsp_j == l_cfg + 1)
    can_advance = gate_advance & adopt
    adopt_var = torch.where(adopt, st.cq_rsp_var, 0)
    cq_rsp_t = torch.where(rsp_arr, 0, st.cq_rsp_t)
    # requests arriving at controller nodes
    req_arr = st.cq_req_t == t2
    me = torch.arange(n, dtype=I32, device=dev)
    node_oh = me == st.cq_req_node[..., None]  # [B, G, N]
    csh_abs = lane_abs(ctrl.shadow_base, cap)  # [B, cap]
    ann_in_win = ((ctrl.shadow_val > 0) & (ctrl.shadow_val != NOOP_CMD)
                  & (csh_abs <= ctrl.shadow_len[:, None]))
    above = (ann_in_win[:, None, :] & (csh_abs[:, None, :]
                                       > ctrl.commit[..., None])).sum(
        -1, dtype=I32)  # [B, N]: committed announces the node lacks
    f1 = frontier[:, None]
    cnt_node = torch.minimum(torch.clamp(f1 - above, min=0), f1)
    cnt_at = torch.where(node_oh, cnt_node[:, None, :], 0).sum(-1, dtype=I32)
    jreq = st.cq_req_j
    wv_req = _at(win_var[:, None, :], torch.clamp(jreq, 0, ncfg - 1))
    found_ok = (jreq <= cnt_at) & (wv_req >= 0)
    if kcfg.computed_ctrler:
        found_rep = found_ok
        var_rep = torch.clamp(st.cq_req_node, 0, n - 1)
    else:
        labs = lane_abs(ctrl.base, cap)  # [B, N, cap]
        lval = ctrl.log_val
        is_ann = ((lval > 0) & (lval != NOOP_CMD)
                  & (labs <= ctrl.log_len[..., None]))
        m = (node_oh[..., None] & is_ann[:, None]
             & (_fdiv(lval - 1, 2)[:, None] == jreq[..., None, None]))
        has_tail = m.any((2, 3))
        amin = torch.where(m, labs[:, None], _BIG).amin((2, 3))
        var_tail = torch.where(m & (labs[:, None] == amin[..., None, None]),
                               torch.remainder(lval - 1, 2)[:, None],
                               0).sum((2, 3), dtype=I32)
        bug = k2.bug_stale_ctrler_read
        found_rep = torch.where(bug, has_tail | found_ok, found_ok)
        var_rep = torch.where(bug & has_tail, var_tail,
                              torch.clamp(wv_req, min=0))
    alive_at = (node_oh & ctrl.alive[:, None, :]).any(-1)
    rdelay, rlost = _net_pair(knet[:, 4], k2, g)
    send = req_arr & alive_at & ~rlost
    cq_rsp_t = torch.where(send, t2 + rdelay, cq_rsp_t)
    cq_rsp_j = torch.where(send, jreq, st.cq_rsp_j)
    cq_rsp_found = torch.where(send, found_rep, st.cq_rsp_found)
    cq_rsp_var = torch.where(send, var_rep, st.cq_rsp_var).to(I32)
    cq_req_t = torch.where(req_arr, 0, st.cq_req_t)
    # fresh Queries from idle groups
    idle = (cq_req_t == 0) & (cq_rsp_t == 0)
    ask = lead_any & poll & idle & (l_cfg + 1 < ncfg)
    tgtq = prng.randint(ka[:, 4], g, 0, n)
    qdelay, qlost = _net_pair(knet[:, 5], k2, g)
    sendq = ask & ~qlost
    return can_advance, adopt_var.to(I32), dict(
        cq_req_t=torch.where(sendq, t2 + qdelay, cq_req_t).to(I32),
        cq_req_node=torch.where(sendq, tgtq, st.cq_req_node).to(I32),
        cq_req_j=torch.where(sendq, l_cfg + 1, st.cq_req_j).to(I32),
        cq_rsp_t=cq_rsp_t.to(I32), cq_rsp_j=cq_rsp_j.to(I32),
        cq_rsp_found=cq_rsp_found, cq_rsp_var=cq_rsp_var)


def _map_at(ctrl_maps: torch.Tensor, src, cj) -> torch.Tensor:
    """Replica ``src``'s computed owner map of config ``cj`` (both clipped
    to range): ctrl_maps [B, N, NCFG, NS], src / cj [B, ...] ->
    [B, ..., NS] (the reference's ``map_at``)."""
    b, n, ncfg, ns = ctrl_maps.shape
    idx = (torch.clamp(src, 0, n - 1) * ncfg + torch.clamp(cj, 0, ncfg - 1))
    flat = idx.reshape(b, -1).long()
    out = ctrl_maps.reshape(b, n * ncfg, ns).gather(
        1, flat[..., None].expand(-1, -1, ns))
    return out.reshape(*idx.shape, ns)


def _shardkv_service_tick(cfg: SimConfig, kcfg: ShardKvConfig,
                          st: ShardKvState, pre_alive: torch.Tensor,
                          pre_base: torch.Tensor, s: ClusterState,
                          keys: torch.Tensor, kn: Knobs,
                          skn: ShardKvKnobs, ctrl=None) -> ShardKvState:
    """The service share of one tick for every deployment, given the
    stepped group rafts ``s`` ([B, G, ...]), the pre-tick ``alive`` /
    ``base`` ([B, G, N]) and, in a controller mode, the stepped controller
    cluster ``ctrl`` ([B, ...]; None: ``st.ctrl``, the schedule mode's
    placeholder): the reference's ``_shardkv_service_tick`` (its comments
    explain each step), batch-first. Kernel K11's plain version."""
    g, n, cap = kcfg.n_groups, cfg.n_nodes, cfg.log_cap
    ns, nc, ncfg = kcfg.n_shards, kcfg.n_clients, kcfg.n_configs
    dev = s.tick.device
    b = s.tick.shape[0]
    metrics = cfg.metrics
    t = s.tick[:, 0]  # the groups tick in lockstep
    t1 = t[:, None]
    key = prng.fold_in(keys, t)
    viol = torch.zeros(b, dtype=I32, device=dev)
    k2, k4 = skn.lanes(2), skn.lanes(4)  # against [B, m] / [B, G, N, NS]
    cfg_owner = st.cfg_owner
    gid = torch.arange(g, dtype=I32, device=dev)
    me = torch.arange(n, dtype=I32, device=dev)
    sh_ids = torch.arange(ns, dtype=I32, device=dev)
    cl_ids = torch.arange(nc, dtype=I32, device=dev)
    computed = kcfg.computed_ctrler
    src_lim = n if computed else 2
    if ctrl is None:
        ctrl = st.ctrl

    active_cfg = (st.cfg_tick <= t1).sum(-1, dtype=I32) - 1
    # the controller: its walker, the computed mode's resolution, the
    # announcers (the controller's committed frontier replaces the
    # schedule as the controller's view)
    cst = {}
    if _ctrl_mode(kcfg):
        frontier, stalled, win_var, found, found_flip = _ctrl_walk(
            kcfg, cap, st, ctrl)
        cst = dict(ctrl_w_frontier=frontier, ctrl_w_stalled=stalled,
                   win_var=win_var)
        if computed:
            cst.update(_ctrl_resolve(kcfg, n, st, t, found, found_flip, skn))
            cfg_owner = cst["cfg_owner"]
        active_cfg = torch.cumprod((cst["win_var"] >= 0).to(I32), -1).sum(
            -1, dtype=I32) - 1
        ctrl, ka = _announce(kcfg, cap, st._replace(**cst), ctrl,
                             active_cfg, t, key, kn, skn)
    win_var = cst.get("win_var", st.win_var)
    ctrl_maps = cst.get("ctrl_maps", st.ctrl_maps)

    # 1. crash / restart: the live service state resets to the snapshot
    fresh = (~pre_alive & s.alive) | ~s.alive  # [B, G, N]
    f1, f2 = fresh[..., None], fresh[..., None, None]
    applied = torch.where(fresh, s.base, st.applied)
    node_cfg = torch.where(fresh, st.snap_cfg, st.node_cfg)
    node_src = torch.where(fresh, st.snap_src, st.node_src)
    phase = torch.where(f1, st.snap_phase, st.phase)
    key_hash = torch.where(f1, st.snap_hash, st.key_hash)
    key_count = torch.where(f1, st.snap_count, st.key_count)
    last_seq = torch.where(f2, st.snap_last_seq, st.last_seq)
    restarted = ~pre_alive & s.alive
    max_cfg_lag = torch.maximum(st.max_cfg_lag, torch.where(
        restarted, active_cfg[:, None, None] - node_cfg, 0).amax((1, 2)))

    # 2. compaction: capture the live tables as the persisted snapshot
    inst = s.snap_installed_src >= 0
    comp = (s.base != pre_base) & ~inst & s.alive
    c1, c2 = comp[..., None], comp[..., None, None]
    snap_cfg = torch.where(comp, node_cfg, st.snap_cfg)
    snap_src = torch.where(comp, node_src, st.snap_src)
    snap_phase = torch.where(c1, phase, st.snap_phase)
    snap_hash = torch.where(c1, key_hash, st.snap_hash)
    snap_count = torch.where(c1, key_count, st.snap_count)
    snap_last_seq = torch.where(c2, last_seq, st.snap_last_seq)

    # 3. install-snapshot: adopt the in-group sender's snapshot (as just
    # captured), one-hot over the sender axis
    src_oh = me == s.snap_installed_src[..., None]  # [B, G, N, Nsrc]

    def adopt(snap):  # [B, G, N, ...] -> the sender's row at each node
        extra = snap.dim() - 3
        w = src_oh.reshape(*src_oh.shape, *(1,) * extra)
        return torch.where(w, snap[:, :, None], 0).sum(3, dtype=I32)

    i1, i2 = inst[..., None], inst[..., None, None]
    applied = torch.where(inst, s.base, applied)
    node_cfg = torch.where(inst, adopt(snap_cfg), node_cfg)
    node_src = torch.where(inst, adopt(snap_src), node_src)
    phase = torch.where(i1, adopt(snap_phase), phase)
    key_hash = torch.where(i1, adopt(snap_hash), key_hash)
    key_count = torch.where(i1, adopt(snap_count), key_count)
    last_seq = torch.where(i2, adopt(snap_last_seq), last_seq)
    snap_cfg = torch.where(inst, node_cfg, snap_cfg)
    snap_src = torch.where(inst, node_src, snap_src)
    snap_phase = torch.where(i1, phase, snap_phase)
    snap_hash = torch.where(i1, key_hash, snap_hash)
    snap_count = torch.where(i1, key_count, snap_count)
    snap_last_seq = torch.where(i2, last_seq, snap_last_seq)

    # ---------------------------------------------------------- apply machines
    clerk_get_obs = st.clerk_get_obs
    my_g = gid[None, :, None, None]
    skip_freeze = k4.bug_skip_freeze
    drop_dup = lane_view(skn.bug_drop_dup_table, 5)
    stg_last_seq = st.staged_last_seq[:, :, None]  # [B, G, 1, NS, NC]
    for _ in range(kcfg.apply_max):
        can = s.alive & (applied < s.commit)
        val = _row_gather(s.log_val, _slot(applied + 1, cap), cap)  # [B, G, N]
        kind, client, seq, shard, cfg_c, cfg_i, var_c = _unpack(kcfg, val,
                                                                src_lim)
        client = torch.clamp(client, 0, nc - 1)
        sh_oh = sh_ids == shard[..., None]  # [B, G, N, NS]
        cl_oh = cl_ids == client[..., None]  # [B, G, N, NC]
        cur_phase = torch.where(sh_oh, phase, 0).sum(-1, dtype=I32)
        prev_seq = torch.where(sh_oh[..., None] & cl_oh[..., None, :],
                               last_seq, 0).sum((-2, -1), dtype=I32)
        is_rw = can & ((kind == _APPEND) | (kind == _PUT) | (kind == _GET))
        acc_rw = is_rw & (cur_phase == OWNED) & (seq > prev_seq)
        acc = acc_rw & (kind != _GET)
        upd = sh_oh & acc[..., None]
        key_hash = torch.where(upd, _wrap_i32(
            key_hash.to(torch.int64) * 1000003
            + val[..., None].to(torch.int64)), key_hash)
        key_count = torch.where(upd, key_count + 1, key_count)
        last_seq = torch.where(
            sh_oh[..., None] & acc_rw[..., None, None] & cl_oh[..., None, :],
            torch.maximum(last_seq, seq[..., None, None]), last_seq)
        cur_count = torch.where(sh_oh, key_count, 0).sum(-1, dtype=I32)
        get_acc = (acc_rw & (kind == _GET)).reshape(b, 1, -1)
        m = (get_acc & (client.reshape(b, 1, -1) == cl_ids[None, :, None])
             & (seq.reshape(b, 1, -1) == st.clerk_seq[:, :, None]))
        cand = torch.where(m, cur_count.reshape(b, 1, -1), -1).amax(-1)
        clerk_get_obs = torch.where((clerk_get_obs < 0) & (cand >= 0), cand,
                                    clerk_get_obs)

        is_cfg = can & (kind == _CONFIG) & (cfg_c == node_cfg + 1)
        if computed:
            # the adopted replica's map, and the node's own last adoption
            new_owner = _map_at(ctrl_maps, var_c, cfg_c)
            prev_owner = _map_at(ctrl_maps, node_src, node_cfg)
        else:
            new_owner = _rows_of(cfg_owner, cfg_c)
            prev_owner = _rows_of(cfg_owner, cfg_c - 1)
        gains = (new_owner == my_g) & (phase == ABSENT)
        loses = (new_owner != my_g) & (phase == OWNED)
        from_nobody = prev_owner == new_owner
        phase = torch.where(is_cfg[..., None] & gains,
                            torch.where(from_nobody, OWNED, PULLING), phase)
        phase = torch.where(is_cfg[..., None] & loses & ~skip_freeze, FROZEN,
                            phase).to(I32)
        node_cfg = torch.where(is_cfg, cfg_c, node_cfg)
        if computed:
            node_src = torch.where(is_cfg, torch.clamp(var_c, 0, n - 1),
                                   node_src)

        stg_cfg_at = torch.where(sh_oh, st.staged_cfg[:, :, None, :],
                                 0).sum(-1, dtype=I32)
        is_inst = can & (kind == _INSTALL) & (stg_cfg_at == cfg_i)
        inst_upd = sh_oh & is_inst[..., None] & (phase == PULLING)
        key_hash = torch.where(inst_upd, st.staged_hash[:, :, None, :],
                               key_hash)
        key_count = torch.where(inst_upd, st.staged_count[:, :, None, :],
                                key_count)
        last_seq = torch.where(inst_upd[..., None],
                               torch.where(drop_dup, 0, stg_last_seq),
                               last_seq)
        phase = torch.where(inst_upd, OWNED, phase).to(I32)

        fe_at = torch.where(sh_oh, _freeze_epoch(cfg_owner, node_cfg),
                            0).sum(-1, dtype=I32)
        is_del = can & (kind == _DELETE) & (cfg_i == fe_at)
        del_upd = sh_oh & is_del[..., None] & (phase == FROZEN)
        phase = torch.where(del_upd, ABSENT, phase).to(I32)
        key_hash = torch.where(del_upd, 0, key_hash)
        key_count = torch.where(del_upd, 0, key_count)
        last_seq = torch.where(del_upd[..., None], 0, last_seq)
        applied = torch.where(can, applied + 1, applied)

    # ------------------------------------------------------------ truth walker
    w_frontier, w_cfg = st.w_frontier, st.w_cfg
    w_phase, w_hash, w_count = st.w_phase, st.w_hash, st.w_count
    w_last_seq = st.w_last_seq
    frz_cfg, frz_hash = st.frz_cfg, st.frz_hash
    frz_count, frz_last_seq = st.frz_count, st.frz_last_seq
    truth_count, w_clerk_acked = st.truth_count, st.w_clerk_acked
    installs_done, deletes_done = st.installs_done, st.deletes_done
    w_src = st.w_src
    sh_abs = lane_abs(s.shadow_base, cap)  # [B, G, cap]
    my_gv = gid[None, :, None]
    for _ in range(kcfg.walk_max):
        canw = w_frontier < s.shadow_len
        posw = _slot(w_frontier + 1, cap)
        in_win = _row_gather(sh_abs, posw, cap) == w_frontier + 1
        val = _row_gather(s.shadow_val, posw, cap)  # [B, G]
        canw = canw & in_win
        kind, client, seq, shard, cfg_c, cfg_i, var_c = _unpack(kcfg, val,
                                                                src_lim)
        client = torch.clamp(client, 0, nc - 1)
        sh_oh = sh_ids == shard[..., None]  # [B, G, NS]
        cl_oh = cl_ids == client[..., None]  # [B, G, NC]
        cur_phase = torch.where(sh_oh, w_phase, 0).sum(-1, dtype=I32)
        frz_at = torch.where(sh_oh, frz_cfg[:, None, :], 0).sum(-1, dtype=I32)
        stall = (canw & (kind == _INSTALL) & (cur_phase == PULLING)
                 & (frz_at != cfg_i))
        canw = canw & ~stall
        if kcfg.live_ctrler:
            # the adopted announce variant must be the controller's
            # first-committed one
            stale = (canw & (kind == _CONFIG) & (cfg_c == w_cfg + 1)
                     & (var_c != _at(win_var[:, None, :],
                                     torch.clamp(cfg_c, 0, ncfg - 1))))
            viol |= torch.where(stale.any(-1), VIOLATION_SHARD_CTRL_STALE,
                                0).to(I32)
        prev_seq = torch.where(sh_oh[..., None] & cl_oh[:, :, None, :],
                               w_last_seq, 0).sum((-2, -1), dtype=I32)
        is_rw = canw & ((kind == _APPEND) | (kind == _PUT) | (kind == _GET))
        acc_rw = is_rw & (cur_phase == OWNED) & (seq > prev_seq)
        acc = acc_rw & (kind != _GET)
        upd = sh_oh & acc[..., None]
        w_hash = torch.where(upd, _wrap_i32(
            w_hash.to(torch.int64) * 1000003 + val[..., None].to(torch.int64)),
            w_hash)
        w_count = torch.where(upd, w_count + 1, w_count)
        w_last_seq = torch.where(
            sh_oh[..., None] & acc_rw[..., None, None] & cl_oh[:, :, None, :],
            torch.maximum(w_last_seq, seq[..., None, None]), w_last_seq)
        truth_count = truth_count + upd.sum(1, dtype=I32)
        w_clerk_acked = torch.maximum(w_clerk_acked, torch.where(
            cl_oh & acc_rw[..., None], seq[..., None], 0).amax(1))

        is_cfg = canw & (kind == _CONFIG) & (cfg_c == w_cfg + 1)
        if computed:
            new_owner = _map_at(ctrl_maps, var_c, cfg_c)  # [B, G, NS]
            prev_owner = _map_at(ctrl_maps, w_src, w_cfg)
            # the adopted map must be the canonical decision (replica 0's)
            stale = is_cfg & (new_owner != _rows_of(cfg_owner, cfg_c)).any(-1)
            viol |= torch.where(stale.any(-1), VIOLATION_SHARD_CTRL_STALE,
                                0).to(I32)
            w_src = torch.where(is_cfg, torch.clamp(var_c, 0, n - 1), w_src)
        else:
            new_owner = _rows_of(cfg_owner, cfg_c)  # [B, G, NS]
            prev_owner = _rows_of(cfg_owner, cfg_c - 1)
        gains = (new_owner == my_gv) & (w_phase == ABSENT)
        loses = (new_owner != my_gv) & (w_phase == OWNED)
        from_nobody = prev_owner == new_owner
        freeze = is_cfg[..., None] & loses
        any_freeze = freeze.any(1)  # [B, NS]
        frz_cfg = torch.where(any_freeze, torch.where(
            freeze, cfg_c[..., None], -1).amax(1), frz_cfg)
        frz_hash = torch.where(any_freeze, torch.where(
            freeze, w_hash, 0).sum(1, dtype=I32), frz_hash)
        frz_count = torch.where(any_freeze, torch.where(
            freeze, w_count, 0).sum(1, dtype=I32), frz_count)
        frz_last_seq = torch.where(any_freeze[..., None], torch.where(
            freeze[..., None], w_last_seq, 0).sum(1, dtype=I32), frz_last_seq)
        w_phase = torch.where(is_cfg[..., None] & gains,
                              torch.where(from_nobody, OWNED, PULLING),
                              w_phase)
        w_phase = torch.where(freeze, FROZEN, w_phase).to(I32)
        w_cfg = torch.where(is_cfg, cfg_c, w_cfg)

        is_inst = canw & (kind == _INSTALL)
        inst_upd = sh_oh & is_inst[..., None] & (w_phase == PULLING)
        w_hash = torch.where(inst_upd, frz_hash[:, None, :], w_hash)
        w_count = torch.where(inst_upd, frz_count[:, None, :], w_count)
        w_last_seq = torch.where(inst_upd[..., None], frz_last_seq[:, None],
                                 w_last_seq)
        w_phase = torch.where(inst_upd, OWNED, w_phase).to(I32)
        installs_done = installs_done + inst_upd.sum((1, 2), dtype=I32)

        fe_w_at = torch.where(sh_oh, _freeze_epoch(cfg_owner, w_cfg),
                              0).sum(-1, dtype=I32)
        is_del = canw & (kind == _DELETE) & (cfg_i == fe_w_at)
        del_upd = sh_oh & is_del[..., None] & (w_phase == FROZEN)
        w_phase = torch.where(del_upd, ABSENT, w_phase).to(I32)
        w_hash = torch.where(del_upd, 0, w_hash)
        w_count = torch.where(del_upd, 0, w_count)
        w_last_seq = torch.where(del_upd[..., None], 0, w_last_seq)
        deletes_done = deletes_done + del_upd.sum((1, 2), dtype=I32)
        w_frontier = torch.where(canw, w_frontier + 1, w_frontier)

    # ----------------------------------------------------------------- oracles
    at_frontier = s.alive & (applied == w_frontier[..., None])
    m_state = ((phase == w_phase[:, :, None]) & (key_hash == w_hash[:, :, None])
               & (key_count == w_count[:, :, None]))
    m_dup = (last_seq == w_last_seq[:, :, None]).all(-1)
    m_cfg = node_cfg == w_cfg[..., None]
    diverge = at_frontier & ~((m_state & m_dup).all(-1) & m_cfg)
    viol |= torch.where(diverge.any((1, 2)), VIOLATION_SHARD_DIVERGE, 0).to(I32)
    owned_ct = (w_phase == OWNED).sum(1, dtype=I32)
    viol |= torch.where((owned_ct > 1).any(-1), VIOLATION_SHARD_OWNERSHIP,
                        0).to(I32)
    leak = s.alive[..., None] & (phase == ABSENT) & ((key_hash != 0)
                                                     | (key_count != 0))
    viol |= torch.where(leak.any((1, 2, 3)), VIOLATION_SHARD_STORAGE,
                        0).to(I32)

    # ------------------------------------------------- inter-group mailboxes
    is_lead = s.alive & (s.role == LEADER)  # [B, G, N]
    lead_any = is_lead.any(-1)  # [B, G]
    lead_node = torch.argmax(torch.where(is_lead, applied, -1), -1)  # [B, G]
    ln_oh = me == lead_node[..., None]  # [B, G, N]

    def lead_view(x):  # [B, G, N, ...] -> [B, G, ...] at the leader node
        return x.gather(2, lead_node.reshape(b, g, 1, *(1,) * (x.dim() - 3))
                        .expand(b, g, 1, *x.shape[3:]))[:, :, 0]

    l_phase, l_cfg = lead_view(phase), lead_view(node_cfg)
    l_hash, l_count = lead_view(key_hash), lead_view(key_count)
    l_last_seq = lead_view(last_seq)  # [B, G, NS, NC]

    kp = prng.split(prng.fold_in(key, _S_PULL), 4)
    knet = prng.split(prng.fold_in(key, _S_NET_PULL), 6)
    ggs = (b, g, g, ns)

    def net(j):
        delay, lost = _net_pair(knet[:, j], k2, g * g * ns)
        return delay.view(ggs), lost.view(ggs)

    # pull requests arrive at the src: its leader answers for FROZEN shards
    req_arr = st.pull_req_t == t[:, None, None, None]
    answer = (req_arr & (l_phase == FROZEN)[:, None]
              & (l_cfg[:, None, :, None] >= st.pull_req_cfg)
              & lead_any[:, None, :, None])
    delay, lost = net(0)
    send_rsp = answer & ~lost
    pull_rsp_t = torch.where(send_rsp, t[:, None, None, None] + delay,
                             st.pull_rsp_t)
    pull_rsp_cfg = torch.where(send_rsp, st.pull_req_cfg, st.pull_rsp_cfg)
    pull_rsp_hash = torch.where(send_rsp, l_hash[:, None], st.pull_rsp_hash)
    pull_rsp_count = torch.where(send_rsp, l_count[:, None],
                                 st.pull_rsp_count)
    pull_rsp_last_seq = torch.where(send_rsp[..., None], l_last_seq[:, None],
                                    st.pull_rsp_last_seq)
    pull_req_t = torch.where(req_arr, 0, st.pull_req_t)

    # pull responses arrive at the dst: stage the payload
    rsp_arr = pull_rsp_t == t[:, None, None, None]
    got = rsp_arr.any(2)  # [B, dst, NS]
    pick = rsp_arr.to(I32)
    staged_cfg = torch.where(got, torch.where(rsp_arr, pull_rsp_cfg,
                                              -1).amax(2), st.staged_cfg)
    staged_hash = torch.where(got, (pull_rsp_hash * pick).sum(2, dtype=I32),
                              st.staged_hash)
    staged_count = torch.where(got, (pull_rsp_count * pick).sum(2, dtype=I32),
                               st.staged_count)
    staged_last_seq = torch.where(
        got[..., None], (pull_rsp_last_seq * pick[..., None]).sum(2, dtype=I32),
        st.staged_last_seq)
    pull_rsp_t = torch.where(rsp_arr, 0, pull_rsp_t)

    freeze_cfg = _freeze_epoch(cfg_owner, l_cfg)  # [B, G, NS]

    # GC confirms at the holder first; then confirm requests at the owner
    grsp_arr = st.gcq_rsp_t == t[:, None, None, None]
    ack_del = ((grsp_arr & (st.gcq_rsp_cfg == freeze_cfg[:, :, None])).any(2)
               & (l_phase == FROZEN))
    gcq_rsp_t = torch.where(grsp_arr, 0, st.gcq_rsp_t)
    gq_arr = st.gcq_req_t == t[:, None, None, None]
    lc = l_cfg[:, :, None, None]
    installed = (((lc > st.gcq_req_cfg)
                  | ((lc == st.gcq_req_cfg) & (l_phase == OWNED)[:, :, None]))
                 & lead_any[:, :, None, None])
    gdelay, glost = net(1)
    send_grsp = ((gq_arr & installed & ~glost).transpose(1, 2).contiguous()
                 & (gcq_rsp_t == 0))
    gcq_rsp_t = torch.where(send_grsp, t[:, None, None, None] + gdelay,
                            gcq_rsp_t)
    gcq_rsp_cfg = torch.where(send_grsp,
                              st.gcq_req_cfg.transpose(1, 2).contiguous(),
                              st.gcq_rsp_cfg)
    gcq_req_t = torch.where(gq_arr, 0, st.gcq_req_t)

    # ------------------------------------------- leader protocol transitions
    poll = prng.bernoulli(kp[:, 0], skn.p_cfg_learn, g)
    next_owner_l = _rows_of(cfg_owner, l_cfg + 1)
    regain_blocked = ((l_phase == FROZEN) & (next_owner_l == my_gv)).any(-1)
    gate_advance = (lead_any & ~(l_phase == PULLING).any(-1)
                    & ~regain_blocked)
    adopt_var = torch.zeros((b, g), dtype=I32, device=dev)
    if _ctrl_mode(kcfg):
        can_advance, adopt_var, cq = _query(kcfg, cap, st, ctrl, cst,
                                            active_cfg, t, ka, knet, k2,
                                            gate_advance, lead_any, poll,
                                            l_cfg)
        cst.update(cq)
    else:
        can_advance = gate_advance & poll & (l_cfg < active_cfg[:, None])
    want_pull = (l_phase == PULLING) & lead_any[..., None]
    pull_draw = prng.bernoulli(kp[:, 1], skn.p_pull, g * ns).view(b, g, ns)
    prev_owner_l = _rows_of(cfg_owner, l_cfg - 1)
    do_pull = want_pull & pull_draw
    tgt_oh = prev_owner_l[:, :, None, :] == gid[None, None, :, None]
    delay2, lost2 = net(2)
    send_req = do_pull[:, :, None] & tgt_oh & ~lost2
    pull_req_t = torch.where(send_req, t[:, None, None, None] + delay2,
                             pull_req_t)
    pull_req_cfg = torch.where(send_req, l_cfg[:, :, None, None],
                               st.pull_req_cfg)
    gain_owner = torch.where(
        torch.arange(ncfg, dtype=I32, device=dev)[:, None]
        == freeze_cfg[:, :, None, :], cfg_owner[:, None], 0).sum(2, dtype=I32)
    gc_draw = prng.bernoulli(kp[:, 3], skn.p_ack, g * ns).view(b, g, ns)
    do_gcq = ((l_phase == FROZEN) & (freeze_cfg > 0) & gc_draw
              & lead_any[..., None])
    gtgt_oh = gain_owner[:, :, None, :] == gid[None, None, :, None]
    gdelay2, glost2 = net(3)
    send_gcq = ((do_gcq[:, :, None] & gtgt_oh).transpose(1, 2).contiguous()
                & ~glost2 & (gcq_req_t == 0))
    gcq_req_t = torch.where(send_gcq, t[:, None, None, None] + gdelay2,
                            gcq_req_t)
    gcq_req_cfg = torch.where(send_gcq, freeze_cfg[:, None], st.gcq_req_cfg)

    # --------------------------------------------------------------- clerks
    kc = prng.split(prng.fold_in(key, _S_CLERK), 6)
    truth_at = _at(truth_count[:, None, :], st.clerk_shard)
    is_get_c = st.clerk_kind == _GET
    clerk_cmt, clerk_apl = st.clerk_cmt, st.clerk_apl
    if metrics:
        clerk_cmt = torch.where(st.clerk_out & (w_clerk_acked >= st.clerk_seq)
                                & (clerk_cmt == 0), t1, clerk_cmt)
        clerk_apl = torch.where(st.clerk_out & (clerk_get_obs >= 0)
                                & (clerk_apl == 0), t1, clerk_apl)
    newly = (st.clerk_out & (w_clerk_acked >= st.clerk_seq)
             & (~is_get_c | (clerk_get_obs >= 0)))
    done_get = newly & is_get_c
    viol |= torch.where(
        (done_get & ((clerk_get_obs < st.clerk_get_lo)
                     | (clerk_get_obs > truth_at))).any(-1),
        VIOLATION_SHARD_STALE_READ, 0).to(I32)
    clerk_acked = torch.where(newly, st.clerk_seq, st.clerk_acked)
    clerk_out = st.clerk_out & ~newly
    gets_done = st.gets_done + done_get.to(I32)
    lat_hist, phase_hist = st.lat_hist, st.phase_hist
    phase_ticks, lat_ticks = st.phase_ticks, st.lat_ticks
    worst = (st.worst_lat, st.worst_phases, st.worst_key, st.worst_client,
             st.worst_sub)
    key_lat_hist, client_lat_hist = st.key_lat_hist, st.client_lat_hist
    cl_b = cl_ids.expand(b, nc)
    if metrics:
        e2e = t1 - st.clerk_sub
        lat_hist = _m.fold_latencies(lat_hist, e2e, newly)
        ph = _phase_matrix(t1, st.clerk_sub, st.clerk_app, clerk_cmt,
                           clerk_apl, st.clerk_mig, is_get_c)
        phase_hist, phase_ticks, lat_ticks = _m.fold_phases(
            phase_hist, phase_ticks, lat_ticks, ph, e2e, newly)
        worst = _m.update_worst(worst, e2e, newly, ph, st.clerk_shard, cl_b,
                                st.clerk_sub)
        key_lat_hist = _m.fold_latencies_by(key_lat_hist, e2e, newly,
                                            st.clerk_shard)
        client_lat_hist = _m.fold_latencies_by(client_lat_hist, e2e, newly,
                                               cl_b)
    learn = prng.bernoulli(kc[:, 0], skn.p_cfg_learn, nc) | (
        k2.requery_wrong_group & st.clerk_wrong)
    clerk_cfg = torch.where(learn, active_cfg[:, None], st.clerk_cfg)
    w_start = prng.bits(kc[:, 1], nc)
    u_start = (((w_start >> 9) | 0x3F800000).to(I32).view(F32) - 1.0)
    openloop = k2.open_queue_cap > 0
    arrive = openloop & ((w_start & 0x1FF).to(F32) * (2.0 ** -9)
                         < k2.open_rate)
    drop = arrive & (st.open_arr - st.open_srv >= k2.open_queue_cap)
    enq = arrive & ~drop
    open_arr = st.open_arr + enq.to(I32)
    open_drop = st.open_drop + drop.to(I32)
    open_stamp = st.open_stamp
    slots = torch.arange(OPEN_QUEUE_SLOTS, dtype=I32, device=dev)
    if metrics:
        slot_e = slots == torch.remainder(st.open_arr, OPEN_QUEUE_SLOTS)[..., None]
        open_stamp = torch.where(enq[..., None] & slot_e, t[:, None, None],
                                 st.open_stamp)
    start = (~clerk_out
             & torch.where(openloop, open_arr > st.open_srv,
                           u_start < k2.p_op)
             & (st.clerk_seq < _SEQ_LIM - 1))
    open_srv = st.open_srv + (openloop & start).to(I32)
    clerk_seq = torch.where(start, st.clerk_seq + 1, st.clerk_seq)
    clerk_shard = torch.where(
        start, zipf_map(prng.randint(kc[:, 2], nc, 0, ns), ns, k2.zipf_a),
        st.clerk_shard)
    u_kind = prng.uniform(kc[:, 5], nc)
    clerk_kind = torch.where(
        start,
        torch.where(u_kind < k2.p_get, _GET,
                    torch.where(u_kind < k2.p_get + k2.p_put, _PUT, _APPEND)),
        st.clerk_kind).to(I32)
    truth_at_new = _at(truth_count[:, None, :], clerk_shard)
    clerk_get_lo = torch.where(start, truth_at_new, st.clerk_get_lo)
    clerk_get_obs = torch.where(start, -1, clerk_get_obs)
    clerk_sub, clerk_app, clerk_mig = st.clerk_sub, st.clerk_app, st.clerk_mig
    if metrics:
        slot_d = slots == torch.remainder(st.open_srv, OPEN_QUEUE_SLOTS)[..., None]
        arr_t = torch.where(slot_d, open_stamp, 0).sum(-1, dtype=I32)
        clerk_sub = torch.where(start, torch.where(openloop, arr_t, t1),
                                clerk_sub)
        clerk_app = torch.where(start, 0, clerk_app)
        clerk_cmt = torch.where(start, 0, clerk_cmt)
        clerk_apl = torch.where(start, 0, clerk_apl)
        clerk_mig = torch.where(start, 0, clerk_mig)
    clerk_out = clerk_out | start
    retry = clerk_out & (start | prng.bernoulli(kc[:, 3], skn.p_retry, nc))
    client_retries = st.client_retries
    if metrics:
        client_retries = client_retries + retry.to(I32)
    tgt_node = prng.randint(kc[:, 4], nc, 0, n)

    # ---------------------------- service-layer log appends (post-raft-tick)
    log_term, log_val, log_len = s.log_term, s.log_val, s.log_len
    lane = torch.arange(cap, dtype=I32, device=dev)
    flow_cap = lane_view(kn.flow_cap, 3)

    def append_at(mask, value, log_term, log_val, log_len):
        ok = (mask & s.alive & (log_len - s.base < cap)
              & (log_len - s.commit < flow_cap))
        hit = ok[..., None] & (lane == _slot(log_len + 1, cap)[..., None])
        log_term = torch.where(hit, s.term[..., None], log_term)
        log_val = torch.where(hit, value[..., None], log_val)
        return log_term, log_val, torch.where(ok, log_len + 1, log_len), ok

    lead_sel = ln_oh & is_lead
    log_term, log_val, log_len, _ = append_at(
        lead_sel & can_advance[..., None],
        _pack_config(node_cfg + 1, adopt_var[..., None], src_lim),
        log_term, log_val, log_len)
    inst_ready = want_pull & (staged_cfg == l_cfg[..., None])
    for sh in range(ns):
        log_term, log_val, log_len, _ = append_at(
            lead_sel & inst_ready[:, :, sh:sh + 1],
            _pack_install(kcfg, node_cfg, sh), log_term, log_val, log_len)
    for sh in range(ns):
        v = _pack_delete(kcfg, freeze_cfg[:, :, sh:sh + 1], sh).expand(b, g, n)
        log_term, log_val, log_len, _ = append_at(
            lead_sel & ack_del[:, :, sh:sh + 1], v, log_term, log_val,
            log_len)

    # bug mode: the contacted node serves a Get from its local copy
    grp_c = _at(_rows_of(cfg_owner, clerk_cfg), clerk_shard)  # [B, NC]
    tgt_gn = ((gid[None, None, :, None] == grp_c[..., None, None])
              & (me[None, None, None, :] == tgt_node[..., None, None]))
    # the targeted (group, node, shard) cell: every index is in range
    gn_at = (grp_c * n + tgt_node).long()
    cell = gn_at * ns + clerk_shard.long()
    ph_at = phase.reshape(b, -1).gather(1, cell)
    cnt_at = key_count.reshape(b, -1).gather(1, cell)
    alive_at = s.alive.reshape(b, -1).gather(1, gn_at)
    served = (k2.bug_serve_frozen & retry & ~start & (clerk_kind == _GET)
              & alive_at & (ph_at != OWNED))
    viol |= torch.where(
        (served & ((cnt_at < clerk_get_lo) | (cnt_at > truth_at_new))).any(-1),
        VIOLATION_SHARD_STALE_READ, 0).to(I32)
    clerk_acked = torch.where(served, clerk_seq, clerk_acked)
    clerk_out = clerk_out & ~served
    gets_done = gets_done + served.to(I32)
    retry = retry & ~served
    if metrics:
        e2e_s = t1 - clerk_sub
        lat_hist = _m.fold_latencies(lat_hist, e2e_s, served)
        zeros = torch.zeros_like(e2e_s)
        ph_s = torch.stack([zeros, zeros, e2e_s, zeros, zeros], dim=-2)
        phase_hist, phase_ticks, lat_ticks = _m.fold_phases(
            phase_hist, phase_ticks, lat_ticks, ph_s, e2e_s, served)
        worst = _m.update_worst(worst, e2e_s, served, ph_s, clerk_shard, cl_b,
                                clerk_sub)
        key_lat_hist = _m.fold_latencies_by(key_lat_hist, e2e_s, served,
                                            clerk_shard)
        client_lat_hist = _m.fold_latencies_by(client_lat_hist, e2e_s,
                                               served, cl_b)
    lead_at_c = is_lead.reshape(b, -1).gather(1, gn_at)
    clerk_wrong = torch.where(retry, lead_at_c & (ph_at != OWNED),
                              st.clerk_wrong & ~learn)
    if metrics:
        clerk_mig = torch.where(clerk_out & (clerk_app == 0) & clerk_wrong,
                                clerk_mig + 1, clerk_mig)

    # client ops at the believed owner's targeted node, one after another
    landed = []
    for c in range(nc):
        sel = tgt_gn[:, c] & is_lead & retry[:, c, None, None]
        v = _pack_op(kcfg, c, clerk_seq[:, c], clerk_shard[:, c],
                     clerk_kind[:, c])
        log_term, log_val, log_len, ok = append_at(
            sel, v[:, None, None].expand(b, g, n), log_term, log_val, log_len)
        landed.append(ok.any((1, 2)))
    if metrics:
        clerk_app = torch.where(torch.stack(landed, -1) & clerk_out
                                & (clerk_app == 0), t1, clerk_app)

    violations = st.violations | viol
    first_violation_tick = torch.where(
        (st.first_violation_tick < 0) & (viol != 0), t, st.first_violation_tick)
    rafts = s._replace(
        log_term=log_term, log_val=log_val, log_len=log_len,
        durable_len=torch.where(log_len > s.log_len, log_len, s.durable_len),
        compact_floor=applied,
    )
    if _ctrl_mode(kcfg):
        cst.update(ctrl=ctrl, w_src=w_src)
    return st._replace(
        **cst, rafts=rafts, node_src=node_src, snap_src=snap_src,
        applied=applied, node_cfg=node_cfg, phase=phase, key_hash=key_hash,
        key_count=key_count, last_seq=last_seq, snap_cfg=snap_cfg,
        snap_phase=snap_phase, snap_hash=snap_hash, snap_count=snap_count,
        snap_last_seq=snap_last_seq, staged_cfg=staged_cfg,
        staged_hash=staged_hash, staged_count=staged_count,
        staged_last_seq=staged_last_seq, pull_req_t=pull_req_t,
        pull_req_cfg=pull_req_cfg, pull_rsp_t=pull_rsp_t,
        pull_rsp_cfg=pull_rsp_cfg, pull_rsp_hash=pull_rsp_hash,
        pull_rsp_count=pull_rsp_count, pull_rsp_last_seq=pull_rsp_last_seq,
        gcq_req_t=gcq_req_t, gcq_req_cfg=gcq_req_cfg, gcq_rsp_t=gcq_rsp_t,
        gcq_rsp_cfg=gcq_rsp_cfg, clerk_seq=clerk_seq, clerk_out=clerk_out,
        clerk_shard=clerk_shard, clerk_kind=clerk_kind, clerk_cfg=clerk_cfg,
        clerk_wrong=clerk_wrong, clerk_acked=clerk_acked,
        clerk_get_lo=clerk_get_lo, clerk_get_obs=clerk_get_obs,
        gets_done=gets_done, open_arr=open_arr, open_srv=open_srv,
        open_drop=open_drop, open_stamp=open_stamp, clerk_sub=clerk_sub,
        lat_hist=lat_hist, clerk_app=clerk_app, clerk_cmt=clerk_cmt,
        clerk_apl=clerk_apl, clerk_mig=clerk_mig,
        client_retries=client_retries, phase_hist=phase_hist,
        phase_ticks=phase_ticks, lat_ticks=lat_ticks, worst_lat=worst[0],
        worst_phases=worst[1], worst_key=worst[2], worst_client=worst[3],
        worst_sub=worst[4], key_lat_hist=key_lat_hist,
        client_lat_hist=client_lat_hist, w_frontier=w_frontier, w_cfg=w_cfg,
        w_phase=w_phase, w_hash=w_hash, w_count=w_count,
        w_last_seq=w_last_seq, frz_cfg=frz_cfg, frz_hash=frz_hash,
        frz_count=frz_count, frz_last_seq=frz_last_seq,
        truth_count=truth_count, w_clerk_acked=w_clerk_acked,
        installs_done=installs_done, deletes_done=deletes_done,
        max_cfg_lag=max_cfg_lag, violations=violations,
        first_violation_tick=first_violation_tick,
    )


def shardkv_step(cfg: SimConfig, kcfg: ShardKvConfig, st: ShardKvState,
                 keys: torch.Tensor, kn: Knobs, skn: ShardKvKnobs,
                 tick: str = "kernel", gkeys=None, ckeys=None,
                 tables=None) -> ShardKvState:
    """One tick of every deployment: the raft tick of its groups (and, in
    a controller mode, of its controller cluster), then the service tick,
    routed by ``engine.tick_route``: on the card a K6-shardkv launch of one
    tick (``tables``: ``kernels.shardkv.chunk_tables``); on the CPU, or
    with ``tick="eager"``, ``step_cluster`` over the B x G group clusters
    (and the B controller clusters) and the plain service tick.
    ``gkeys`` ([B x G, 2], ``group_keys``) and ``ckeys`` ([B, 2],
    ``ctrl_keys``) are what a caller running many eager ticks builds
    once."""
    from madraft_tpu_torch.tpusim.engine import tick_route

    if tick_route(st.rafts.tick.device, tick) == "kernel":
        return K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, 1, tables)
    b, g = keys.shape[0], kcfg.n_groups
    if gkeys is None:
        gkeys = group_keys(keys, g).reshape(-1, 2)
    pre = st.rafts
    s = step_cluster(cfg, _flat(pre), gkeys, _group_knobs(kn, g))
    ctrl = None
    if _ctrl_mode(kcfg):
        if ckeys is None:
            ckeys = ctrl_keys(keys)
        ctrl = step_cluster(cfg, st.ctrl, ckeys, kn)
    return K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base,
                            _unflat(s, b), keys, kn, skn, plain=True,
                            ctrl=ctrl)


def _advance_shardkv(cfg: SimConfig, kcfg: ShardKvConfig, st: ShardKvState,
                     keys: torch.Tensor, kn: Knobs, skn: ShardKvKnobs,
                     n_ticks: int, tick: str = "kernel") -> ShardKvState:
    """n_ticks deployment ticks, routed as ``shardkv_step`` says: on the
    card K6-shardkv launches of up to ``engine.KERNEL_CHUNK`` ticks (the
    knob tables built once here), else the eager tick once a tick (the
    group and controller keys built once here). Every shardkv run goes
    through this function, so ``functools.partial(_advance_shardkv,
    tick="eager")`` in its place runs a whole program on the eager route
    (the A/B's baseline)."""
    from madraft_tpu_torch.tpusim.engine import KERNEL_CHUNK, tick_route

    b, g = keys.shape[0], kcfg.n_groups
    if tick_route(st.rafts.tick.device, tick) == "kernel":
        tables = K11.chunk_tables(cfg, kcfg, kn, skn, b)
        done = 0
        while done < n_ticks:
            m = min(KERNEL_CHUNK, n_ticks - done)
            st = K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, m, tables)
            done += m
        return st
    gkeys = group_keys(keys, g).reshape(-1, 2)
    ckeys = ctrl_keys(keys)
    for _ in range(n_ticks):
        st = shardkv_step(cfg, kcfg, st, keys, kn, skn, tick, gkeys, ckeys)
    return st


# ------------------------------------------------------------------- drivers
class ShardKvFuzzReport(NamedTuple):
    """Host-side summary of one shardkv fuzz run, the reference's fields
    (``ann_resolved`` the controller's committed frontier and
    ``ctrl_walker_stalled`` its walker's sticky stall in a controller
    mode; 0 and False in schedule mode, as there)."""

    violations: np.ndarray
    raft_violations: np.ndarray
    first_violation_tick: np.ndarray
    acked_ops: np.ndarray
    acked_gets: np.ndarray
    installs: np.ndarray
    deletes: np.ndarray
    final_cfg: np.ndarray
    owned_copies: np.ndarray
    frozen_left: np.ndarray
    max_cfg_lag: np.ndarray
    ann_resolved: np.ndarray
    ctrl_walker_stalled: np.ndarray
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
        return int(((self.violations | self.raft_violations) != 0).sum())

    def violating_clusters(self) -> np.ndarray:
        return np.nonzero((self.violations | self.raft_violations) != 0)[0]


def shardkv_report(final: ShardKvState) -> ShardKvFuzzReport:
    def h(x):
        return x.cpu().numpy()

    w_phase = h(final.w_phase)  # [B, G, NS]
    owned = (w_phase == OWNED).sum(axis=1)
    frozen = (w_phase == FROZEN).sum(axis=1)
    has_metrics = final.lat_hist.numel() > 0
    win = h(final.win_var)
    metric = {}
    if has_metrics:
        metric = dict(
            lat_hist=h(final.lat_hist),
            ev_counts=(h(final.rafts.ev_counts).sum(axis=1)
                       + h(final.ctrl.ev_counts)),
            phase_hist=h(final.phase_hist), phase_ticks=h(final.phase_ticks),
            lat_ticks=h(final.lat_ticks), key_hist=h(final.key_lat_hist),
            client_hist=h(final.client_lat_hist),
            client_retries=h(final.client_retries),
            worst_lat=h(final.worst_lat), worst_phases=h(final.worst_phases),
            worst_key=h(final.worst_key), worst_client=h(final.worst_client),
            worst_sub=h(final.worst_sub))
    return ShardKvFuzzReport(
        violations=h(final.violations),
        raft_violations=np.bitwise_or.reduce(h(final.rafts.violations),
                                             axis=1),
        first_violation_tick=h(final.first_violation_tick),
        acked_ops=h(final.clerk_acked.sum(-1, dtype=I32)),
        acked_gets=h(final.gets_done.sum(-1, dtype=I32)),
        installs=h(final.installs_done), deletes=h(final.deletes_done),
        final_cfg=h(final.w_cfg.amin(-1)),
        owned_copies=owned.max(axis=-1), frozen_left=frozen.sum(axis=-1),
        max_cfg_lag=h(final.max_cfg_lag),
        ann_resolved=np.cumprod(win >= 0, axis=-1).sum(axis=-1) - 1,
        ctrl_walker_stalled=h(final.ctrl_w_stalled),
        **metric,
    )


class ShardKvFuzzProgram:
    """``fn(seed) -> final batched ShardKvState`` for one config and
    shape, the ``engine.FuzzProgram`` interface (``compile_timed`` builds
    the kernels, K6-shardkv's build for the run among them, before the
    first tick). ``kn`` / ``skn`` override the configs' knobs (the
    sweep's [B] rows)."""

    def __init__(self, cfg: SimConfig, kcfg: ShardKvConfig, n_clusters: int,
                 n_ticks: int, device, kn: Optional[Knobs] = None,
                 skn: Optional[ShardKvKnobs] = None):
        from madraft_tpu_torch.tpusim.engine import (
            _validate_knobs,
            check_card_shape,
            resolve_device,
        )

        check_service_cfg(cfg, "shardkv")
        self.cfg, self.kcfg = cfg, kcfg
        self.n_clusters, self.n_ticks = n_clusters, n_ticks
        self.device = resolve_device(device)
        check_card_shape(self.device, cfg, K11, kcfg)
        self.kn = cfg.knobs(self.device) if kn is None else kn.to(self.device)
        self.skn = (kcfg.knobs(self.device) if skn is None
                    else skn.to(self.device))
        _validate_knobs(self.kn)
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        from madraft_tpu_torch.tpusim.engine import _build_kernels

        if self.compile_s is None:
            self.compile_s = _build_kernels(
                self.device, self.cfg.metrics,
                extra=(K11.chunk_variant(self.cfg.metrics),))
        return self.compile_s

    def __call__(self, seed) -> ShardKvState:
        from madraft_tpu_torch.tpusim.engine import cluster_keys

        keys = cluster_keys(seed, self.n_clusters, self.device)
        st = init_shardkv_cluster(self.cfg, self.kcfg, keys, self.kn,
                                  self.skn)
        return _advance_shardkv(self.cfg, self.kcfg, st, keys, self.kn,
                                self.skn, self.n_ticks)


def make_shardkv_fuzz_fn(cfg: SimConfig, kcfg: ShardKvConfig,
                         n_clusters: int, n_ticks: int,
                         device=None) -> ShardKvFuzzProgram:
    """Build fn(seed) -> final batched ShardKvState (uniform knobs)."""
    return ShardKvFuzzProgram(cfg, kcfg, n_clusters, n_ticks, device)


def shardkv_fuzz(cfg: SimConfig, kcfg: ShardKvConfig, seed: int,
                 n_clusters: int, n_ticks: int,
                 device=None) -> ShardKvFuzzReport:
    """Fuzz n_clusters independent deployments; deployment c draws from
    fold_in(PRNGKey(seed), c)."""
    return shardkv_report(make_shardkv_fuzz_fn(cfg, kcfg, n_clusters,
                                               n_ticks, device)(seed))


def _validate_shardkv_knobs(skn: ShardKvKnobs) -> None:
    """Eager rejection of service-knob values that would silently
    misbehave in the tick, in the reference's words."""
    from madraft_tpu_torch.tpusim.engine import (
        validate_bool_bugs,
        validate_probs,
    )

    k = ShardKvKnobs(*(x.cpu().numpy() for x in skn))
    validate_probs(
        k, ("p_op", "p_get", "p_put", "p_retry", "p_cfg_learn", "p_pull",
            "p_ack", "pull_loss", "p_announce", "p_phantom", "open_rate"),
        "shardkv")
    if (k.p_get + k.p_put > 1.0).any():
        raise ValueError("p_get + p_put must stay <= 1 per deployment")
    if ((k.open_queue_cap < 0) | (k.open_queue_cap > OPEN_QUEUE_SLOTS)).any():
        raise ValueError(
            f"open_queue_cap must stay in [0, {OPEN_QUEUE_SLOTS}] (the "
            "arrival-stamp ring size; 0 = closed loop)"
        )
    if (k.zipf_a < 1.0).any():
        raise ValueError("zipf_a must be >= 1.0 (1.0 = the uniform draw)")
    if (k.pull_delay_max < k.pull_delay_min).any() or (
            k.pull_delay_min < 1).any():
        raise ValueError(
            f"pull delay span empty: [{k.pull_delay_min}, {k.pull_delay_max}]"
        )
    if (k.cfg_interval < 2).any():
        raise ValueError(f"cfg_interval must be >= 2: {k.cfg_interval}")
    validate_bool_bugs(
        k, ("bug_skip_freeze", "bug_drop_dup_table", "bug_serve_frozen",
            "bug_stale_ctrler_read", "bug_rotate_tiebreak",
            "requery_wrong_group"), "shardkv")


def make_shardkv_sweep_fn(cfg: SimConfig, knobs: Knobs,
                          sknobs: ShardKvKnobs, kcfg: ShardKvConfig,
                          n_clusters: int, n_ticks: int,
                          device=None) -> ShardKvFuzzProgram:
    """Like make_shardkv_fuzz_fn, but every deployment runs its own raft
    AND service knob row (fields 0-d or [n_clusters]): reconfiguration
    cadence, workload mix, inter-group network and the planted migration
    bugs become per-deployment data in one run."""
    from madraft_tpu_torch.tpusim.engine import (
        _validate_knobs,
        resolve_device,
        validate_service_raft_knobs,
    )

    check_service_cfg(cfg, "shardkv")
    dev = resolve_device(device)
    knobs, sknobs = knobs.to(dev), sknobs.to(dev)
    _validate_knobs(knobs)
    validate_service_raft_knobs(knobs)
    _validate_shardkv_knobs(sknobs)
    if not kcfg.computed_ctrler and bool(sknobs.bug_rotate_tiebreak.any()):
        raise ValueError(
            "bug_rotate_tiebreak (sweep knob) needs kcfg.computed_ctrler "
            "— without the computed controller it would silently do nothing"
        )
    return ShardKvFuzzProgram(cfg, kcfg, n_clusters, n_ticks, dev,
                              kn=knobs.broadcast(n_clusters),
                              skn=sknobs.broadcast(n_clusters))


# ---------------------------------------------------------- carry-across
_CLUSTERS = ("rafts", "ctrl")


def shardkv_state_to_numpy(st: ShardKvState) -> dict:
    """A shardkv state as one flat mapping of field -> host numpy array
    (``SHARDKV_FIELDS``: ``rafts.<f>``, ``ctrl.<f>``, then the service
    leaves; ``state.nested_state_to_numpy``)."""
    return nested_state_to_numpy(st, _CLUSTERS)


def shardkv_state_from_numpy(arrays: dict, device=None) -> ShardKvState:
    """The inverse of ``shardkv_state_to_numpy``
    (``state.nested_state_from_numpy``)."""
    return nested_state_from_numpy(ShardKvState, arrays, _CLUSTERS, device)


def first_divergence(tick: int, want: dict, got: dict):
    """``state.first_divergence`` over every shardkv leaf
    (``SHARDKV_FIELDS``)."""
    from madraft_tpu_torch.tpusim.state import first_divergence as _first

    return _first(tick, want, got, SHARDKV_FIELDS)
