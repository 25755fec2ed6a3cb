"""Simulation configuration for the PyTorch port: static shape knobs plus the
dynamic runtime knobs, as a JAX-free twin of ``madraft_tpu/tpusim/config.py``.

Only what the raw-raft ``fuzz``/``replay``/``pool`` paths read is here. Field names,
defaults, validation and the scenario registry are copied verbatim, so a
config built for one package means the same run in the other
(``tests/test_torch_config.py`` checks every field and default).

``Knobs`` carries the dynamic knobs as 0-d tensors of the reference's dtypes:
float32 probabilities, int32 counts and a bool, or as ``[B]`` rows of those
dtypes, one value a cluster (``Knobs.broadcast``; the coverage pool and the
sweep's per-cluster layout). The dtypes matter: the tick compares float32
uniforms against float32 sums of these probabilities, and a float64
anywhere would move a comparison.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# The raft-layer planted-bug library (see SimConfig.bug).
RAFT_BUGS = (
    "", "commit_any_term", "grant_any_vote", "forget_voted_for", "no_truncate",
    "ack_before_fsync",
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of one batched simulation. All times are in ticks.

    Field for field the reference's ``SimConfig``; see its comments for what
    each knob models."""

    n_nodes: int = 5
    log_cap: int = 64        # ring capacity (power of two)
    ae_max: int = 4          # max entries carried per AppendEntries message
    metrics: bool = False    # on-device metrics plane (tpusim/metrics.py)
    fuse_packed_step: bool = False  # packed-carry layout knob (not ported yet)
    max_lane_ticks: int = 4096      # packed-state tick ceiling

    def __post_init__(self):
        if self.log_cap <= 0 or self.log_cap & (self.log_cap - 1):
            raise ValueError(f"log_cap must be a power of two, got {self.log_cap}")
        if self.compact_every < 1:
            raise ValueError(f"compact_every must be >= 1, got {self.compact_every}")
        if self.flow_cap < 1:
            raise ValueError(f"flow_cap must be >= 1, got {self.flow_cap}")
        if self.flow_cap + self.compact_every >= self.log_cap:
            raise ValueError(
                f"flow_cap ({self.flow_cap}) + compact_every "
                f"({self.compact_every}) must stay below log_cap "
                f"({self.log_cap}) or a full ring can deadlock commit"
            )
        if self.bug not in RAFT_BUGS:
            raise ValueError(f"unknown bug {self.bug!r}; known: {RAFT_BUGS}")
        if self.fsync_every < 1:
            raise ValueError(
                f"fsync_every must be >= 1 (ticks), got {self.fsync_every}"
            )
        if not 0.0 <= self.p_lose_unsynced <= 1.0:
            raise ValueError(
                f"p_lose_unsynced outside [0, 1]: {self.p_lose_unsynced}"
            )
        if not 1 <= self.max_lane_ticks <= (1 << 24):
            raise ValueError(
                f"max_lane_ticks outside [1, 2^24]: {self.max_lane_ticks}"
            )
        for name in ("p_limp", "p_limp_heal", "p_fsync_stall"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} outside [0, 1]: {v}")
        if self.limp_mult_max < 1:
            raise ValueError(
                f"limp_mult_max must be >= 1 (1 = off), got {self.limp_mult_max}"
            )
        if self.eto_skew < 0:
            raise ValueError(f"eto_skew must be >= 0, got {self.eto_skew}")
        if self.fsync_stall_ticks < 0:
            raise ValueError(
                f"fsync_stall_ticks must be >= 0, got {self.fsync_stall_ticks}"
            )
        if self.rolling_period < 0 or self.rolling_down < 0:
            raise ValueError(
                f"rolling_period/rolling_down must be >= 0, got "
                f"{self.rolling_period}/{self.rolling_down}"
            )
        if self.rolling_period > 0 and self.rolling_down >= self.rolling_period:
            raise ValueError(
                f"rolling_down ({self.rolling_down}) must stay below "
                f"rolling_period ({self.rolling_period}) or a scheduled node "
                "never comes back up"
            )

    # log compaction (the snapshot path)
    compact_every: int = 16
    compact_at_commit: bool = True
    # flow control: uncommitted backlog cap (0 = log_cap // 2)
    uncommitted_cap: int = 0

    @property
    def flow_cap(self) -> int:
        return self.uncommitted_cap or self.log_cap // 2

    # virtual time: 1 tick ~ 10 simulated ms
    ms_per_tick: int = 10
    election_timeout_min: int = 15
    election_timeout_max: int = 30
    heartbeat_ticks: int = 5

    # network model
    delay_min: int = 1
    delay_max: int = 3
    loss_prob: float = 0.0

    # fault schedule (per-tick Bernoulli draws from the per-cluster PRNG)
    p_crash: float = 0.0
    p_restart: float = 0.2
    p_repartition: float = 0.0
    p_heal: float = 0.0
    p_leader_part: float = 0.0
    p_asym_cut: float = 0.0
    max_dead: int = 0

    # client workload
    p_client_cmd: float = 0.2

    # storage durability model
    fsync_every: int = 1
    p_lose_unsynced: float = 0.0

    # gray-failure axes (all neutral by default)
    p_limp: float = 0.0
    limp_mult_max: int = 1
    p_limp_heal: float = 0.0
    eto_skew: int = 0
    p_fsync_stall: float = 0.0
    fsync_stall_ticks: int = 0
    rolling_period: int = 0
    rolling_down: int = 0

    # deliberate-bug injection for oracle validation
    majority_override: int | None = None
    bug: str = ""

    @property
    def majority(self) -> int:
        if self.majority_override is not None:
            return self.majority_override
        return self.n_nodes // 2 + 1

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def knobs(self, device=None) -> "Knobs":
        """The dynamic knobs as 0-d tensors on ``device`` (CPU if None)."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
        return Knobs(
            loss_prob=f32(self.loss_prob),
            p_crash=f32(self.p_crash),
            p_restart=f32(self.p_restart),
            p_repartition=f32(self.p_repartition),
            p_heal=f32(self.p_heal),
            p_leader_part=f32(self.p_leader_part),
            p_asym_cut=f32(self.p_asym_cut),
            p_client_cmd=f32(self.p_client_cmd),
            fsync_every=i32(self.fsync_every),
            p_lose_unsynced=f32(self.p_lose_unsynced),
            eto_min=i32(self.election_timeout_min),
            eto_max=i32(self.election_timeout_max),
            delay_min=i32(self.delay_min),
            delay_max=i32(self.delay_max),
            heartbeat_ticks=i32(self.heartbeat_ticks),
            compact_every=i32(self.compact_every),
            flow_cap=i32(self.flow_cap),
            max_dead=i32(self.max_dead),
            majority=i32(self.majority),
            compact_at_commit=torch.tensor(
                self.compact_at_commit, dtype=torch.bool, device=device),
            p_limp=f32(self.p_limp),
            limp_mult_max=i32(self.limp_mult_max),
            p_limp_heal=f32(self.p_limp_heal),
            eto_skew=i32(self.eto_skew),
            p_fsync_stall=f32(self.p_fsync_stall),
            fsync_stall_ticks=i32(self.fsync_stall_ticks),
            rolling_period=i32(self.rolling_period),
            rolling_down=i32(self.rolling_down),
        )

    def static_key(self) -> "SimConfig":
        """Canonical config carrying only the fields that shape the tick
        (everything else rides in ``Knobs``)."""
        return SimConfig(
            n_nodes=self.n_nodes, log_cap=self.log_cap, ae_max=self.ae_max,
            max_lane_ticks=self.max_lane_ticks, compact_every=1, bug=self.bug,
            metrics=self.metrics, fuse_packed_step=self.fuse_packed_step,
        )


def check_service_cfg(cfg: "SimConfig", layer: str) -> None:
    """A service layer (kv, ctrler) owns command injection and moves the
    compaction boundary with its apply cursor: refuse a raft config that
    injects commands or compacts at the commit index."""
    if cfg.p_client_cmd != 0.0:
        raise ValueError(f"{layer} layer owns command injection: the raft "
                         "config needs p_client_cmd=0.0")
    if cfg.compact_at_commit:
        raise ValueError(
            f"{layer} fuzzing needs cfg.compact_at_commit=False: the "
            "compaction boundary must follow the apply cursor, not the "
            "commit index")


def lane_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A knob against a [B, ...] operand of ``ndim`` dims: a 0-d (uniform)
    knob untouched, so the uniform tick adds no operation, a [B]
    row (one value a cluster) as a [B, 1, ...] view."""
    return x if x.dim() == 0 else x.view(-1, *(1,) * (ndim - 1))


class Knobs(NamedTuple):
    """Dynamic simulation knobs, one 0-d tensor (uniform) or [B] row (one
    value a cluster) per field."""

    loss_prob: torch.Tensor
    p_crash: torch.Tensor
    p_restart: torch.Tensor
    p_repartition: torch.Tensor
    p_heal: torch.Tensor
    p_leader_part: torch.Tensor
    p_asym_cut: torch.Tensor
    p_client_cmd: torch.Tensor
    fsync_every: torch.Tensor
    p_lose_unsynced: torch.Tensor
    eto_min: torch.Tensor
    eto_max: torch.Tensor
    delay_min: torch.Tensor
    delay_max: torch.Tensor
    heartbeat_ticks: torch.Tensor
    compact_every: torch.Tensor
    flow_cap: torch.Tensor
    max_dead: torch.Tensor
    majority: torch.Tensor
    compact_at_commit: torch.Tensor
    p_limp: torch.Tensor
    limp_mult_max: torch.Tensor
    p_limp_heal: torch.Tensor
    eto_skew: torch.Tensor
    p_fsync_stall: torch.Tensor
    fsync_stall_ticks: torch.Tensor
    rolling_period: torch.Tensor
    rolling_down: torch.Tensor

    def to(self, device) -> "Knobs":
        return Knobs(*(x.to(device) for x in self))

    def lanes(self, ndim: int) -> "Knobs":
        """Each field viewed against a [B, ...] operand of ``ndim`` dims
        (``lane_view``): a 0-d field as it is, a [B] row as [B, 1, ...]."""
        return Knobs(*(lane_view(x, ndim) for x in self))

    def broadcast(self, n_clusters: int) -> "Knobs":
        """Per-cluster rows: every field ``[n_clusters]``, one value a lane
        (the tick takes a field either 0-d or as such a row)."""
        return Knobs(*(x.expand(n_clusters).clone() for x in self))


class PackedBounds(NamedTuple):
    """Largest value each packed field class must represent (inclusive),
    as in the reference's ``config.packed_bounds`` (its comment derives
    each bound from ``max_lane_ticks``)."""

    tick: int       # tick, next_cmd
    term: int       # every term-valued field
    index: int      # every absolute log-index field
    cmd: int        # log_val/shadow_val payloads (NOOP excluded)
    rel_stamp: int  # mailbox stamp minus cluster tick (0 = empty slot)
    event: int      # any ev_counts counter


def packed_bounds(cfg: SimConfig) -> PackedBounds:
    t = cfg.max_lane_ticks
    return PackedBounds(
        tick=t,
        term=t,
        index=2 * t + 1,
        cmd=cfg.n_nodes * (t + 1),
        rel_stamp=254,  # u8 with 0 reserved for "empty" => delay_max <= 253
        event=cfg.n_nodes * t,
    )


# Pool id rules under the lane-partitioned scheme (the reference's
# config.pool_*): lane l's generation-g cluster owns global id g * lanes + l,
# and shard s of an n-shard pool owns the contiguous lanes
# [s * lanes/n, (s+1) * lanes/n).
def pool_lane(cluster_id: int, n_lanes: int) -> int:
    """Lane slot that ran ``cluster_id`` under the lane-partitioned scheme."""
    return int(cluster_id) % n_lanes


def pool_generation(cluster_id: int, n_lanes: int) -> int:
    """Refill generation of ``cluster_id`` (0 = initial batch) under the
    lane-partitioned scheme."""
    return int(cluster_id) // n_lanes


def pool_lanes_per_shard(n_lanes: int, n_shards: int) -> int:
    """Lanes per shard; the lanes must divide evenly over the shards."""
    if n_lanes % n_shards:
        raise ValueError(
            f"lanes ({n_lanes}) must divide evenly over shards ({n_shards})"
        )
    return n_lanes // n_shards


def pool_shard(cluster_id: int, n_lanes: int, n_shards: int) -> int:
    """Shard that ran ``cluster_id`` in an ``n_shards``-shard pool."""
    return pool_lane(cluster_id, n_lanes) // pool_lanes_per_shard(
        n_lanes, n_shards
    )


# The metrics plane's layout: fixed log-spaced latency buckets
# (tpusim/metrics.py), the phases every submit->ack latency splits into
# (the raft layer folds its whole commit latency into "replicate"; shardkv
# adds "migration"), and the per-lane event counters in ev_counts order.
HIST_BUCKETS = 16
LATENCY_PHASES = ("leader_wait", "replicate", "apply", "ack")
SHARDKV_PHASES = LATENCY_PHASES + ("migration",)


def phase_names(n_phases: int) -> tuple:
    """Phase names for a phase axis of this length (the decoders see only
    the array; the two taxonomies differ in length)."""
    if n_phases == len(SHARDKV_PHASES):
        return SHARDKV_PHASES
    return LATENCY_PHASES[:n_phases]


METRIC_EVENTS = (
    "elections_won", "term_bumps", "crashes", "restarts",
    "rv_req_delivered", "rv_rsp_delivered", "ae_req_delivered",
    "ae_rsp_delivered", "snap_delivered", "commit_advances",
)


def metrics_dims(cfg: SimConfig) -> tuple:
    """(hist_buckets, n_events, stamp_cap, n_phases, reg): the metric
    leaves' shapes, all zero with metrics off, so a metrics-off state
    carries zero-size metric leaves and no extra bytes."""
    if not cfg.metrics:
        return 0, 0, 0, 0, 0
    return HIST_BUCKETS, len(METRIC_EVENTS), cfg.log_cap, \
        len(LATENCY_PHASES), 1


# Violation bitmask values (raft-layer oracle reductions in step.py).
VIOLATION_DUAL_LEADER = 1
VIOLATION_LOG_MATCHING = 2
VIOLATION_COMMIT_SHADOW = 4
VIOLATION_PREFIX_DIVERGE = 512

# The one name table for every oracle bit across all layers, as in the
# reference (service-layer bits included so a decoded report never
# under-reads a mask).
VIOLATION_NAMES = {
    1: "DUAL_LEADER",
    2: "LOG_MATCHING",
    4: "COMMIT_SHADOW",
    8: "EXACTLY_ONCE",
    16: "KV_DIVERGE",
    32: "STALE_READ",
    64: "SHARD_DIVERGE",
    128: "SHARD_OWNERSHIP",
    256: "SHARD_STORAGE",
    512: "PREFIX_DIVERGE",
    1024: "SHARD_STALE_READ",
    2048: "CTRL_DIVERGE",
    4096: "CTRL_BALANCE",
    8192: "CTRL_MINIMAL",
    16384: "CTRL_QUERY",
    32768: "SHARD_CTRL_STALE",
}


def violation_names(mask: int) -> list:
    """Decode a violation bitmask into oracle names, lowest bit first;
    unknown set bits decode as ``BIT<k>``."""
    mask = int(mask)
    names = [name for bit, name in sorted(VIOLATION_NAMES.items())
             if mask & bit]
    known = 0
    for bit in VIOLATION_NAMES:
        known |= bit
    rest = mask & ~known
    k = 0
    while rest:
        if rest & 1:
            names.append(f"BIT{k}")
        rest >>= 1
        k += 1
    return names


# Role encoding.
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# Log value of the no-op entry a freshly elected leader appends.
NOOP_CMD = 1 << 30


def storm_profiles() -> dict:
    """The registry of named simulation scenarios, identical to the
    reference's: name -> (SimConfig, n_clusters, n_ticks, bugs_demonstrated).
    The reference's docstring explains each profile."""
    storm = SimConfig(
        n_nodes=5, p_client_cmd=0.3, p_crash=0.05, p_restart=0.3,
        max_dead=2, p_repartition=0.03, p_heal=0.05, loss_prob=0.1,
    )
    fig8 = storm.replace(
        ae_max=1, delay_max=5, p_repartition=0.03, loss_prob=0.1,
        p_client_cmd=0.4,
    )
    revote = storm.replace(
        n_nodes=7, max_dead=3, p_crash=0.15, p_restart=0.6, delay_max=6,
        election_timeout_min=10, election_timeout_max=20, p_client_cmd=0.1,
    )
    durability = storm.replace(
        p_crash=0.1, p_restart=0.4, max_dead=2,
        fsync_every=8, p_lose_unsynced=1.0,
    )
    limp = storm.replace(
        p_crash=0.02, p_limp=0.05, limp_mult_max=8, p_limp_heal=0.05,
    )
    skew_storm = storm.replace(
        election_timeout_min=10, election_timeout_max=16, eto_skew=4,
        p_crash=0.08, p_restart=0.4, loss_prob=0.15,
    )
    fsync_stall = durability.replace(
        p_fsync_stall=0.05, fsync_stall_ticks=24,
    )
    rolling_wave = storm.replace(
        p_crash=0.0, max_dead=0, p_repartition=0.0, p_heal=0.0,
        loss_prob=0.02, rolling_period=48, rolling_down=12,
    )
    hot_key_openloop = storm.replace(
        p_crash=0.02, max_dead=1, p_repartition=0.01, loss_prob=0.05,
    )
    gray_storm = storm.replace(
        p_crash=0.08, p_restart=0.4, fsync_every=8, p_lose_unsynced=1.0,
        p_limp=0.03, limp_mult_max=6, p_limp_heal=0.05, eto_skew=2,
        p_fsync_stall=0.03, fsync_stall_ticks=16,
    )
    return {
        "storm": (storm, 256, 600, ("grant_any_vote", "no_truncate")),
        "fig8": (fig8, 1024, 1000, ("commit_any_term",)),
        "revote": (revote, 2048, 1000, ("forget_voted_for",)),
        "durability": (durability, 256, 600, ("ack_before_fsync",)),
        "limp": (limp, 256, 600, ()),
        "skew_storm": (skew_storm, 256, 600, ()),
        "fsync_stall": (fsync_stall, 256, 600, ("ack_before_fsync",)),
        "rolling_wave": (rolling_wave, 256, 600, ()),
        "hot_key_openloop": (hot_key_openloop, 256, 600, ()),
        "gray_storm": (gray_storm, 256, 600, ("ack_before_fsync",)),
    }


def profile_gates() -> dict:
    """Per-profile game-day gate table, identical to the reference's:
    name -> {"liveness_floor", "p99_ceiling", "bench_scale", "workload",
    "bridge"}."""
    def gate(floor, ceil, scale=(64, 300), workload=None, bridge="mirrored"):
        return {
            "liveness_floor": floor, "p99_ceiling": ceil,
            "bench_scale": scale, "workload": workload or {},
            "bridge": bridge,
        }

    return {
        "storm": gate(9.0, 511),
        "fig8": gate(0.9, 1023),
        "revote": gate(0.05, 511),
        "durability": gate(2.5, 511),
        "limp": gate(6.0, 511, bridge="unsupported"),
        "skew_storm": gate(4.0, 511, bridge="unsupported"),
        "fsync_stall": gate(2.5, 511, bridge="unsupported"),
        "rolling_wave": gate(32.0, 127, bridge="unsupported"),
        "hot_key_openloop": gate(
            16.0, 1023,
            workload={"open_rate": 0.25, "zipf_a": 3.0, "open_queue_cap": 8},
            bridge="unsupported",
        ),
        "gray_storm": gate(2.0, 511, bridge="unsupported"),
    }


# Static capacity of the open-loop pending-arrival stamp ring of the kv
# clerks (the reference's config.OPEN_QUEUE_SLOTS): the knob
# open_queue_cap is validated against it.
OPEN_QUEUE_SLOTS = 8


def zipf_map(draw: torch.Tensor, n_vals: int, a) -> torch.Tensor:
    """The reference's ``zipf_map``: a uniform int32 draw in [0, n_vals)
    onto a Zipf-like hot-key id, ``floor(n_vals * u ** a)`` in float32 with
    ``u = (draw + 0.5) / n_vals``, clipped to [0, n_vals). ``a`` is a
    float32 tensor (0-d, or broadcasting against ``draw``); a == 1.0 is
    the identity, taken explicitly as the reference takes it."""
    f32 = torch.float32
    u = (draw.to(f32) + 0.5) / torch.tensor(n_vals, dtype=f32,
                                            device=draw.device)
    skewed = torch.clamp(
        torch.floor(n_vals * torch.pow(u, a)).to(torch.int32), 0, n_vals - 1)
    return torch.where(a == 1.0, draw, skewed)


# ---------------------------------------------------------------------------
# Coverage-guided schedule search (the reference's CoverageConfig; the
# subsystem lives in coverage.py, the corpus scheduler in engine.run_pool).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoverageConfig:
    """Static knobs of the coverage subsystem (coverage.py), identical to
    the reference's: the seen-set size, the quantization of the per-node
    abstract state, and the shape of the biased refill (the reference's
    docstring explains each field)."""

    bitmap_bits: int = 1 << 16
    term_rank_levels: int = 3
    commit_delta_levels: int = 3
    guided: bool = True
    mut_span: float = 2.0
    fresh_lo: float = 0.25
    fresh_hi: float = 2.5

    def __post_init__(self):
        if self.bitmap_bits <= 0 or self.bitmap_bits & (self.bitmap_bits - 1):
            raise ValueError(
                f"bitmap_bits must be a power of two, got {self.bitmap_bits}"
            )
        if self.term_rank_levels < 2 or self.commit_delta_levels < 2:
            raise ValueError(
                "term_rank_levels and commit_delta_levels must be >= 2 "
                f"(got {self.term_rank_levels}, {self.commit_delta_levels})"
            )
        if self.mut_span <= 1.0:
            raise ValueError(f"mut_span must be > 1, got {self.mut_span}")
        if not 0.0 <= self.fresh_lo <= self.fresh_hi:
            raise ValueError(
                f"fresh span empty: [{self.fresh_lo}, {self.fresh_hi}]"
            )

    def replace(self, **kw) -> "CoverageConfig":
        return dataclasses.replace(self, **kw)

    def fingerprint_key(self) -> "CoverageConfig":
        """The config with only the fields the fingerprint reads (bitmap
        size and quantization levels)."""
        return CoverageConfig(
            bitmap_bits=self.bitmap_bits,
            term_rank_levels=self.term_rank_levels,
            commit_delta_levels=self.commit_delta_levels,
        )


def coverage_ground_truth() -> tuple:
    """The reference's 3-node validation config, whose abstract-state space
    ``coverage.enumerate_abstract_codes`` enumerates and whose seen-set maps
    each code to its own bit: (SimConfig, CoverageConfig, horizon_ticks)."""
    cfg = SimConfig(
        n_nodes=3, log_cap=16, ae_max=2, compact_every=4,
        p_client_cmd=0.2, loss_prob=0.02, p_crash=0.01, p_restart=0.3,
        max_dead=1, p_repartition=0.01, p_heal=0.05,
    )
    # per-node alphabet 3*2*2*2 = 24; 24^3 = 13824 codes <= 2^14 bits
    ccfg = CoverageConfig(
        bitmap_bits=1 << 14, term_rank_levels=2, commit_delta_levels=2,
        fresh_lo=0.0, fresh_hi=8.0,
    )
    return cfg, ccfg, 64
