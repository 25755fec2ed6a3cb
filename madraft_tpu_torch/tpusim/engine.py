"""Batch drivers for the PyTorch port: keys, init, the tick loop, reports,
and the continuous fuzzing pool.

The twin of the raw-raft part of ``madraft_tpu/tpusim/engine.py``. Every
entry point takes a ``device``: None means the CUDA card, and a missing
card raises instead of falling back to the CPU; ``device="cpu"`` runs the
kernels' plain versions. The (seed, cluster_id) replay contract is the
reference's: cluster ``c`` of seed ``s`` draws from
``fold_in(PRNGKey(s), c)``, so a fuzz or pool hit replays alone, bit for
bit.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import coverage as K5
from madraft_tpu_torch.kernels import harvest as K7
from madraft_tpu_torch.kernels import pack as K3
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.tpusim import coverage as _cov
from madraft_tpu_torch.tpusim import metrics as _metrics
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    CoverageConfig,
    Knobs,
    SimConfig,
    phase_names,
    pool_lanes_per_shard,
    violation_names,
)
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    PackedClusterState,
    init_cluster,
    packed_layout_reason,
    tree_bytes,
)
from madraft_tpu_torch.tpusim.step import _block_total, step_cluster

# Ticks whose draw words one tick_blocks launch makes ahead on the eager
# route (tick_route); K6 draws its own
DRAW_CHUNK = 32
# Ticks one K6 launch runs at most (its launches stay a few ms long)
KERNEL_CHUNK = 256


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--platform cpu) to run on the CPU")
    return dev


class FuzzReport(NamedTuple):
    """Host-side summary of one fuzz run (per-cluster arrays)."""

    violations: np.ndarray            # i32 bitmask per cluster (0 = clean)
    first_violation_tick: np.ndarray  # -1 = none
    first_leader_tick: np.ndarray     # -1 = never elected
    committed: np.ndarray             # entries ever committed (shadow length)
    msg_count: np.ndarray             # delivered messages
    snap_installs: np.ndarray         # install-snapshot deliveries
    # metrics plane: None with cfg.metrics off, else per-cluster rows
    # ([B, HB], [B, len(METRIC_EVENTS)], [B, P, HB], [B, P], [B, 1] ...)
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


def cluster_keys(seed, n_clusters: int, device, id0: int = 0) -> torch.Tensor:
    """Per-cluster PRNG keys [n, 2]: fold_in(PRNGKey(seed), id0 + i)."""
    ids = torch.arange(id0, id0 + n_clusters, dtype=torch.int64, device=device)
    return prng.fold_in(prng.PRNGKey(seed, device), ids)


def report(final: ClusterState) -> FuzzReport:
    has_metrics = final.lat_hist.numel() > 0

    def h(x):
        return x.cpu().numpy()

    def m(x):
        return h(x) if has_metrics else None

    return FuzzReport(
        violations=h(final.violations),
        first_violation_tick=h(final.first_violation_tick),
        first_leader_tick=h(final.first_leader_tick),
        committed=h(final.shadow_len),
        msg_count=h(final.msg_count),
        snap_installs=h(final.snap_install_count),
        lat_hist=m(final.lat_hist),
        ev_counts=m(final.ev_counts),
        phase_hist=m(final.phase_hist),
        phase_ticks=m(final.phase_ticks),
        lat_ticks=m(final.lat_ticks),
        worst_lat=m(final.worst_lat),
        worst_phases=m(final.worst_phases),
        worst_key=m(final.worst_key),
        worst_client=m(final.worst_client),
        worst_sub=m(final.worst_sub),
    )


def tick_route(device: torch.device, tick: str = "kernel") -> str:
    """How ``_advance`` runs a chunk: ``"kernel"``, K6 launches (the
    variant for the metrics plane and the coverage fingerprint), on a CUDA
    device, whatever the config; else ``"eager"``, ``step_cluster`` once a
    tick: on the CPU, or where the caller asks for it with ``tick="eager"``
    (the A/B's baseline)."""
    if tick not in ("kernel", "eager"):
        raise ValueError(f"tick must be 'kernel' or 'eager', got {tick!r}")
    if tick == "kernel" and device.type == "cuda":
        return "kernel"
    return "eager"


def check_card_shape(device: torch.device, cfg: SimConfig, service=None,
                     kcfg=None) -> None:
    """Refuse on a CUDA device, before anything is allocated there, a
    shape the card's kernels do not take: K6's limits
    (``K6.check_shape``) and, given a service's kernel module and its
    config, that kernel's (``service.check_shape(cfg, kcfg)``). The card
    runs no plain version in a kernel's place; the CPU runs any shape."""
    if device.type != "cuda":
        return
    try:
        K6.check_shape(cfg)
        if service is not None:
            service.check_shape(cfg, kcfg)
    except ValueError as e:
        raise ValueError(
            f"{e}; the card runs this shape on no kernel, so run it on the "
            "CPU (device='cpu', CLI: --platform cpu)") from None


def _advance(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
             kn: Knobs, n_ticks: int, cov: Optional[K6.Seen] = None,
             tick: str = "kernel") -> ClusterState:
    """n_ticks ticks of a wide batch, each cluster from its own tick on,
    run as ``tick_route`` says: K6 launches of up to KERNEL_CHUNK ticks
    (the kernel draws each tick's words; the knob table is built once
    here), or the eager tick once a tick on draw words made a chunk of
    DRAW_CHUNK ticks at a time. ``cov``, the coverage pool's seen-set from
    run-wide tick ``cov.t`` on, takes every tick's fingerprints: inside
    K6's coverage variant, or K5 once a tick on the eager route."""
    if tick_route(state.tick.device, tick) == "kernel":
        table = K6.knob_table(kn.to(state.tick.device), state.tick.shape[0])
        for done in range(0, n_ticks, KERNEL_CHUNK):
            state = K6.tick_chunk(
                cfg, state, keys, kn, min(KERNEL_CHUNK, n_ticks - done),
                table, None if cov is None else cov._replace(t=cov.t + done))
        return state
    total = _block_total(cfg.n_nodes)
    for done in range(0, n_ticks, DRAW_CHUNK):
        m = min(DRAW_CHUNK, n_ticks - done)
        words = threefry.tick_blocks(keys, state.tick + 1, m, total,
                                     prng.partitionable())
        for i in range(m):
            state = step_cluster(cfg, state, keys, kn, words=words[i])
            if cov is not None:
                K5.seen_update(cov.fp, state.role, state.alive, state.term,
                               state.commit, state.violations, cov.rows,
                               cov.seen, cov.new_fps, cov.t + done + i)
    return state


def _run(cfg: SimConfig, keys: torch.Tensor, kn: Knobs, n_ticks: int):
    """init, then n_ticks ticks."""
    return _advance(cfg, init_cluster(cfg, keys, kn), keys, kn, n_ticks)


def _build_kernels(device: torch.device, metrics: bool = False,
                   cov: bool = False, extra: tuple = ()) -> float:
    """Build the CUDA kernels when they are not built yet, K6's variant for
    the metrics plane and the coverage fingerprint among them, and the
    builds named in ``extra`` (the port's set-up before a first tick);
    returns the wall seconds it took."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        from madraft_tpu_torch import _build

        names = tuple(dict.fromkeys(
            (*_build.SOURCES, K6.variant(metrics, cov), *extra)))
        _build.build_all(names)
        for name in names:
            _build.library(name)
    return time.perf_counter() - t0


class FuzzProgram:
    """``fn(seed) -> final batched ClusterState`` for one config and shape.

    ``compile_timed(seed)`` does the set-up a run needs before its first
    tick — building the CUDA kernels when they are not built yet — and
    returns the wall seconds it took, so a later call times the run alone.
    ``kn`` overrides the config's knobs (the sweep's [B] knob rows).
    """

    def __init__(self, cfg: SimConfig, n_clusters: int, n_ticks: int, device,
                 kn: Optional[Knobs] = None):
        self.cfg = cfg
        self.n_clusters = n_clusters
        self.n_ticks = n_ticks
        self.device = resolve_device(device)
        check_card_shape(self.device, cfg)
        self.kn = cfg.knobs(self.device) if kn is None else kn.to(self.device)
        _validate_knobs(self.kn)
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        if self.compile_s is None:
            self.compile_s = _build_kernels(self.device, self.cfg.metrics)
        return self.compile_s

    def __call__(self, seed) -> ClusterState:
        keys = cluster_keys(seed, self.n_clusters, self.device)
        return _run(self.cfg, keys, self.kn, self.n_ticks)


def make_fuzz_fn(cfg: SimConfig, n_clusters: int, n_ticks: int,
                 device=None) -> FuzzProgram:
    """Build fn(seed) -> final batched ClusterState."""
    return FuzzProgram(cfg, n_clusters, n_ticks, device)


def fuzz(cfg: SimConfig, seed: int, n_clusters: int, n_ticks: int,
         device=None) -> FuzzReport:
    """Run n_clusters independent simulations for n_ticks; cluster c draws
    from fold_in(PRNGKey(seed), c)."""
    fn = make_fuzz_fn(cfg, n_clusters, n_ticks, device)
    return report(fn(seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_telemetry(fn: FuzzProgram, rep_fn, seed, n_steps: int,
                  n_lanes: Optional[int] = None) -> tuple:
    """Set up ``fn`` (timed), run it (timed, ending in the report's copy
    to the host) and return ``(report, telemetry_dict)`` with the
    reference's keys."""
    compile_s = fn.compile_timed(seed)
    t0 = time.perf_counter()
    final = fn(seed)
    rep = rep_fn(final)
    _sync(fn.device)
    execute_s = time.perf_counter() - t0
    dev = fn.device
    tele = {
        "execute_s": round(execute_s, 4),
        "steps_per_sec": round(n_steps / execute_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dev.type,
    }
    if n_lanes:
        sb = tree_bytes(final)
        tele["state_layout"] = "wide"  # no packed carry yet
        tele["state_hbm_bytes"] = sb
        tele["bytes_per_lane"] = round(sb / n_lanes, 1)
    tele["compile_s"] = round(compile_s, 4)
    return rep, tele


def _validate_knobs(kn: Knobs) -> None:
    """Eagerly reject knob values that would silently misbehave inside the
    tick (the reference's ``engine._validate_knobs``)."""
    k = Knobs(*(x.cpu().numpy() for x in kn))
    for name in ("loss_prob", "p_crash", "p_restart", "p_repartition",
                 "p_heal", "p_leader_part", "p_asym_cut", "p_client_cmd",
                 "p_lose_unsynced", "p_limp", "p_limp_heal", "p_fsync_stall"):
        v = getattr(k, name)
        if (v < 0).any() or (v > 1).any():
            raise ValueError(f"raft knob {name} outside [0, 1]: {v}")
    if (k.fsync_every < 1).any():
        raise ValueError(
            f"fsync_every must be >= 1 tick (1 = sync every tick, the "
            f"perfect-persistence model): {k.fsync_every}"
        )
    if (k.eto_max < k.eto_min).any() or (k.eto_min < 1).any():
        raise ValueError(f"election timeout span empty: [{k.eto_min}, {k.eto_max}]")
    if (k.delay_max < k.delay_min).any() or (k.delay_min < 1).any():
        raise ValueError(f"delay span empty: [{k.delay_min}, {k.delay_max}]")
    if (k.delay_max - k.delay_min >= 256).any():
        raise ValueError(
            "delay span wider than 256 ticks exceeds the packed draw width "
            "(step.py _net_draws)"
        )
    if (k.majority < 1).any() or (k.heartbeat_ticks < 1).any():
        raise ValueError("majority and heartbeat_ticks must be >= 1")
    if (k.flow_cap < 1).any() or (k.compact_every < 1).any():
        raise ValueError("flow_cap and compact_every must be >= 1")
    if (k.limp_mult_max < 1).any():
        raise ValueError(
            f"limp_mult_max must be >= 1 (1 = limping off): {k.limp_mult_max}"
        )
    if (k.eto_skew < 0).any() or (k.fsync_stall_ticks < 0).any():
        raise ValueError("eto_skew and fsync_stall_ticks must be >= 0")
    if (k.rolling_period < 0).any() or (k.rolling_down < 0).any():
        raise ValueError("rolling_period and rolling_down must be >= 0")
    if ((k.rolling_period > 0) & (k.rolling_down >= k.rolling_period)).any():
        raise ValueError(
            "rolling_down must stay < rolling_period (a wave's node must "
            "come back up before the next wave starts)"
        )


def validate_probs(k, names, layer: str) -> None:
    """The [0, 1] range check of a layer's probability knobs (``k`` holds
    numpy arrays), in the reference's words."""
    for name in names:
        v = getattr(k, name)
        if (v < 0).any() or (v > 1).any():
            raise ValueError(f"{layer} knob {name} outside [0, 1]: {v}")


def validate_bool_bugs(k, names, layer: str) -> None:
    """The bool-dtype check of a layer's planted-bug knobs (``k`` holds
    numpy arrays), in the reference's words."""
    for name in names:
        if getattr(k, name).dtype != np.bool_:
            raise ValueError(
                f"{layer} bug knob {name} must be boolean (got "
                f"{getattr(k, name).dtype}); an int 0/1 matrix would fail "
                "deep inside the compiled loop with a carry-dtype error"
            )


def validate_service_raft_knobs(kn: Knobs) -> None:
    """A service layer's raft knobs must leave command injection and the
    compaction boundary to the service (the reference's checks)."""
    if (kn.p_client_cmd != 0).any():
        raise ValueError(
            "service-layer sweeps need p_client_cmd == 0 in the raft knobs "
            "(the service layer owns command injection)"
        )
    if kn.compact_at_commit.any():
        raise ValueError(
            "service-layer sweeps need compact_at_commit=False in the raft "
            "knobs (the compaction boundary must follow the apply cursor)"
        )


def resolve_knobs(cfg: SimConfig, knobs, device=None) -> Knobs:
    """``cfg.knobs()`` with an optional override (a full ``Knobs`` or a
    mapping of field -> value) merged on top and validated."""
    kn = cfg.knobs(device)
    if knobs is None:
        _validate_knobs(kn)
        return kn
    if isinstance(knobs, Knobs):
        kn = knobs.to(device)
    else:
        if not isinstance(knobs, dict):
            raise ValueError(
                "knobs override must be a JSON object / mapping of field "
                f"-> value, got {type(knobs).__name__}"
            )
        unknown = set(knobs) - set(kn._fields)
        if unknown:
            raise ValueError(f"unknown knob fields: {sorted(unknown)}")
        coerced = {}
        for k, v in knobs.items():
            dt = getattr(kn, k).dtype
            if dt == torch.int32 and v != int(v):
                raise ValueError(
                    f"knob {k!r} is integer-valued; {v!r} would be "
                    f"silently truncated"
                )
            coerced[k] = torch.tensor(v, dtype=dt, device=device)
        kn = kn._replace(**coerced)
    _validate_knobs(kn)
    return kn


def replay_cluster(cfg: SimConfig, seed: int, cluster_id: int, n_ticks: int,
                   knobs=None, device=None) -> ClusterState:
    """Re-run one cluster alone (a batch of one) from its (seed, cluster_id)
    stream, with an optional knob override; returns its final wide state
    with the batch axis of length 1. The result is the same in either
    carry layout, so the replay ticks the wide state throughout."""
    dev = resolve_device(device)
    check_card_shape(dev, cfg)
    kn = resolve_knobs(cfg, knobs, dev)
    keys = cluster_keys(seed, 1, dev, id0=int(cluster_id))
    return _run(cfg, keys, kn, n_ticks)


# --------------------------------------------------------------------------
# Sweep: a fault-parameter grid, each cluster under its own knob row (the
# reference's make_sweep_fn). A small grid runs as one uniform-knob run per
# contiguous cell over its global ids [id0, id0 + n); a larger one as one
# run of the whole batch with [B] knob rows. Both layouts give the same
# report: the same knob values reach the same (seed, cluster_id) streams.
# --------------------------------------------------------------------------

# Grids of at most this many contiguous knob cells run cell by cell.
SWEEP_UNIFORM_MAX_CELLS = 8


def _knob_runs(kb: Knobs, n_clusters: int) -> list:
    """Contiguous runs of identical per-cluster knob rows, as
    [(start, length), ...]."""
    cols = np.stack(
        [x.cpu().numpy().astype(np.float64) for x in kb], axis=1
    )  # i32/bool knob values are exact in f64
    change = np.any(cols[1:] != cols[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
    lengths = np.diff(np.concatenate([starts, [n_clusters]]))
    return list(zip(starts.tolist(), lengths.tolist()))


class _UniformSweepDispatch:
    """One uniform-knob run per contiguous cell of the grid, over the
    cell's global ids; ``fn(seed)`` returns the cells' final states
    concatenated back into one batch, as the per-cluster layout does."""

    dispatch = "uniform"

    def __init__(self, cfg: SimConfig, kb: Knobs, runs: list, n_ticks: int,
                 device: torch.device):
        self.cfg, self.n_ticks, self.device = cfg, n_ticks, device
        # each cell's knobs as 0-d tensors: the uniform tick
        self._cells = [(start, length, Knobs(*(x[start] for x in kb)))
                       for start, length in runs]
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        if self.compile_s is None:
            self.compile_s = _build_kernels(self.device, self.cfg.metrics)
        return self.compile_s

    def __call__(self, seed) -> ClusterState:
        finals = [
            _run(self.cfg, cluster_keys(seed, length, self.device, id0=start),
                 kn, self.n_ticks)
            for start, length, kn in self._cells]
        return ClusterState(*(torch.cat(xs) for xs in zip(*finals)))


def make_sweep_fn(cfg: SimConfig, knobs: Knobs, n_clusters: int,
                  n_ticks: int,
                  uniform_max_cells: int = SWEEP_UNIFORM_MAX_CELLS,
                  device=None):
    """Like make_fuzz_fn, but each cluster runs its own knob row
    (``knobs`` fields 0-d or [n_clusters]). A grid of at most
    ``uniform_max_cells`` contiguous cells runs cell by cell; the returned
    callable's ``dispatch`` says which layout was taken
    ("uniform" | "per_cluster"); ``uniform_max_cells=0`` forces the
    per-cluster layout."""
    dev = resolve_device(device)
    check_card_shape(dev, cfg)
    knobs = knobs.to(dev)
    _validate_knobs(knobs)
    kb = knobs.broadcast(n_clusters)
    if uniform_max_cells:
        runs = _knob_runs(kb, n_clusters)
        if len(runs) <= uniform_max_cells:
            return _UniformSweepDispatch(cfg, kb, runs, n_ticks, dev)
    fn = FuzzProgram(cfg, n_clusters, n_ticks, dev, kn=kb)
    fn.dispatch = "per_cluster"
    return fn


# --------------------------------------------------------------------------
# The continuous fuzzing pool (retire-and-refill), the twin of the
# reference's run_pool with the heartbeat off (coverage: run_pool below).
#
# n_clusters lanes stay resident. Between chunks the carry is the packed
# schema whenever it is exact for the run (the reference's layout rule);
# a chunk is one K3 unpack (none for the first chunk, which runs on the
# fresh wide batch), chunk_ticks wide ticks, the harvest on the wide view
# (K7: retire mask, ids, the small per-lane report snapshot, fresh
# init_cluster lanes under fold_in(PRNGKey(seed), id) written into the
# retired lanes) and one K3 pack. The reference widens on use every tick; the
# two orders are bit-identical because the round trip is exact inside
# config.packed_bounds. Retired lanes take new GLOBAL ids, by a monotone
# counter (default) or the lane-partitioned scheme (devices=1: lane l's
# generation-g cluster owns id g * lanes + l), so every pool hit replays
# through replay_cluster(seed, id) like a fuzz hit.
# --------------------------------------------------------------------------

# Ticks per pool chunk at most (the reference's CHUNK_TICKS).
CHUNK_TICKS = 256


def default_chunk_ticks(horizon: int) -> int:
    """The pool's default chunk size: the horizon split into equal chunks
    no larger than CHUNK_TICKS, so lanes retire at the horizon."""
    k = -(-horizon // CHUNK_TICKS)
    return -(-horizon // k)


class PoolHarvest(NamedTuple):
    """Per-lane report arrays fetched at each harvest (numpy, length
    n_lanes; PRE-refill values: the retiring cluster's final numbers)."""

    retired: np.ndarray            # bool: violated or horizon-reached
    ids: np.ndarray                # i32 global cluster id of the lane
    violations: np.ndarray         # i32 sticky bitmask
    first_violation_tick: np.ndarray
    first_leader_tick: np.ndarray
    committed: np.ndarray          # shadow_len
    msg_count: np.ndarray
    snap_installs: np.ndarray
    ticks_run: np.ndarray          # the cluster's age (= state.tick)
    # metrics plane: per-lane rows, zero-size trailing axes with metrics off
    lat_hist: np.ndarray           # [n, HB]
    ev_counts: np.ndarray          # [n, len(METRIC_EVENTS)]
    phase_hist: np.ndarray         # [n, P, HB]
    phase_ticks: np.ndarray        # [n, P]
    lat_ticks: np.ndarray          # [n, 1]
    worst_lat: np.ndarray          # [n, 1]
    worst_phases: np.ndarray       # [n, P]
    worst_key: np.ndarray          # [n, 1]
    worst_client: np.ndarray       # [n, 1]
    worst_sub: np.ndarray          # [n, 1]


# the state leaves a harvest snapshots per lane beside its nine scalars
# (K7.METRIC_ROWS names the same leaves)
_METRIC_ROWS = PoolHarvest._fields[9:]


class CovHarvest(NamedTuple):
    """PoolHarvest plus the coverage columns (numpy, PRE-refill)."""

    pool: PoolHarvest
    new_fps: np.ndarray       # i32 [n]: new fingerprints the lane found in
    #                           its life (since its refill)
    refill_kind: np.ndarray   # i32 [n]: how the lane's knobs were produced
    #                           (coverage.REFILL_SEED / _FRESH / _MUTATE)
    seen_bits: int            # seen-set popcount (union over rows)
    knobs: dict               # MUTABLE_KNOBS name -> f32 [n] knob rows


def _worst_rows(h: PoolHarvest, lanes) -> tuple:
    return (h.worst_lat[lanes], h.worst_phases[lanes], h.worst_key[lanes],
            h.worst_client[lanes], h.worst_sub[lanes])


def _retired_row(h: PoolHarvest, lane: int, wall: float,
                 viol_total: int) -> dict:
    """One retired-cluster report dict (the streaming JSONL schema); with
    metrics on it carries the lane's whole-life metric rows."""
    mask = int(h.violations[lane])
    row = {
        "cluster_id": int(h.ids[lane]),
        "ticks_run": int(h.ticks_run[lane]),
        "violations": mask,
        "violation_names": violation_names(mask),
        "first_violation_tick": int(h.first_violation_tick[lane]),
        "first_leader_tick": int(h.first_leader_tick[lane]),
        "committed": int(h.committed[lane]),
        "msg_count": int(h.msg_count[lane]),
        "snap_installs": int(h.snap_installs[lane]),
        "wall_s": round(wall, 3),
        "violations_per_s": (
            round(viol_total / wall, 3) if wall > 0 else None
        ),
    }
    if h.lat_hist.shape[-1]:
        row["latency_hist"] = [int(x) for x in h.lat_hist[lane]]
        row["events"] = _metrics.event_summary(h.ev_counts[lane])
        row["latency_phases"] = {
            name: [int(x) for x in h.phase_hist[lane, p]]
            for p, name in enumerate(phase_names(h.phase_hist.shape[-2]))
        }
        row["worst_op"] = _metrics.worst_op_dict(
            *(x[0] for x in _worst_rows(h, [lane])))
    return row


class _PoolAccount:
    """Host-side harvest accounting: retirement counters, the effective-
    steps convention (post-violation ticks inside the retirement chunk are
    waste, not coverage) and row emission. ``consume`` runs only on
    _pipeline's consumer thread, in harvest order, and ``finish`` after
    that thread joins, so no locking is needed. With metrics on, retired
    lanes' histogram and counter rows merge by sum and their worst ops by
    ``metrics.merge_worst_registers``; ``finish`` adds the lanes still
    running."""

    def __init__(self, on_retired, guided: bool = False):
        self.on_retired = on_retired
        self.guided = guided
        self.retired_total = 0
        self.viol_total = 0
        self.effective = 0
        self.union = 0
        self.viol_clusters: list = []
        self.last = None
        # metrics sums (None on metrics-off harvests)
        self.hist_total: Optional[np.ndarray] = None
        self.ev_total: Optional[np.ndarray] = None
        self.phase_total: Optional[np.ndarray] = None
        self.phase_ticks_total: Optional[np.ndarray] = None
        self.lat_ticks_total = 0
        self.worst: Optional[dict] = None
        # coverage extras (stay zero on plain harvests)
        self.seen_prev = 0
        self.new_fp_per_gen: list = []
        self.refills_mutated = 0
        self.refills_fresh = 0
        self.lane_new_fps_total = 0
        self.last_new_fps: Optional[np.ndarray] = None

    def _merge_metrics(self, h: PoolHarvest, lanes) -> None:
        """Add the metric rows of the lanes selected by ``lanes``."""
        self.hist_total += h.lat_hist[lanes].sum(axis=0)
        self.ev_total += h.ev_counts[lanes].sum(axis=0)
        self.phase_total += h.phase_hist[lanes].sum(axis=0)
        self.phase_ticks_total += h.phase_ticks[lanes].sum(axis=0)
        self.lat_ticks_total += int(h.lat_ticks[lanes].sum())
        self.worst = _metrics.merge_worst_registers(
            *_worst_rows(h, lanes), ids=h.ids[lanes], into=self.worst)

    def consume(self, h, wall: float, children_ran: bool) -> None:
        """Account one fetched harvest (a PoolHarvest, or a CovHarvest in
        the coverage pool). ``children_ran`` is True iff a chunk followed
        it, so its refilled lanes ran: the refills_* fields count those."""
        cov = isinstance(h, CovHarvest)
        if cov:
            c, h = h, h.pool
            self.new_fp_per_gen.append(c.seen_bits - self.seen_prev)
            self.seen_prev = c.seen_bits
        self.last = h
        if h.lat_hist.shape[-1] and self.hist_total is None:
            self.hist_total = np.zeros(h.lat_hist.shape[-1], np.int64)
            self.ev_total = np.zeros(h.ev_counts.shape[-1], np.int64)
            self.phase_total = np.zeros(h.phase_hist.shape[-2:], np.int64)
            self.phase_ticks_total = np.zeros(h.phase_ticks.shape[-1],
                                              np.int64)
        if self.hist_total is not None and h.retired.any():
            self._merge_metrics(h, h.retired)
        for lane in np.nonzero(h.retired)[0]:
            mask = int(h.violations[lane])
            self.retired_total += 1
            self.effective += (int(h.first_violation_tick[lane]) if mask
                               else int(h.ticks_run[lane]))
            if cov:
                self.lane_new_fps_total += int(c.new_fps[lane])
            if mask:
                self.viol_total += 1
                self.union |= mask
                self.viol_clusters.append(int(h.ids[lane]))
            if self.on_retired is not None:
                row = _retired_row(h, lane, wall, self.viol_total)
                if cov:
                    row["new_fingerprints"] = int(c.new_fps[lane])
                    row["refill"] = _cov.REFILL_NAMES[int(c.refill_kind[lane])]
                    row["knobs"] = {name: float(v[lane])
                                    for name, v in c.knobs.items()}
                self.on_retired(row)
        if cov:
            self.last_new_fps = c.new_fps
            if children_ran and self.guided:
                productive = h.retired & (c.new_fps > 0)
                self.refills_mutated += int(productive.sum())
                self.refills_fresh += int((h.retired & ~productive).sum())

    def finish(self) -> None:
        """In-flight lanes at shutdown are clean (violated => retired):
        their ticks so far are honest pre-violation coverage."""
        h = self.last
        self.effective += int(h.ticks_run[~h.retired].sum())
        if self.last_new_fps is not None:
            self.lane_new_fps_total += int(self.last_new_fps[~h.retired].sum())
        if self.hist_total is not None:
            self._merge_metrics(h, ~h.retired)


def _pipeline(launch_chunk, launch_harvest, acct: _PoolAccount,
              chunk_ticks: int, budget_ticks: Optional[int],
              budget_seconds: Optional[float]) -> tuple:
    """The chunk -> harvest loop with the reference's consumer thread.

    The main thread issues chunk k and harvest k and fetches harvest k's
    small per-lane arrays (``launch_harvest`` returns them on the host);
    a worker thread consumes fetched harvests in order (accounting, row
    emission) while the main thread issues chunk k+1. The worker touches
    numpy only. Timers, as the reference defines them:
    - ``device_wait_s``: main-thread wall inside issue and fetch (with the
      eager tick this is mostly the host issuing the tick's operations);
    - ``dispatch_gap_s``: the rest of the main thread's wall, plus the
      end-of-run drain;
    - ``host_overlap_s``: consumer wall that ran while the main thread was
      still issuing.

    Returns ``(lane_ticks, wall, dispatch_gap_s, device_wait_s,
    host_overlap_s)``."""
    import queue as queue_mod
    import threading

    t0 = time.perf_counter()
    q: queue_mod.Queue = queue_mod.Queue(maxsize=8)
    host_work = [0.0]
    exc: list = []

    def consumer():
        while True:
            item = q.get()
            if item is None:
                return
            h, wall_at_fetch, children_ran = item
            t1 = time.perf_counter()
            try:
                acct.consume(h, wall_at_fetch, children_ran)
            except BaseException as e:  # surface on the main thread
                exc.append(e)
                return
            finally:
                host_work[0] += time.perf_counter() - t1

    worker = threading.Thread(target=consumer, name="pool-harvest-consumer")
    worker.start()
    lane_ticks = 0
    device_s = 0.0
    t_loop = t0
    try:
        while True:
            t1 = time.perf_counter()
            launch_chunk()
            h = launch_harvest()
            t2 = time.perf_counter()
            device_s += t2 - t1
            lane_ticks += chunk_ticks
            wall = t2 - t0
            stop = (
                (budget_ticks is not None and lane_ticks >= budget_ticks)
                or (budget_seconds is not None and wall >= budget_seconds)
            )
            while not exc:  # a dead worker must not deadlock the put
                try:
                    q.put((h, wall, not stop), timeout=1.0)
                    break
                except queue_mod.Full:
                    continue
            if stop or exc:
                break
    finally:
        while worker.is_alive():  # a full queue must not deadlock shutdown
            try:
                q.put(None, timeout=1.0)
                break
            except queue_mod.Full:
                continue
        t_loop = time.perf_counter()
        worker.join()
        if exc:
            raise exc[0]
    t_end = time.perf_counter()
    drain = t_end - t_loop
    gap = max(0.0, (t_loop - t0) - device_s) + drain
    overlap = max(0.0, host_work[0] - drain)
    return lane_ticks, t_end - t0, gap, device_s, overlap


def _fetch(snapshot: torch.Tensor, shapes: tuple) -> tuple:
    """(PoolHarvest, the columns after its rows) of a harvest's [B, K]
    snapshot, on the host in one copy; ``shapes`` are the metric rows'
    per-lane shapes."""
    h = snapshot.cpu().numpy()
    b = h.shape[0]
    rows, at = [], 9
    for shape in shapes:
        size = int(np.prod(shape))
        rows.append(h[:, at:at + size].reshape((b, *shape)))
        at += size
    return PoolHarvest(h[:, 0].astype(bool), *h[:, 1:9].T, *rows), h[:, at:]


def _pool_mesh(n_clusters: int, devices: int, device: torch.device) -> None:
    """Validate a pool ``devices`` request (the reference's checks). One
    device runs the lane-partitioned scheme unsharded; more are not
    ported yet."""
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    if devices < 1:
        raise ValueError(f"pool devices must be >= 1, got {devices}")
    if devices > avail:
        raise ValueError(
            f"pool devices={devices} exceeds the {avail} attached "
            f"device(s)"
        )
    pool_lanes_per_shard(n_clusters, devices)
    if devices > 1:
        raise NotImplementedError(
            "pool over more than one device is not ported yet (ROADMAP A6)")


def _summary_fields(compile_s: float, gap: float, wait: float,
                    overlap: float, devices: Optional[int], book,
                    n_clusters: int, layout: str, state_bytes: int) -> tuple:
    """The pipeline-telemetry and id-scheme summary fields. ``book`` is the
    final id bookkeeping: per-lane generations (lane scheme) or the
    monotone next-id scalar. ``state_bytes`` is measured from the live
    carry tensors after the first harvest."""
    tele = {
        "compile_s": round(compile_s, 4),
        "dispatch_gap_s": round(gap, 4),
        "device_wait_s": round(wait, 4),
        "host_overlap_s": round(overlap, 4),
        "state_layout": layout,
        "state_hbm_bytes": state_bytes,
        "bytes_per_lane": round(state_bytes / n_clusters, 1),
    }
    if devices is not None:
        watermark = (int(book.max()) + 1) * n_clusters
        id_fields = {"id_scheme": "lane", "devices": devices,
                     "id_watermark": watermark}
    else:
        id_fields = {"next_cluster_id": int(book)}
    return tele, id_fields


def _pool_summary(n_clusters: int, horizon: int, chunk_ticks: int,
                  lane_ticks: int, acct: _PoolAccount, wall: float,
                  tele: dict, id_fields: dict) -> dict:
    """The pool summary dict, the reference's keys in its order; with
    metrics on it ends with ``latency`` (its ``phases`` and
    ``ticks_total``), ``events`` and ``worst_op``."""
    dispatched = lane_ticks * n_clusters
    extra = {}
    if acct.hist_total is not None:
        extra["latency"] = _metrics.latency_summary(acct.hist_total)
        extra["latency"]["phases"] = _metrics.phases_summary(
            acct.phase_total, acct.phase_ticks_total)
        extra["latency"]["ticks_total"] = acct.lat_ticks_total
        extra["events"] = _metrics.event_summary(acct.ev_total)
        extra["worst_op"] = acct.worst
    return {
        "lanes": n_clusters,
        "horizon": horizon,
        "chunk_ticks": chunk_ticks,
        "lane_ticks": lane_ticks,
        "ticks_dispatched": dispatched,
        "retired": acct.retired_total,
        "retired_violating": acct.viol_total,
        "violating_clusters": acct.viol_clusters[:16],
        "violating_clusters_total": len(acct.viol_clusters),
        "violation_names": violation_names(acct.union),
        "effective_cluster_steps": int(acct.effective),
        "wall_s": round(wall, 3),
        "steps_per_sec": round(dispatched / wall, 1) if wall > 0 else None,
        "effective_steps_per_sec": (
            round(acct.effective / wall, 1) if wall > 0 else None
        ),
        "violations_per_s": (
            round(acct.viol_total / wall, 3) if wall > 0 else None
        ),
        **tele,
        **id_fields,
        **extra,
    }


class _Carry:
    """The pool's state between launches: the resident lanes (wide at
    birth, then packed after each harvest when the run packs), their keys
    and ids, and the id bookkeeping; in the coverage pool also each lane's
    knob row, refill kind and new-fingerprint count, the seen-set stamps
    and the run-wide tick."""

    def __init__(self, states, keys, ids, book):
        self.states, self.keys, self.ids, self.book = states, keys, ids, book
        self.wide = None  # the chunk's wide result, until the harvest
        self.state_bytes = None  # the resident carry's bytes after a harvest
        self.kn_lanes = self.kinds = self.new_fps = self.seen = None
        self.t = 0


def _harvest(cfg: SimConfig, kn: Knobs, c: _Carry, seed, horizon: int,
             lane_ids: bool, packed: bool,
             ccfg: Optional[CoverageConfig] = None, tick: str = "kernel"):
    """Harvest + refill of the chunk's wide result ``c.wide`` by
    ``K7.harvest`` (its plain version with ``tick="eager"``, the A/B's
    baseline); then the carry packed (one K3 launch) when the run packs.
    Returns the snapshot fetched to the host, the loop's one
    device-to-host copy: a PoolHarvest, or with ``ccfg`` (the coverage
    pool) a CovHarvest, whose refill follows ``coverage.refill_knobs``
    when ``ccfg.guided``."""
    if tick not in ("kernel", "eager"):
        raise ValueError(f"tick must be 'kernel' or 'eager', got {tick!r}")
    wide, c.wide = c.wide, None
    cov = None if ccfg is None else K7.Cov(ccfg, c.kn_lanes, c.kinds,
                                           c.new_fps, c.seen)
    shapes = tuple(tuple(getattr(wide, f).shape[1:]) for f in _METRIC_ROWS)
    out = K7.harvest(cfg, wide, c.ids, c.book, seed, horizon, kn, lane_ids,
                     cov, plain=tick == "eager")
    c.states = K3.pack_state(cfg, out.state) if packed else out.state
    c.keys, c.ids, c.book = out.keys, out.ids, out.book
    if ccfg is not None:
        c.kn_lanes, c.kinds, c.new_fps = out.kn_lanes, out.kinds, out.new_fps
    if c.state_bytes is None:
        c.state_bytes = tree_bytes(c.states)  # live resident carry tensors
    h, cols = _fetch(out.snapshot, shapes)
    if ccfg is None:
        return h
    return CovHarvest(h, cols[:, 0], cols[:, 1], int(cols[0, 2]), {
        name: cols[:, 3 + j].view(np.float32)
        for j, name in enumerate(_cov.MUTABLE_KNOBS)})


def run_pool(
    cfg: SimConfig,
    seed: int,
    n_clusters: int,
    horizon: int,
    *,
    chunk_ticks: int = 0,
    budget_ticks: Optional[int] = None,
    budget_seconds: Optional[float] = None,
    devices: Optional[int] = None,
    on_retired=None,
    coverage: Optional[CoverageConfig] = None,
    device=None,
) -> dict:
    """Continuous fuzzing pool: chunk -> harvest -> refill until the budget
    is spent (the reference's run_pool with the heartbeat off; the metrics
    plane follows ``cfg.metrics``).

    A lane retires when its cluster violated or reached ``horizon`` ticks
    (seen at chunk boundaries) and is refilled under a new global id.
    ``on_retired`` gets one report dict per retired cluster, in retirement
    order, on the pool's consumer thread. ``budget_ticks`` stops once every
    lane has run that many ticks (rounded up to whole chunks),
    ``budget_seconds`` at the first harvest past the wall budget; neither
    given = one horizon. ``devices=None`` is the monotone-id pool,
    ``devices=1`` the lane-partitioned scheme on one device. The carry is
    packed between chunks whenever ``packed_layout_reason`` finds the
    packed schema exact for ``horizon + chunk_ticks`` per-lane ticks, and
    stays wide otherwise.

    ``coverage`` runs the coverage-guided pool (the reference's
    ``_run_pool_coverage``, whose docstring gives the contract): each tick
    of a chunk runs under per-lane knob rows and ends in the fingerprint
    (inside K6's coverage variant on the card, K5 on the eager route),
    which folds every lane's abstract-state fingerprint into the seen-set
    (one row, or one row per shard under the lane scheme) and credits the
    lanes that found a new one; each retired row gains ``new_fingerprints``,
    ``refill`` and ``knobs`` (replayable through ``replay_cluster(...,
    knobs=row["knobs"])``), the summary a ``coverage`` dict. Returns the
    summary dict; ``compile_s`` is the kernels' build before the timed
    window."""
    if horizon < 1:
        raise ValueError(f"pool horizon must be >= 1 tick, got {horizon}")
    if chunk_ticks <= 0:
        chunk_ticks = default_chunk_ticks(horizon)
    if budget_ticks is None and budget_seconds is None:
        budget_ticks = horizon
    dev = resolve_device(device)
    check_card_shape(dev, cfg)
    if devices is not None:
        _pool_mesh(n_clusters, devices, dev)
    kn = cfg.knobs(dev)
    packed = packed_layout_reason(cfg, kn, horizon + chunk_ticks) is None
    lane_ids = devices is not None
    compile_s = _build_kernels(dev, cfg.metrics, coverage is not None)

    ids = torch.arange(n_clusters, dtype=torch.int32, device=dev)
    keys = cluster_keys(seed, n_clusters, dev)
    book = (torch.zeros(n_clusters, dtype=torch.int32, device=dev) if lane_ids
            else torch.tensor(n_clusters, dtype=torch.int32, device=dev))
    # the first chunk runs on the fresh batch wide, born under the base
    # knobs; the carry holds the only reference to it
    c = _Carry(init_cluster(cfg, keys, kn), keys, ids, book)
    shard_rows = None
    if coverage is not None:
        c.kn_lanes = kn.broadcast(n_clusters)
        c.kinds = torch.full((n_clusters,), _cov.REFILL_SEED,
                             dtype=torch.int32, device=dev)
        c.new_fps = torch.zeros(n_clusters, dtype=torch.int32, device=dev)
        # one seen-set row, or one per shard (a [1, bits] row at devices=1)
        c.seen = torch.full((devices or 1, coverage.bitmap_bits), _cov.UNSEEN,
                            dtype=torch.int32, device=dev)
        if lane_ids:
            shard_rows = _cov.lane_shards(n_clusters, devices, dev)
        fp_cfg = coverage.fingerprint_key()

    def widen() -> ClusterState:
        # the chunk's input leaves the carry, so that no state outlives the
        # tick that replaces it (the device's peak memory)
        carry, c.states = c.states, None
        if isinstance(carry, PackedClusterState):
            return K3.unpack_state(cfg, carry)
        return carry

    def launch_chunk():
        cov = None if coverage is None else K6.Seen(
            fp_cfg, c.seen, shard_rows, c.new_fps, c.t)
        c.wide = _advance(cfg, widen(), c.keys,
                          kn if c.kn_lanes is None else c.kn_lanes,
                          chunk_ticks, cov)
        c.t += chunk_ticks if coverage is not None else 0

    def launch_harvest():
        return _harvest(cfg, kn, c, seed, horizon, lane_ids, packed, coverage)

    acct = _PoolAccount(on_retired,
                        guided=coverage is not None and coverage.guided)
    lane_ticks, wall, gap, wait, overlap = _pipeline(
        launch_chunk, launch_harvest, acct, chunk_ticks, budget_ticks,
        budget_seconds,
    )
    acct.finish()
    tele, id_fields = _summary_fields(
        compile_s, gap, wait, overlap, devices, c.book.cpu().numpy(),
        n_clusters, "packed" if packed else "wide", c.state_bytes,
    )
    summary = _pool_summary(n_clusters, horizon, chunk_ticks, lane_ticks,
                            acct, wall, tele, id_fields)
    if coverage is not None:
        summary["coverage"] = _coverage_summary(cfg, coverage, acct, wall,
                                                devices)
    return summary


def _coverage_summary(cfg: SimConfig, ccfg: CoverageConfig,
                      acct: _PoolAccount, wall: float,
                      devices: Optional[int]) -> dict:
    """The coverage pool summary's ``coverage`` dict, the reference's keys
    in its order (``seen_fingerprints`` is the union over the rows)."""
    return {
        "bitmap_bits": ccfg.bitmap_bits,
        "identity": _cov.identity_mapped(cfg.n_nodes, ccfg),
        "guided": ccfg.guided,
        "seen_fingerprints": acct.seen_prev,
        "new_fingerprints_per_s": (
            round(acct.seen_prev / wall, 2) if wall > 0 else None
        ),
        "lane_new_fps_total": acct.lane_new_fps_total,
        "generations": len(acct.new_fp_per_gen),
        # cut like violating_clusters[:16]; "generations" has the count
        "new_fp_per_gen": acct.new_fp_per_gen[:64],
        "refills_mutated": acct.refills_mutated,
        "refills_fresh": acct.refills_fresh,
        **({"shards": devices} if devices is not None else {}),
    }
