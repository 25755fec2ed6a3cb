"""Batch drivers for the PyTorch port: keys, init, the tick loop, reports.

The twin of the raw-raft part of ``madraft_tpu/tpusim/engine.py``. Every
entry point takes a ``device``: None means the CUDA card, and a missing
card raises instead of falling back to the CPU; ``device="cpu"`` runs the
kernels' plain versions. The (seed, cluster_id) replay contract is the
reference's: cluster ``c`` of seed ``s`` draws from
``fold_in(PRNGKey(s), c)``, so a fuzz hit replays alone, bit for bit.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import Knobs, SimConfig
from madraft_tpu_torch.tpusim.state import ClusterState, init_cluster, tree_bytes
from madraft_tpu_torch.tpusim.step import _block_total, step_cluster

# Ticks whose draw words one tick_blocks launch makes ahead. A chunk holds
# DRAW_CHUNK x B x _block_total(n) int64 words: 139 MB at 32 x 4096 x 133.
DRAW_CHUNK = 32


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
    # metrics plane: None (metrics are not ported yet)
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
    def h(x):
        return x.cpu().numpy()

    return FuzzReport(
        violations=h(final.violations),
        first_violation_tick=h(final.first_violation_tick),
        first_leader_tick=h(final.first_leader_tick),
        committed=h(final.shadow_len),
        msg_count=h(final.msg_count),
        snap_installs=h(final.snap_install_count),
    )


def _run(cfg: SimConfig, keys: torch.Tensor, kn: Knobs, n_ticks: int):
    """init, then n_ticks ticks; the draw words come a chunk of
    DRAW_CHUNK ticks at a time."""
    state = init_cluster(cfg, keys, kn)
    total = _block_total(cfg.n_nodes)
    for done in range(0, n_ticks, DRAW_CHUNK):
        m = min(DRAW_CHUNK, n_ticks - done)
        words = threefry.tick_blocks(keys, state.tick + 1, m, total,
                                     prng.partitionable())
        for i in range(m):
            state = step_cluster(cfg, state, keys, kn, words=words[i])
    return state


class FuzzProgram:
    """``fn(seed) -> final batched ClusterState`` for one config and shape.

    ``compile_timed(seed)`` does the set-up a run needs before its first
    tick — building the CUDA kernels when they are not built yet — and
    returns the wall seconds it took, so a later call times the run alone.
    """

    def __init__(self, cfg: SimConfig, n_clusters: int, n_ticks: int, device):
        self.cfg = cfg
        self.n_clusters = n_clusters
        self.n_ticks = n_ticks
        self.device = resolve_device(device)
        self.kn = cfg.knobs(self.device)
        _validate_knobs(self.kn)
        self.compile_s = None

    def compile_timed(self, seed) -> float:
        if self.compile_s is None:
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                from madraft_tpu_torch import _build

                for name in _build.SOURCES:
                    _build.library(name)
            self.compile_s = time.perf_counter() - t0
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
    stream, with an optional knob override; returns its final state with
    the batch axis of length 1."""
    dev = resolve_device(device)
    kn = resolve_knobs(cfg, knobs, dev)
    keys = cluster_keys(seed, 1, dev, id0=int(cluster_id))
    return _run(cfg, keys, kn, n_ticks)
