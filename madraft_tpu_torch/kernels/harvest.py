"""Kernel K7: the pool harvest, retire -> ids -> keys -> snapshot -> refill
-> fresh lanes, over the whole batch.

Replaces the JAX reference's harvest programs (B4),
``madraft_tpu/tpusim/engine.py`` ``_harvest_program`` (837-884),
``_lane_harvest_program`` (927-955) and ``_cov_harvest_program``
(1368-1409), with ``_retire_and_reseed`` / ``_lane_reseed``,
``coverage.refill_knobs`` (``coverage.py:195-244``) and ``_fresh_batch``
(729-739). Sources: ``csrc/harvest.cu`` (the kernels, their launch and the
note on their bound and design) and ``csrc/harvest.cuh`` (the device
code).

``harvest(cfg, state, ids, book, seed, horizon, kn, lane_ids, cov)`` takes
the chunk's wide state and returns a ``Harvested``: the refilled state, the
lanes' new keys, ids and id bookkeeping (``book``: the monotone next id, a
0-d tensor, or the lane scheme's per-lane generations), the snapshot (one
int32 [B, K] row a lane, PRE-refill: the retire flag, the old id, the nine
scalars and the metric rows of ``METRIC_ROWS`` in ``engine.PoolHarvest``'s
order, then with ``cov`` new_fps, kinds, the seen-set's union popcount and
the nine knob rows' float32 bits) and with ``cov`` the refilled knob rows,
kinds and new_fps. It runs ``harvest_plain`` on CPU tensors or where the
caller asks for it (``plain=True``, the A/B's baseline); on CUDA tensors it
launches K7 or raises. ``Harvested`` states which outputs alias the inputs.
``harvest.launches`` counts its calls that launched. ``refill_grid``
evaluates K7's refill arithmetic over every uniform the refill can draw.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim import coverage as _cov
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import CoverageConfig, Knobs, SimConfig
from madraft_tpu_torch.tpusim.state import ClusterState, init_cluster

I32 = torch.int32

# The snapshot's nine scalar columns after the retire flag and the old id
# (engine.PoolHarvest's order: violations .. ticks_run), then its metric
# rows, each a state leaf
SCALARS = ("violations", "first_violation_tick", "first_leader_tick",
           "shadow_len", "msg_count", "snap_install_count", "tick")
METRIC_ROWS = ("lat_hist", "ev_counts", "phase_hist", "phase_ticks",
               "lat_ticks", "worst_lat", "worst_phases", "worst_key",
               "worst_client", "worst_sub")

# csrc/harvest.cuh Desc: the header's length and positions
_HEADER = 31 + 2 * len(_cov.MUTABLE_KNOBS)
(_B, _N, _HORIZON, _SEED, _PART, _LANE_IDS, _COLS, _NLEAVES, _NSEGS, _TIMER,
 _COV, _GUIDED, _COLCOV, _SEEN_ROWS, _SEEN_BITS_N, _ETO_STRIDE, _VIOL, _TICK,
 _IDS, _IDS_OUT, _BOOK, _BOOK_OUT, _KEYS_OUT, _SNAP, _ETO_MIN, _ETO_MAX,
 _ETO_SKEW, _SEEN, _SEEN_BITS, _KINDS, _NEW_FPS) = range(31)
_KNOB = 31
_BASE = _KNOB + len(_cov.MUTABLE_KNOBS)


class Cov(NamedTuple):
    """The coverage pool's rows going into a harvest: ``ccfg`` its config,
    ``kn_lanes`` the lanes' knob rows (every field [B]), ``kinds`` and
    ``new_fps`` int32 [B], ``seen`` the int32 [rows, bits] stamps."""

    ccfg: CoverageConfig
    kn_lanes: Knobs
    kinds: torch.Tensor
    new_fps: torch.Tensor
    seen: torch.Tensor


class Harvested(NamedTuple):
    """What a harvest returns (see the module docstring). K7 writes
    ``state``, ``kn_lanes``, ``kinds`` and ``new_fps`` in place: they are
    the input tensors, refilled (the pool's carry owns them). The plain
    version leaves its inputs as they were and returns fresh tensors. So a
    caller that keeps the inputs passes copies. ``keys``, ``ids``,
    ``book`` and ``snapshot`` are fresh on both routes."""

    state: ClusterState
    keys: torch.Tensor
    ids: torch.Tensor
    book: torch.Tensor
    snapshot: torch.Tensor
    kn_lanes: Optional[Knobs] = None
    kinds: Optional[torch.Tensor] = None
    new_fps: Optional[torch.Tensor] = None


# ------------------------------------------------------------ plain version
def _retire_and_reseed(states: ClusterState, ids, next_id, seed, horizon):
    """The monotone id scheme: the retirement rule, left-to-right ids
    next_id, next_id + 1, ... over retired lanes (a batch-wide int32
    cumsum), and key = fold_in(PRNGKey(seed), id) for every lane (the old
    key on kept lanes, the fresh one on refilled ones)."""
    retired = (states.violations != 0) | (states.tick >= horizon)
    r32 = retired.to(I32)
    rank = torch.cumsum(r32, 0, dtype=I32) - 1
    new_ids = torch.where(retired, next_id + rank, ids)
    new_keys = prng.fold_in(prng.PRNGKey(seed, ids.device), new_ids)
    return retired, new_ids, new_keys, next_id + r32.sum(dtype=I32)


def _lane_reseed(states: ClusterState, ids, gens, seed, horizon):
    """The lane-partitioned id scheme: per-lane generation counters, lane
    l's generation-g cluster owns id g * n_lanes + l."""
    n_lanes = ids.shape[0]
    retired = (states.violations != 0) | (states.tick >= horizon)
    gens_new = gens + retired.to(I32)
    lane = torch.arange(n_lanes, dtype=I32, device=ids.device)
    new_ids = torch.where(retired, gens_new * n_lanes + lane, ids)
    new_keys = prng.fold_in(prng.PRNGKey(seed, ids.device), new_ids)
    return retired, new_ids, new_keys, gens_new


def _scatter_fresh(retired, fresh: ClusterState,
                   states: ClusterState) -> ClusterState:
    """Fresh init_cluster lanes into the retired lanes (torch.where)."""

    def sel(f, s):
        return torch.where(retired.reshape((-1,) + (1,) * (f.dim() - 1)), f, s)

    return ClusterState(*(sel(f, s) for f, s in zip(fresh, states)))


def harvest_plain(cfg: SimConfig, state: ClusterState, ids, book, seed,
                  horizon: int, kn: Knobs, lane_ids: bool,
                  cov: Optional[Cov] = None) -> Harvested:
    """K7's plain version: the retire mask and new ids, the snapshot
    (PRE-refill), with ``cov.ccfg.guided`` the biased refill
    (``coverage.refill_knobs``), then fresh ``init_cluster`` lanes
    selected into the retired ones under the (refilled) knob rows."""
    reseed = _lane_reseed if lane_ids else _retire_and_reseed
    retired, new_ids, new_keys, book = reseed(state, ids, book, seed, horizon)
    b = retired.shape[0]
    cols = [retired.to(I32)[:, None], ids[:, None]]
    cols += [getattr(state, f)[:, None] for f in SCALARS]
    cols += [getattr(state, f).reshape(b, -1) for f in METRIC_ROWS]
    kn_new = kn
    if cov is not None:
        knob_rows = torch.stack([getattr(cov.kn_lanes, name)
                                 for name in _cov.MUTABLE_KNOBS], dim=1)
        cols += [cov.new_fps[:, None], cov.kinds[:, None],
                 _cov.seen_bits(cov.seen).expand(b)[:, None],
                 knob_rows.view(I32)]
        kn_new, kinds_new = cov.kn_lanes, cov.kinds
        if cov.ccfg.guided:
            productive = retired & (cov.new_fps > 0)
            kn_new, drawn = _cov.refill_knobs(cov.ccfg, cov.kn_lanes, kn,
                                              retired, productive, new_ids,
                                              seed)
            kinds_new = torch.where(retired, drawn, cov.kinds)
    snapshot = torch.cat(cols, dim=1)
    fresh = _scatter_fresh(retired, init_cluster(cfg, new_keys, kn_new), state)
    if cov is None:
        return Harvested(fresh, new_keys, new_ids, book, snapshot)
    return Harvested(fresh, new_keys, new_ids, book, snapshot, kn_new,
                     kinds_new, torch.where(retired, 0, cov.new_fps))


# ------------------------------------------------------------------ kernel
def refill_consts(ccfg: CoverageConfig) -> np.ndarray:
    """csrc/harvest.cuh Consts: the refill's float32 constants as the plain
    version rounds them (span, fresh_lo, the fresh width, then XLA's exp
    constants and 1)."""
    span, lo, width = _cov.refill_constants(ccfg)
    return np.asarray([span, lo, width, *_cov.EXP_CONSTANTS, 1.0],
                      dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _leaf_table(cfg) -> tuple:
    """Per state leaf, in field order: (name, per-lane shape, dtype,
    init_cluster's value), read off the plain init on one CPU lane, so
    the kernel's table cannot drift from it; every leaf but the timers
    is one constant (the timers' value is unused)."""
    s = init_cluster(cfg, torch.zeros((1, 2), dtype=torch.int64))
    table = []
    for name, x in zip(ClusterState._fields, s):
        v = x.reshape(-1)
        init = 0
        if name != "timer" and v.numel():
            if not bool((v == v[0]).all()):
                raise AssertionError(
                    f"init_cluster's {name} is not one constant")
            init = int(v[0])
        table.append((name, tuple(x.shape[1:]), x.dtype, init))
    return tuple(table)


def _lib():
    lib = _build.library("harvest")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.harvest_launch.argtypes = [p, i, p, p]
        lib.harvest_launch.restype = ctypes.c_int
        lib.refill_grid_launch.argtypes = [p, p, p, i, p]
        lib.refill_grid_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _expect(x: torch.Tensor, what: str, shape: tuple, dtype, dev) -> None:
    if (x.device != dev or tuple(x.shape) != shape or x.dtype != dtype
            or not x.is_contiguous()):
        raise ValueError(
            f"harvest: {what} is {tuple(x.shape)} {x.dtype} on {x.device} "
            f"(contiguous: {x.is_contiguous()}), expected contiguous "
            f"{shape} {dtype} on {dev}")


def _descriptor(cfg: SimConfig, state: ClusterState, ids, book, seed,
                horizon: int, kn: Knobs, lane_ids: bool, cov: Optional[Cov],
                out: Harvested, seen_bits) -> np.ndarray:
    """csrc/harvest.cuh's descriptor of one harvest, the inputs checked."""
    dev, b = state.tick.device, state.tick.shape[0]
    _expect(ids, "ids", (b,), I32, dev)
    _expect(book, "book", (b,) if lane_ids else (), I32, dev)
    leaves, timer = [], None
    for (name, shape, dtype, init), x in zip(_leaf_table(cfg.static_key()),
                                             state):
        _expect(x, name, (b, *shape), dtype, dev)
        if name == "timer":
            timer = len(leaves)
        if x.numel():  # the metric leaves are empty with metrics off
            leaves.append((x.data_ptr(), x.numel() // b, x.element_size(),
                           init))
    fresh_kn = cov.kn_lanes if cov is not None else kn
    eto = [getattr(fresh_kn, k) for k in ("eto_min", "eto_max", "eto_skew")]
    per_lane = eto[0].dim() == 1
    for k, x in zip(("eto_min", "eto_max", "eto_skew"), eto):
        _expect(x, f"knob {k}", (b,) if per_lane else (), I32, dev)
    segs = [(0, 1, 0), (ids.data_ptr(), 1, 1)]
    segs += [(getattr(state, f).data_ptr(), 1, 1) for f in SCALARS]
    for f in METRIC_ROWS:
        x = getattr(state, f)
        per = x.numel() // b
        segs.append((x.data_ptr() if per else 0, per, per))
    col_cov = sum(c for _, c, _ in segs)
    head = np.zeros(_HEADER, dtype=np.int64)
    knobs = [0] * len(_cov.MUTABLE_KNOBS)
    bases = [0] * len(_cov.MUTABLE_KNOBS)
    if cov is not None:
        _expect(cov.kinds, "cov.kinds", (b,), I32, dev)
        _expect(cov.new_fps, "cov.new_fps", (b,), I32, dev)
        rows, bits = cov.seen.shape
        _expect(cov.seen, "cov.seen", (rows, bits), I32, dev)
        segs += [(cov.new_fps.data_ptr(), 1, 1), (cov.kinds.data_ptr(), 1, 1),
                 (seen_bits.data_ptr(), 1, 0)]
        for j, name in enumerate(_cov.MUTABLE_KNOBS):
            row, base = getattr(cov.kn_lanes, name), getattr(kn, name)
            _expect(row, f"cov.kn_lanes.{name}", (b,), torch.float32, dev)
            _expect(base, f"base knob {name}", (), torch.float32, dev)
            segs.append((row.data_ptr(), 1, 1))
            knobs[j], bases[j] = row.data_ptr(), base.data_ptr()
        head[[_COV, _GUIDED, _SEEN_ROWS, _SEEN_BITS_N, _SEEN, _SEEN_BITS,
              _KINDS, _NEW_FPS]] = (
            1, int(cov.ccfg.guided), rows, bits, cov.seen.data_ptr(),
            seen_bits.data_ptr(), cov.kinds.data_ptr(),
            cov.new_fps.data_ptr())
    head[[_B, _N, _HORIZON, _SEED, _PART, _LANE_IDS, _COLS, _NLEAVES, _NSEGS,
          _TIMER, _COLCOV, _ETO_STRIDE]] = (
        b, cfg.n_nodes, horizon, int(seed) & prng.MASK,
        int(prng.partitionable()), int(lane_ids), out.snapshot.shape[1],
        len(leaves), len(segs), timer, col_cov, int(per_lane))
    head[[_VIOL, _TICK, _IDS, _IDS_OUT, _BOOK, _BOOK_OUT, _KEYS_OUT, _SNAP,
          _ETO_MIN, _ETO_MAX, _ETO_SKEW]] = (
        state.violations.data_ptr(), state.tick.data_ptr(), ids.data_ptr(),
        out.ids.data_ptr(), book.data_ptr(), out.book.data_ptr(),
        out.keys.data_ptr(), out.snapshot.data_ptr(),
        *(x.data_ptr() for x in eto))
    head[_KNOB:_KNOB + len(knobs)] = knobs
    head[_BASE:_BASE + len(bases)] = bases
    return np.concatenate([head, np.asarray(leaves, np.int64).reshape(-1),
                           np.asarray(segs, np.int64).reshape(-1)])


def snapshot_cols(state: ClusterState, cov: bool) -> int:
    """The snapshot's column count K for a state (and coverage)."""
    b = state.tick.shape[0]
    metric = sum(getattr(state, f).numel() // max(b, 1) for f in METRIC_ROWS)
    return 2 + len(SCALARS) + metric + (
        3 + len(_cov.MUTABLE_KNOBS) if cov else 0)


def _launch(cfg, state, ids, book, seed, horizon, kn, lane_ids, cov,
            lib, stream) -> Harvested:
    dev, b = state.tick.device, state.tick.shape[0]
    out = Harvested(
        state, torch.empty((b, 2), dtype=torch.int64, device=dev),
        torch.empty((b,), dtype=I32, device=dev), torch.empty_like(book),
        torch.empty((b, snapshot_cols(state, cov is not None)), dtype=I32,
                    device=dev),
        *(() if cov is None else (cov.kn_lanes, cov.kinds, cov.new_fps)))
    seen_bits = (None if cov is None
                 else torch.empty((1,), dtype=I32, device=dev))
    desc = _descriptor(cfg, state, ids, book, seed, horizon, kn, lane_ids,
                       cov, out, seen_bits)
    consts = refill_consts(cov.ccfg if cov is not None else CoverageConfig())
    _build.check(lib.harvest_launch(desc.ctypes.data, len(desc),
                                    consts.ctypes.data, stream),
                 "harvest_launch")
    return out


def harvest(cfg: SimConfig, state: ClusterState, ids, book, seed,
            horizon: int, kn: Knobs, lane_ids: bool,
            cov: Optional[Cov] = None, plain: bool = False) -> Harvested:
    """One harvest of the chunk's wide ``state``: the plain version on the
    CPU or with ``plain``, else kernel K7 on CUDA (see the module
    docstring)."""
    dev = state.tick.device
    if plain or dev.type == "cpu":
        return harvest_plain(cfg, state, ids, book, seed, horizon, kn,
                             lane_ids, cov)
    if dev.type != "cuda":
        raise ValueError(f"harvest: expected CPU or CUDA tensors, got {dev}")
    if state.tick.shape[0] == 0:
        raise ValueError("harvest: an empty batch")
    out = _launch(cfg, state, ids, book, seed, horizon, kn, lane_ids, cov,
                  _lib(), torch.cuda.current_stream(dev).cuda_stream)
    harvest.launches += 1
    return out


harvest.launches = 0


def refill_grid(ccfg: CoverageConfig, device=None) -> tuple:
    """The refill's two float32 factors over the 2^23 uniforms k / 2^23
    (``coverage.refill_grid``'s order): the plain version on the CPU, K7's
    device functions (refill_grid_kernel) on CUDA. Not counted in
    ``harvest.launches``."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu":
        return _cov.refill_grid(ccfg)
    count = 1 << 23
    mut = torch.empty((count,), dtype=torch.float32, device=dev)
    fresh = torch.empty_like(mut)
    consts = refill_consts(ccfg)
    _build.check(_lib().refill_grid_launch(
        consts.ctypes.data, mut.data_ptr(), fresh.data_ptr(), count,
        torch.cuda.current_stream(dev).cuda_stream), "refill_grid_launch")
    return mut, fresh


# ------------------------------------------------------- planted inputs
HORIZONS = {"mixed": 60, "all": 0, "none": 2**31 - 1}


def planted_inputs(cfg: SimConfig, b: int, case: str, lane_ids: bool,
                   cov_mode: Optional[str], seed: int) -> tuple:
    """A harvest's arguments on the CPU for K7's checks against its plain
    version: ``(state, ids, book, seed, horizon, kn, lane_ids, cov)``.
    Every state leaf random (the fresh lanes must overwrite each), ticks
    in [0, 100) and a quarter of the lanes violated; ``case`` "mixed"
    (horizon 60), "all" (every lane retires), "none" (none does: no
    violation, horizon 2^31 - 1) or "eto_edge" (mixed, with an election
    timeout span empty, eto_max < eto_min, on some lanes and eto_max at
    2^31 - 1, where eto_max + 1 wraps, on others). The id bookkeeping sits
    next to the int32 wrap. ``cov_mode`` None (the plain pool), "guided"
    or "random" (the coverage pool): random knob rows, kinds, credits and
    a two-row seen-set."""
    g = torch.Generator().manual_seed(seed)
    ref = init_cluster(cfg, torch.zeros((1, 2), dtype=torch.int64))
    leaves = []
    for x in ref:
        shape = (b, *x.shape[1:])
        if x.dtype == torch.bool:
            leaves.append(torch.randint(0, 2, shape, generator=g).bool())
        else:
            leaves.append(torch.randint(-5, 50, shape, generator=g,
                                        dtype=I32))
    s = ClusterState(*leaves)
    viol = torch.randint(1, 1 << 10, (b,), generator=g, dtype=I32)
    viol = torch.where(torch.arange(b) % 4 == 1, viol, 0)
    if case == "none":
        viol = torch.zeros_like(viol)
    s = s._replace(tick=torch.randint(0, 100, (b,), generator=g, dtype=I32),
                   violations=viol)
    ids = torch.randperm(4 * b, generator=g)[:b].to(I32)
    book = (torch.randint(0, 2**28, (b,), generator=g, dtype=I32) if lane_ids
            else torch.tensor(2**31 - 3 - b // 3, dtype=I32))
    kn = cfg.knobs()
    eto_min = torch.full((b,), 10, dtype=I32)
    eto_max = torch.full((b,), 30, dtype=I32)
    if case == "eto_edge":
        eto_max = torch.where(torch.arange(b) % 3 == 0, 5, eto_max)
        eto_min = torch.where(torch.arange(b) % 3 == 1, 2**31 - 9, eto_min)
        eto_max = torch.where(torch.arange(b) % 3 == 1, 2**31 - 1, eto_max)
    cov = None
    if cov_mode is None:
        if case == "eto_edge":  # the plain pool's fresh lanes read kn
            kn = kn._replace(eto_min=eto_min[1], eto_max=eto_max[1])
    else:
        rows = kn.broadcast(b)._replace(eto_min=eto_min, eto_max=eto_max)
        rows = rows._replace(**{
            name: torch.rand((b,), generator=g)
            for name in _cov.MUTABLE_KNOBS})
        seen = torch.where(torch.rand((2, 64), generator=g) < 0.3,
                           torch.randint(0, 99, (2, 64), generator=g,
                                         dtype=I32), _cov.UNSEEN)
        cov = Cov(CoverageConfig(guided=cov_mode == "guided"), rows,
                  torch.randint(0, 3, (b,), generator=g, dtype=I32),
                  torch.randint(0, 3, (b,), generator=g, dtype=I32), seen)
    horizon = HORIZONS.get(case, 60)
    return s, ids, book, seed, horizon, kn, lane_ids, cov


def inputs_to(args: tuple, device) -> tuple:
    """Fresh copies of a harvest's arguments on ``device`` (the kernel
    writes the state and the coverage rows in place)."""
    s, ids, book, seed, horizon, kn, lane_ids, cov = args
    if cov is not None:
        cov = Cov(cov.ccfg, Knobs(*(x.to(device).clone()
                                    for x in cov.kn_lanes)),
            cov.kinds.to(device).clone(), cov.new_fps.to(device).clone(),
            cov.seen.to(device).clone())
    return (ClusterState(*(x.to(device).contiguous().clone() for x in s)),
            ids.to(device), book.to(device), seed, horizon, kn.to(device),
            lane_ids, cov)


def differences(want: Harvested, got: Harvested) -> list:
    """The outputs (field or field.leaf) where two harvests differ in
    dtype, shape or any value."""
    out = []
    for name, a, b in zip(Harvested._fields, want, got):
        if a is None or b is None:
            if (a is None) != (b is None):
                out.append(name)
            continue
        pairs = zip(a._fields, a, b) if isinstance(a, tuple) else [("", a, b)]
        for leaf, x, y in pairs:
            y = y.cpu()
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.cpu(), y):
                out.append(f"{name}.{leaf}" if leaf else name)
    return out
