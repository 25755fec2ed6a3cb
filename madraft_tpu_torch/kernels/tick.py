"""Kernel K6: a chunk of raft ticks for a batch of clusters, one launch,
the tick's threefry words drawn inside it.

Replaces the rest of the JAX reference's tick (B2-rest),
``madraft_tpu/tpusim/step.py`` ``step_cluster`` lines 293-960 and
1082-1156: faults, the five delivery passes, election win, timers, client
injection, heartbeat and replication, commit advance, compaction and
fsync, with the oracle block (961-1081) and the tick's draw
(``_DrawBlock.__init__``, step.py:128) run inside it as device code.
``tick_chunk`` runs ``m`` ticks in a row for every cluster; the port's
twin is ``tpusim/step.py`` ``step_cluster``. Sources: ``csrc/tick.cu``
(the kernel and its launch, with the note on its bound and design) and
``csrc/tick.cuh`` (the tick's device code).

Variants, each its own build of ``csrc/tick.cu`` (``variant``): with
``cfg.metrics`` K6-metrics carries the metrics plane inside the tick
(B2-metrics: the submit stamps, the shadow's record stamps, the latency
fold, the event counters; the metric leaves of ``METRIC_LEAVES`` are read
and written like the others); with ``cov`` (a ``Seen``) K6-coverage stamps
every lane's coverage fingerprint into the seen-set after each tick
(B2-coverage), then the credit pass (``coverage.credit_pass``) adds the
credits to ``cov.new_fps``. Both together give K6-metrics-coverage.
With ``trace`` (an int32 [m, B, W] tensor, W = ``kernels.trace.
record_width(cfg)``) any build also writes each tick's flight-recorder
row (K8's row, ``kernels.trace.record_plain``) into ``trace[i]``: K6-trace,
which the traced replay runs instead of K8 a tick. With ``side`` (a
service's side of a launch: ``kernels.kv.Side`` or
``kernels.ctrler.Side``) ``_launch`` runs K6-kv or K6-ctrler, the
service tick after each raft tick (``kernels.kv.kv_chunk``,
``variant(..., kv=True)``; ``kernels.ctrler.ctrler_chunk``,
``variant(..., ctrler=True)``). ``cluster_args`` gives a batch of
clusters' share of a K6-shardkv launch (``kernels.shardkv.shardkv_chunk``,
whose builds of ``csrc/tick.cu`` lay a deployment's clusters out a
block).

The kernel reads the clusters' keys (``[B, 2]`` int64-held u32), the state
leaves of ``LEAVES`` and the knobs as one float32 and one int32 ``[B, k]``
table (``knob_table``, which a caller running several chunks builds once
and passes as ``table``). It hashes each tick's words itself, under
``prng.partitionable()``'s counter layout, and checks the offset of each
draw in them against ``draw_offsets``. The planted bug is the index of
``cfg.bug`` in ``config.RAFT_BUGS``. The shapes in ``SHAPES`` (with
``ae_max <= SHAPE_AE``; in the K6-ctrler builds ``CTRLER_SHAPES``) run a
template instance compiled for them, every other shape a runtime one.

On CPU tensors ``tick_chunk`` runs ``tick_chunk_plain``: the chunk's words
from ``threefry.tick_blocks_plain``, then ``step.step_cluster`` once a
tick (and ``coverage.seen_update_plain`` after it with ``cov``, the
tick's ``record_plain`` row with ``trace``); on CUDA tensors it launches
K6's variant or raises. ``tick_chunk.launches`` counts launches of every
variant, ``metrics_launches``, ``coverage_launches`` and
``trace_launches`` those of the metrics and coverage builds and those that
wrote trace rows. The result is one fresh
allocation of the state (the callers keep their input).
``tick_chunk_profiled`` runs the profile build of K6 or K6-metrics
(clock64() cycles per phase group of ``PHASES``), for ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.kernels import coverage as K5
from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.kernels import trace as K8
from madraft_tpu_torch.tpusim import coverage, prng, step
from madraft_tpu_torch.tpusim.config import (
    RAFT_BUGS,
    CoverageConfig,
    Knobs,
    SimConfig,
    metrics_dims,
)
from madraft_tpu_torch.tpusim.state import ClusterState, METRIC_LEAF0

MAX_NODES = 16
MAX_CAP = 256
MAX_AE = 64  # the kernel keeps a delivery's in-batch entries as one u64 mask
# K6-metrics' ticks a launch at most (csrc/tick.cuh kMaxMetricTicks: its
# event counts are 16-bit in registers); the engine launches 256
MAX_METRIC_TICKS = 65535
# (n, cap) of the template instances (csrc/tick.cuh shape_n / shape_cap),
# each for ae_max <= SHAPE_AE; instance i + 1, the runtime instance 0
SHAPES = ((3, 16), (3, 64), (5, 16), (5, 64), (7, 16), (7, 64))
# the K6-ctrler builds add (5, 32), ctrler-fuzz's ring (csrc/tick.cuh
# kCtrlerShapes)
CTRLER_SHAPES = SHAPES + ((5, 32),)
SHAPE_AE = 4

# Per-lane shape classes of csrc/tick.cuh (kOne .. kCap)
ONE, N, NC, NN, C = range(5)
I32, BOOL = torch.int32, torch.bool

# Every non-metric ClusterState leaf K6 reads and writes, in field order:
# (field, shape class, dtype)
LEAVES = (
    ("tick", ONE, I32), ("term", N, I32), ("voted_for", N, I32),
    ("role", N, I32), ("timer", N, I32), ("hb", N, I32), ("alive", N, BOOL),
    ("limp", N, I32), ("fsync_stall", N, I32), ("log_term", NC, I32),
    ("log_val", NC, I32), ("log_len", N, I32), ("base", N, I32),
    ("snap_term", N, I32), ("prefix_hash", N, I32), ("commit", N, I32),
    ("durable_len", N, I32), ("durable_term", N, I32),
    ("durable_voted_for", N, I32), ("compact_floor", N, I32),
    ("votes", NN, BOOL), ("next_idx", NN, I32), ("match_idx", NN, I32),
    ("adj", NN, BOOL), ("rv_req_t", NN, I32), ("rv_req_term", NN, I32),
    ("rv_req_lli", NN, I32), ("rv_req_llt", NN, I32), ("rv_rsp_t", NN, I32),
    ("rv_rsp_term", NN, I32), ("rv_rsp_granted", NN, BOOL),
    ("ae_req_t", NN, I32), ("ae_req_term", NN, I32), ("ae_req_prev", NN, I32),
    ("ae_req_prev_term", NN, I32), ("ae_req_n", NN, I32),
    ("ae_req_commit", NN, I32), ("ae_rsp_t", NN, I32),
    ("ae_rsp_term", NN, I32), ("ae_rsp_success", NN, BOOL),
    ("ae_rsp_match", NN, I32), ("sn_req_t", NN, I32), ("sn_req_term", NN, I32),
    ("snap_installed_src", N, I32), ("snap_installed_len", N, I32),
    ("next_cmd", ONE, I32), ("shadow_term", C, I32), ("shadow_val", C, I32),
    ("shadow_base", ONE, I32), ("shadow_len", ONE, I32),
    ("shadow_prefix_hash", ONE, I32), ("violations", ONE, I32),
    ("first_violation_tick", ONE, I32), ("first_leader_tick", ONE, I32),
    ("msg_count", ONE, I32), ("snap_install_count", ONE, I32),
)

# The metric leaves (csrc/tick.cuh MetricLeaf), all int32, which the
# metrics variant reads and writes and the others pass through
METRIC_LEAVES = ClusterState._fields[METRIC_LEAF0:]


class Seen(NamedTuple):
    """What K6-coverage needs of the coverage pool's seen-set for a chunk:
    ``fp`` the fingerprint's config (``CoverageConfig.fingerprint_key()``),
    ``seen`` int32 [R, bits] first-tick stamps and ``new_fps`` int32 [B]
    credits (both updated in place), ``rows`` int32 [B] each lane's
    seen-set row or None (row 0), ``t`` the run-wide tick of the chunk's
    first tick (``seen_update``'s ``t``)."""

    fp: CoverageConfig
    seen: torch.Tensor
    rows: Optional[torch.Tensor]
    new_fps: torch.Tensor
    t: int


# The tick's draws in the order step._DrawBlock._take consumes them, each
# a node row (N), one word (ONE) or a [dst, src] matrix (NN); the kernel
# gets each one's offset (draw_offsets) in csrc/tick.cuh's kDraw order
DRAWS = (
    ("restart", N), ("crash", N), ("rst_tmr", N), ("u_part", ONE),
    ("colors", N), ("asym_dst", ONE), ("asym_off", ONE), ("snap_tmr", N),
    ("grant_tmr", N), ("rv_rsp_net", N), ("ae_tmr", N), ("ae_rsp_net", N),
    ("elect_tmr", N), ("rv_req_net", NN), ("client", N), ("ae_req_net", NN),
    ("sn_req_net", NN),
)

# The profile instance's phase groups (csrc/tick.cuh Phase): staging in and
# out, the tick's draws, the faults, the five delivery passes, election /
# timers / injection, the sends, commit, the oracle, compaction and fsync
PHASES = ("stage", "draws", "faults", "rv_rsp", "ae_rsp", "snap", "rv_req",
          "ae_req", "elect", "sends", "commit", "oracle", "compact")

# The knob table's columns: the float32 knobs, then the int32 and bool
# ones (a bool as 0 / 1), each in Knobs field order
KNOB_F32 = ("loss_prob", "p_crash", "p_restart", "p_repartition", "p_heal",
            "p_leader_part", "p_asym_cut", "p_client_cmd", "p_lose_unsynced",
            "p_limp", "p_limp_heal", "p_fsync_stall")
KNOB_I32 = ("fsync_every", "eto_min", "eto_max", "delay_min", "delay_max",
            "heartbeat_ticks", "compact_every", "flow_cap", "max_dead",
            "majority", "compact_at_commit", "limp_mult_max", "eto_skew",
            "fsync_stall_ticks", "rolling_period", "rolling_down")


def _lane_shape(shape_class: int, n: int, cap: int) -> tuple:
    return {ONE: (), N: (n,), NC: (n, cap), NN: (n, n), C: (cap,)}[shape_class]


def metric_shapes(cfg: SimConfig) -> tuple:
    """Each metric leaf's per-lane shape under cfg (state.init_cluster's)."""
    hb, evn, mcap, nph, reg = metrics_dims(cfg)
    n = cfg.n_nodes
    return ((n, mcap), (mcap,), (hb,), (evn,), (nph, hb), (nph,), (reg,),
            (reg,), (nph,), (reg,), (reg,), (reg,))


def variant(metrics: bool, cov: bool, kv: bool = False,
            ctrler: bool = False) -> str:
    """The build of csrc/tick.cu that runs the tick with the metrics plane
    and / or the coverage fingerprint, or with the kv service tick (K6-kv,
    ``kernels.kv.kv_chunk``) or the shard controller's (K6-ctrler,
    ``kernels.ctrler.ctrler_chunk``; ``_build.VARIANTS``)."""
    return ("tick" + "_metrics" * bool(metrics) + "_coverage" * bool(cov)
            + "_kv" * bool(kv) + "_ctrler" * bool(ctrler))


def side_words(head, ptrs, ins, outs, counts) -> np.ndarray:
    """A service side's descriptor (``kernels.kv.Side``,
    ``kernels.ctrler.Side``): the header words, the side's pointers, then
    in, out, count and bytes of each service leaf (``ins`` contiguous,
    ``outs`` their new rows) and a raft or metric leaf's count alone (K6
    keeps those leaves)."""
    words = [*head, *ptrs]
    for x, y in zip(ins, outs):
        words += [x.data_ptr(), y.data_ptr(), x[0].numel(), x.element_size()]
    for count in counts:
        words += [0, 0, count, 4]
    return np.asarray(words, dtype=np.int64)


def draw_offsets(n: int) -> tuple:
    """(name, offset, size) of each draw of a tick's words at n nodes."""
    out, off = [], 0
    for name, shape_class in DRAWS:
        size = math.prod(_lane_shape(shape_class, n, 0))
        out.append((name, off, size))
        off += size
    return tuple(out)


def knob_table(kn: Knobs, b: int) -> tuple:
    """The knobs as per-cluster rows: (float32 [B, 12], int32 [B, 16]),
    columns in KNOB_F32 / KNOB_I32 order; 0-d knobs are broadcast."""
    f = torch.stack([getattr(kn, k).expand(b) for k in KNOB_F32], dim=1)
    i = torch.stack([getattr(kn, k).to(I32).expand(b) for k in KNOB_I32],
                    dim=1)
    return f, i


def instance(cfg: SimConfig, ctrler: bool = False) -> int:
    """The template instance that runs cfg's shape: 1 + its index in
    SHAPES (in CTRLER_SHAPES for a K6-ctrler build), or 0 for the runtime
    one."""
    shapes = CTRLER_SHAPES if ctrler else SHAPES
    shape = (cfg.n_nodes, cfg.log_cap)
    if cfg.ae_max > SHAPE_AE or shape not in shapes:
        return 0
    return 1 + shapes.index(shape)


def tick_chunk_plain(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
                     kn: Knobs, m: int, cov: Optional[Seen] = None,
                     trace: Optional[torch.Tensor] = None) -> ClusterState:
    """The chunk as the eager tick runs it: the words of the m ticks from
    each cluster's own tick on (``threefry.tick_blocks_plain`` under
    ``prng.partitionable()``), then ``step.step_cluster`` once a tick on
    its ``[B, total]`` slice (the metrics plane as ``cfg.metrics`` says),
    with ``cov`` each tick's fingerprints into the seen-set by
    ``coverage.seen_update_plain`` at run-wide tick ``cov.t + i``, and
    with ``trace`` each tick's ``record_plain`` rows into ``trace[i]``."""
    words = threefry.tick_blocks_plain(
        keys, state.tick + 1, m, step._block_total(cfg.n_nodes),
        prng.partitionable())
    for i in range(m):
        prev = state
        state = step.step_cluster(cfg, state, keys, kn, words=words[i])
        if trace is not None:
            trace[i].copy_(K8.record_plain(prev, state))
        if cov is not None:
            coverage.seen_update_plain(
                cov.fp, state.role, state.alive, state.term, state.commit,
                state.violations, cov.rows, cov.seen, cov.new_fps, cov.t + i)
    return state


def _lib(name: str = "tick"):
    lib = _build.library(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        args = [p, p, p, i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, i,
                p, i, p]
        lib.tick_launch.argtypes = args
        lib.tick_launch.restype = ctypes.c_int
        lib.credit_launch.argtypes = [p, p, p, i, i, i, p]
        lib.credit_launch.restype = ctypes.c_int
        if name.endswith("_profile"):
            lib.tick_launch_profile.argtypes = args + [p]
            lib.tick_launch_profile.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_shape(cfg: SimConfig) -> None:
    """Refuse a shape past what csrc/tick.cuh takes, naming the limit
    (the kernel never hands a shape to the plain version)."""
    n, cap = cfg.n_nodes, cfg.log_cap
    if not 1 <= n <= MAX_NODES or cap > MAX_CAP or cfg.ae_max > MAX_AE:
        raise ValueError(
            f"tick kernel takes n <= {MAX_NODES}, cap <= {MAX_CAP} and "
            f"ae_max <= {MAX_AE}, got n={n} cap={cap} ae_max={cfg.ae_max}")


def _check(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
           m: int = 0, cov: Optional[Seen] = None,
           trace: Optional[torch.Tensor] = None) -> None:
    check_shape(cfg)
    n, cap = cfg.n_nodes, cfg.log_cap
    dev, b = state.tick.device, state.tick.shape[0]
    for (name, shape_class, dtype), x in zip(LEAVES, state):
        shape = (b, *_lane_shape(shape_class, n, cap))
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"tick_chunk: {name} is {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, expected {shape} {dtype} on {dev}")
    for name, x, lane in zip(METRIC_LEAVES, state[METRIC_LEAF0:],
                             metric_shapes(cfg)):
        shape = (b, *lane)
        if x.device != dev or tuple(x.shape) != shape or x.dtype != I32:
            raise ValueError(
                f"tick_chunk: the metrics plane's {name} is "
                f"{tuple(x.shape)} {x.dtype} on {x.device}, expected {shape} "
                f"int32 on {dev} (cfg.metrics={cfg.metrics})")
    if (keys.device != dev or keys.dtype != torch.int64
            or tuple(keys.shape) != (b, 2)):
        raise ValueError(
            f"tick_chunk: keys are {tuple(keys.shape)} {keys.dtype} on "
            f"{keys.device}, expected [{b}, 2] int64 on {dev}")
    if trace is not None:
        shape = (m, b, K8.record_width(cfg))
        if (trace.device != dev or tuple(trace.shape) != shape
                or trace.dtype != I32 or not trace.is_contiguous()):
            raise ValueError(
                f"tick_chunk: trace is {tuple(trace.shape)} {trace.dtype} on "
                f"{trace.device}, expected contiguous {shape} int32 on {dev}")
    if cov is None:
        return
    bits = cov.fp.bitmap_bits
    named = {"seen": (cov.seen, (cov.seen.shape[0], bits)),
             "new_fps": (cov.new_fps, (b,))}
    if cov.rows is not None:
        named["rows"] = (cov.rows, (b,))
    for name, (x, shape) in named.items():
        if (x.device != dev or tuple(x.shape) != shape or x.dtype != I32
                or not x.is_contiguous()):
            raise ValueError(
                f"tick_chunk: cov.{name} is {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, expected contiguous {shape} int32 on {dev}")
    if bits & (bits - 1) or cov.seen.numel() >= 2**31:
        raise ValueError(f"tick_chunk: a seen-set of {cov.seen.shape[0]} x "
                         f"{bits} bits (a power of two, below 2^31 in all)")
    if not 0 <= cov.t <= coverage.UNSEEN - m:
        raise ValueError(f"tick_chunk: run-wide ticks {cov.t} .. "
                         f"{cov.t + m - 1} outside [0, {coverage.UNSEEN})")


def _fresh(written, spare_words: int, dev) -> tuple:
    """One allocation holding a 16-byte aligned view shaped like each
    tensor of ``written``, then ``spare_words`` int32 words: (the views,
    the allocation, the spare words' byte offset)."""
    offs, nbytes = [], 0
    for x in written:
        offs.append(nbytes)
        nbytes += -(-x.numel() * x.element_size() // 16) * 16
    buf = torch.empty((nbytes + 4 * spare_words,), dtype=torch.uint8,
                      device=dev)
    outs = [buf[at:at + x.numel() * x.element_size()].view(x.dtype)
            .view(x.shape) for x, at in zip(written, offs)]
    return outs, buf, nbytes


def _launch(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
            kn: Knobs, m: int, lib, stream, prof=None,
            table=None, cov: Optional[Seen] = None, fp=None,
            trace: Optional[torch.Tensor] = None, side=None) -> tuple:
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``tick_launch`` for m ticks on ``stream`` (``tick_launch_profile``
    into ``prof`` when given): with ``cfg.metrics`` the metric leaves go
    in and come out too (and a spare row of the stamp rings, which a tile
    past the batch's end works on), with ``cov`` the coverage arguments go
    in and ``fp`` (int32 [m, B]) gets each lane-tick's flat seen index,
    with ``trace`` (int32 [m, B, W]) each tick's trace rows, with ``side``
    (a service's side: ``kernels.kv.Side`` for K6-kv,
    ``kernels.ctrler.Side`` for K6-ctrler) the service state's leaves go
    in and come out too. Returns (new state, launched), the state the
    service's (``side.state``) with ``side``."""
    _check(cfg, state, keys, m, cov, trace)
    if cfg.metrics and m > MAX_METRIC_TICKS:
        raise ValueError(f"tick_chunk: K6-metrics runs at most "
                         f"{MAX_METRIC_TICKS} ticks a launch, got {m}")
    dev, b = state.tick.device, state.tick.shape[0]
    n, cap = cfg.n_nodes, cfg.log_cap
    metrics = cfg.metrics
    # the new state: one allocation, each leaf a 16-byte aligned view (the
    # metric leaves too when the kernel writes them), then the spare row
    written = list(state[:METRIC_LEAF0] if not metrics else state)
    n_raft = len(written)
    if side is not None:
        written += side.leaves
    outs, buf, spare = _fresh(written, (n * cap + cap) * metrics, dev)
    launched = bool(b and m)
    if launched:
        ins = [x if x.is_contiguous() else x.contiguous() for x in written]
        keys = keys if keys.is_contiguous() else keys.contiguous()
        kf, ki = knob_table(kn.to(dev), b) if table is None else table
        ins, svc_ins, svc_outs = ins[:n_raft], ins[n_raft:], outs[n_raft:]
        ptr_in = np.asarray([x.data_ptr() for x in ins[:METRIC_LEAF0]],
                            dtype=np.int64)
        ptr_out = np.asarray([y.data_ptr() for y in outs[:METRIC_LEAF0]],
                             dtype=np.int64)
        mptrs = None
        if metrics:  # the metric leaves in, then out, then the spare row
            mptrs = np.asarray(
                [x.data_ptr() for x in ins[METRIC_LEAF0:]]
                + [y.data_ptr() for y in outs[METRIC_LEAF0:n_raft]]
                + [buf.data_ptr() + spare], dtype=np.int64)
        cargs = None
        if cov is not None:
            ccfg, rows = cov.fp, cov.rows
            cargs = np.asarray(
                [cov.seen.data_ptr(), fp.data_ptr(),
                 0 if rows is None else rows.data_ptr(), ccfg.bitmap_bits,
                 ccfg.term_rank_levels, ccfg.commit_delta_levels,
                 coverage.node_alphabet(ccfg) & 0xFFFFFFFF,
                 int(coverage.identity_mapped(n, ccfg)), cov.t],
                dtype=np.int64)
        kinds, draws = leaf_tables(n)
        desc = None if side is None else side.descriptor(svc_ins, svc_outs)
        args = (ptr_in.ctypes.data, ptr_out.ctypes.data, kinds.ctypes.data,
                len(LEAVES), keys.data_ptr(), kf.data_ptr(), ki.data_ptr(),
                draws.ctypes.data, len(draws), b, n, cap, cfg.ae_max, m,
                RAFT_BUGS.index(cfg.bug), int(prng.partitionable()),
                None if mptrs is None else mptrs.ctypes.data,
                None if cargs is None else cargs.ctypes.data,
                None if trace is None else trace.data_ptr(),
                0 if trace is None else trace.shape[2],
                None if desc is None else desc.ctypes.data,
                0 if desc is None else len(desc), stream)
        if prof is None:
            _build.check(lib.tick_launch(*args), "tick_launch")
        else:
            _build.check(lib.tick_launch_profile(*args, prof.data_ptr()),
                         "tick_launch_profile")
    else:  # nothing to tick: the new state is the old one's copy
        for y, x in zip(outs, written):
            y.copy_(x)
    new = ClusterState(*outs[:n_raft], *state[n_raft:])
    if side is not None:
        new = side.state(new, outs[n_raft:])
    return new, launched


def leaf_tables(n: int) -> tuple:
    """(kinds, draws): the leaf table (shape class, + 8 for a bool leaf)
    and each draw's offset at n nodes, as the launches check them."""
    kinds = np.asarray([sc + (8 if dt == BOOL else 0) for _, sc, dt in LEAVES],
                       dtype=np.int32)
    draws = np.asarray([off for _, off, _ in draw_offsets(n)], dtype=np.int32)
    return kinds, draws


def cluster_args(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
                 m: int, table) -> tuple:
    """A batch of clusters' share of a launch that writes their new state
    (K6-shardkv's groups and controller, ``kernels.shardkv.shardkv_chunk``):
    (the new state, one fresh allocation of 16-byte aligned leaves; the
    int64 words ``csrc/tick.cuh`` ``set_clusters`` reads: the leaves in
    and out, the keys, the two knob tables, then in the metrics variant
    the metric leaves in and out and a spare row of the stamp rings, else
    zeros; the contiguous inputs the words point at, which must stay alive
    until the launch). The inputs are checked as ``tick_chunk`` checks
    them."""
    _check(cfg, state, keys, m)
    n, cap, metrics = cfg.n_nodes, cfg.log_cap, cfg.metrics
    written = list(state if metrics else state[:METRIC_LEAF0])
    outs, buf, spare = _fresh(written, (n * cap + cap) * metrics,
                              state.tick.device)
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (*written, keys, *table)]
    words = ([x.data_ptr() for x in ins[:METRIC_LEAF0]]
             + [y.data_ptr() for y in outs[:METRIC_LEAF0]]
             + [x.data_ptr() for x in ins[len(written):]])
    if metrics:
        words += ([x.data_ptr() for x in ins[METRIC_LEAF0:len(written)]]
                  + [y.data_ptr() for y in outs[METRIC_LEAF0:]]
                  + [buf.data_ptr() + spare])
    else:
        words += [0] * (2 * len(METRIC_LEAVES) + 1)
    new = ClusterState(*outs, *state[len(outs):])
    return new, np.asarray(words, dtype=np.int64), ins


def tick_chunk(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
               kn: Knobs, m: int, table=None,
               cov: Optional[Seen] = None,
               trace: Optional[torch.Tensor] = None) -> ClusterState:
    """m ticks of every cluster: plain version on the CPU, kernel K6's
    variant on CUDA (``variant``; with ``cov``, then the credit pass).
    ``keys`` are the clusters' PRNG keys, ``kn`` the knobs, each field 0-d
    or a [B] row; ``table`` is ``knob_table(kn, B)`` on the device when the
    caller has it; ``cov`` the coverage pool's seen-set, whose ``seen``
    and ``new_fps`` are updated in place; ``trace`` an int32 [m, B,
    ``kernels.trace.record_width(cfg)``] tensor that gets each tick's
    trace rows."""
    dev = state.tick.device
    if dev.type == "cpu":
        if trace is not None:
            _check(cfg, state, keys, m, cov, trace)
        return tick_chunk_plain(cfg, state, keys, kn, m, cov, trace)
    if dev.type != "cuda":
        raise ValueError(f"tick_chunk: expected CPU or CUDA tensors, got {dev}")
    lib = _lib(variant(cfg.metrics, cov is not None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fp = None if cov is None else torch.empty(
        (m, state.tick.shape[0]), dtype=I32, device=dev)
    out, launched = _launch(cfg, state, keys, kn, m, lib, stream,
                            table=table, cov=cov, fp=fp, trace=trace)
    if launched:
        tick_chunk.launches += 1
        tick_chunk.metrics_launches += int(cfg.metrics)
        tick_chunk.coverage_launches += int(cov is not None)
        tick_chunk.trace_launches += int(trace is not None)
        if cov is not None:
            K5.credit_pass(fp, cov.seen, cov.new_fps, cov.t, lib)
    return out


tick_chunk.launches = 0
tick_chunk.metrics_launches = 0
tick_chunk.coverage_launches = 0
tick_chunk.trace_launches = 0


def tick_chunk_profiled(cfg: SimConfig, state: ClusterState,
                        keys: torch.Tensor, kn: Knobs, m: int) -> tuple:
    """K6's profile instance on CUDA tensors, K6-metrics' with
    ``cfg.metrics`` (a measurement, not counted in
    ``tick_chunk.launches``): the chunk's new state and each cluster's
    clock64() cycles per phase group, int64 [B, len(PHASES)]."""
    dev, b = state.tick.device, state.tick.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"tick_chunk_profiled runs on CUDA, got {dev}")
    prof = torch.zeros((b, len(PHASES)), dtype=torch.int64, device=dev)
    lib = _lib(variant(cfg.metrics, False) + "_profile")
    out, _ = _launch(cfg, state, keys, kn, m, lib,
                     torch.cuda.current_stream(dev).cuda_stream, prof)
    return out, prof
