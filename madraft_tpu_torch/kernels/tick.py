"""Kernel K6: a chunk of raft ticks for a batch of clusters, one launch.

Replaces the rest of the JAX reference's tick (B2-rest),
``madraft_tpu/tpusim/step.py`` ``step_cluster`` lines 293-960 and
1082-1156: faults, the five delivery passes, election win, timers, client
injection, heartbeat and replication, commit advance, compaction and
fsync, with the oracle block (961-1081) run inside it as device code.
``tick_chunk`` runs ``m`` ticks in a row for every cluster with the
metrics plane off; the port's twin is ``tpusim/step.py`` ``step_cluster``.
Sources: ``csrc/tick.cu`` (the kernel and its launch, with the note on its
bound) and ``csrc/tick.cuh`` (the tick's device code).

The kernel reads K1's chunk of draw words as it is (``[m, B, total]``
int64-held u32 words), the state leaves of ``LEAVES`` and the knobs as one
float32 and one int32 ``[B, k]`` table (``knob_table``), and takes the
offset of each draw in a tick's words from ``draw_offsets``. The planted
bug is the index of ``cfg.bug`` in ``config.RAFT_BUGS``.

On CPU tensors ``tick_chunk`` runs ``tick_chunk_plain``, which loops
``step.step_cluster`` over the chunk; on CUDA tensors it launches K6 or
raises. ``tick_chunk.launches`` counts launches. The result is one fresh
allocation of the state (the callers keep their input).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim import step
from madraft_tpu_torch.tpusim.config import RAFT_BUGS, Knobs, SimConfig
from madraft_tpu_torch.tpusim.state import ClusterState, METRIC_LEAF0

MAX_NODES = 16
MAX_CAP = 256
MAX_AE = 64  # the kernel keeps a delivery's in-batch entries as one u64 mask

# Per-lane shape classes of csrc/tick.cuh (kOne .. kCap)
ONE, N, NC, NN, C = range(5)
I32, BOOL = torch.int32, torch.bool

# Every ClusterState leaf K6 reads and writes, in field order: (field, shape
# class, dtype); the metric leaves pass through untouched
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


def tick_chunk_plain(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
                     kn: Knobs, words: torch.Tensor) -> ClusterState:
    """The chunk as the eager tick runs it: ``step.step_cluster`` once per
    tick, on that tick's ``[B, total]`` slice of ``words``."""
    for i in range(words.shape[0]):
        state = step.step_cluster(cfg, state, keys, kn, words=words[i])
    return state


def _lib():
    lib = _build.library("tick")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tick_launch.argtypes = [p, p, p, i, p, p, p, p, i,
                                    i, i, i, i, i, i, p]
        lib.tick_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(cfg: SimConfig, state: ClusterState, words: torch.Tensor) -> None:
    n, cap = cfg.n_nodes, cfg.log_cap
    if cfg.metrics:
        raise ValueError("tick_chunk runs the tick with the metrics plane "
                         "off (cfg.metrics must be False)")
    if not 1 <= n <= MAX_NODES or cap > MAX_CAP or cfg.ae_max > MAX_AE:
        raise ValueError(
            f"tick kernel takes n <= {MAX_NODES}, cap <= {MAX_CAP} and "
            f"ae_max <= {MAX_AE}, got n={n} cap={cap} ae_max={cfg.ae_max}")
    dev, b = state.tick.device, state.tick.shape[0]
    for (name, shape_class, dtype), x in zip(LEAVES, state):
        shape = (b, *_lane_shape(shape_class, n, cap))
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"tick_chunk: {name} is {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, expected {shape} {dtype} on {dev}")
    total = step._block_total(n)
    if (words.device != dev or words.dtype != torch.int64 or words.dim() != 3
            or tuple(words.shape[1:]) != (b, total)):
        raise ValueError(
            f"tick_chunk: words are {tuple(words.shape)} {words.dtype} on "
            f"{words.device}, expected [m, {b}, {total}] int64 on {dev}")


def _launch(cfg: SimConfig, state: ClusterState, kn: Knobs,
            words: torch.Tensor, lib, stream) -> tuple:
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``tick_launch`` on ``stream``; returns (new state, launched)."""
    _check(cfg, state, words)
    dev, b = state.tick.device, state.tick.shape[0]
    n, cap = cfg.n_nodes, cfg.log_cap
    # the new state: one allocation, each leaf a 16-byte aligned view
    offs, nbytes = [], 0
    for name, shape_class, dtype in LEAVES:
        offs.append(nbytes)
        size = b * math.prod(_lane_shape(shape_class, n, cap)) * (
            1 if dtype == BOOL else 4)
        nbytes += -(-size // 16) * 16
    buf = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    outs = []
    for (name, shape_class, dtype), x, at in zip(LEAVES, state, offs):
        size = x.numel() * (1 if dtype == BOOL else 4)
        outs.append(buf[at:at + size].view(dtype).view(x.shape))
    m = words.shape[0]
    launched = bool(b and m)
    if launched:
        ins = [x if x.is_contiguous() else x.contiguous()
               for x in state[:METRIC_LEAF0]]
        words = words if words.is_contiguous() else words.contiguous()
        kf, ki = knob_table(kn.to(dev), b)
        ptr_in = np.asarray([x.data_ptr() for x in ins], dtype=np.int64)
        ptr_out = np.asarray([y.data_ptr() for y in outs], dtype=np.int64)
        kinds = np.asarray([sc + (8 if dt == BOOL else 0)
                            for _, sc, dt in LEAVES], dtype=np.int32)
        draws = np.asarray([off for _, off, _ in draw_offsets(n)],
                           dtype=np.int32)
        _build.check(lib.tick_launch(
            ptr_in.ctypes.data, ptr_out.ctypes.data, kinds.ctypes.data,
            len(LEAVES), words.data_ptr(), kf.data_ptr(), ki.data_ptr(),
            draws.ctypes.data, len(draws), b, n, cap, cfg.ae_max, m,
            RAFT_BUGS.index(cfg.bug), stream), "tick_launch")
    else:  # nothing to tick: the new state is the old one's copy
        for y, x in zip(outs, state):
            y.copy_(x)
    return ClusterState(*outs, *state[METRIC_LEAF0:]), launched


def tick_chunk(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
               kn: Knobs, words: torch.Tensor) -> ClusterState:
    """``words.shape[0]`` ticks of every cluster: plain version on the CPU,
    kernel K6 on CUDA. ``keys`` are the clusters' PRNG keys (the plain
    version's tick takes them; the kernel reads only ``words``), ``kn``
    the knobs, each field 0-d or a [B] row."""
    dev = state.tick.device
    if dev.type == "cpu":
        return tick_chunk_plain(cfg, state, keys, kn, words)
    if dev.type != "cuda":
        raise ValueError(f"tick_chunk: expected CPU or CUDA tensors, got {dev}")
    out, launched = _launch(cfg, state, kn, words, _lib(),
                            torch.cuda.current_stream(dev).cuda_stream)
    tick_chunk.launches += int(launched)
    return out


tick_chunk.launches = 0
