"""The shard controller's service tick on the card: K6-ctrler, a chunk of
ctrler ticks in one launch (``ctrler_chunk``), and K10, one service tick a
launch (``ctrler_tick``).

``ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, m)`` runs m ctrler ticks (the
raft tick, then the service tick) of every cluster: on CPU tensors its
plain version ``ctrler_chunk_plain`` (``step.step_cluster``, then
``tpusim.ctrler._ctrler_service_tick``, a tick after another); on CUDA
tensors the K6-ctrler build of ``csrc/tick.cu`` (``kernels.tick.variant(
..., ctrler=True)``: ``-DMADRAFT_K6_CTRLER``, with ``-DMADRAFT_K6_METRICS``
for ``cfg.metrics``), which runs the service tick of ``csrc/ctrler.cuh``
on K6's tile after each raft tick, the ctrler leaves staged in the
cluster's shared block for the chunk (the nodes' two history tables in
the new state's rows in device memory), or raises.
``ctrler_chunk.launches`` counts its launches,
``ctrler_chunk.metrics_launches`` those of K6-metrics-ctrler; a ctrler run
on the card makes no ``tick_chunk`` and no ``ctrler_tick`` launch. The
wrapper checks the leaves and builds the descriptor once a launch
(``Side``) and returns the new ``CtrlerState``.

K10 replaces the JAX reference's service tick (B8),
``madraft_tpu/tpusim/ctrler.py`` ``_ctrler_service_tick`` (593-954) with
``_apply_entry`` (382-463), ``_rebalance`` (270-343), ``_min_moves``
(345-360) and ``_hash_config`` (372-379), and with the metrics plane
(K10-metrics, the build ``variant`` names) the clerks' latency and phase
folds inside it (ctrler.py 750-795, 857-864, 897-901 with ``metrics.py``
``fold_latencies``, ``clerk_phase_matrix``, ``fold_phases`` and
``update_worst``). Sources: ``csrc/ctrler.cu`` (the kernel, its launch
and the note on its bound and design), ``csrc/ctrler.cuh`` (the device
code) and ``csrc/stage.cuh`` (the staging K11 shares).

``ctrler_tick(cfg, kcfg, ks, pre_alive, pre_base, s, keys, kn, ckn)`` is
the service share of one ctrler tick: ``ks`` the pre-tick ctrler state,
``s`` its raft state after the raft tick, the pre-tick views the raft
state before it. On CPU tensors, or with ``plain=True`` (the eager
route's baseline on the card), it returns the plain version's result
(``tpusim.ctrler._ctrler_service_tick``); on CUDA tensors it launches K10
or raises. The kernel writes a new state (the inputs stay as they were)
and hashes the tick's draws itself. ``ctrler_tick.launches`` counts its
launches, ``ctrler_tick.metrics_launches`` those of K10-metrics. No
ctrler run launches K10 since K6-ctrler: it is the per-tick design
K6-ctrler is held against, with its own tests and ``chip_smoke.py``
phase.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import SimConfig

I32, BOOL = torch.int32, torch.bool

# csrc/ctrler.cuh limits
MAX_NODES = 16
MAX_CAP = 256
MAX_CLIENTS = 32
MAX_CONFIGS = 256

# The raft leaves the service tick writes, after the service leaves (the
# order of csrc/ctrler.cuh Leaf)
RAFT_WRITES = (
    "log_term", "log_val", "log_len", "durable_len", "violations",
    "first_violation_tick", "compact_floor", "lat_hist", "phase_hist",
    "phase_ticks", "lat_ticks", "worst_lat", "worst_phases", "worst_key",
    "worst_client", "worst_sub",
)
# The stepped raft state's leaves the kernel reads (csrc/ctrler.cuh Read),
# then come the pre-tick views, the keys and the knob table
RAFT_READS = ("tick", "term", "role", "alive", "base", "commit",
              "snap_installed_src", "shadow_val", "shadow_base", "shadow_len")

# The knob table's columns: the ctrler layer's float32 knobs, then its bool
# ones (as 0 / 1) with the raft knob flow_cap last
KNOB_F32 = ("p_op", "p_query", "p_move", "p_retry")
KNOB_I32 = ("bug_rotate_tiebreak", "bug_greedy_rebalance",
            "bug_full_reshuffle")


# The tick's phases (csrc/ctrler.cuh Phase), in order: the profile build
# (``_build.VARIANTS`` ctrler_profile) times each, and the truth walker's
# own cycles inside the apply phase ("walker")
PHASES = ("stage", "restore", "apply", "clerks", "submit", "write_back")


def variant(metrics: bool) -> str:
    """The build of csrc/ctrler.cu for a run (``_build.VARIANTS``)."""
    return "ctrler_metrics" if metrics else "ctrler"


def knob_table(kn, ckn, b: int) -> tuple:
    """The knobs as per-cluster rows: (float32 [B, 4], int32 [B, 4]),
    columns in KNOB_F32 / KNOB_I32 order then flow_cap; 0-d knobs are
    broadcast. A caller running many ticks builds it once."""
    f = torch.stack([getattr(ckn, k).to(torch.float32).expand(b)
                     for k in KNOB_F32], dim=1).contiguous()
    cols = [getattr(ckn, k).to(I32).expand(b) for k in KNOB_I32]
    cols.append(kn.flow_cap.to(I32).to(f.device).expand(b))
    return f, torch.stack(cols, dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def leaf_shapes(cfg: SimConfig, kcfg) -> dict:
    """name -> (per-cluster shape, dtype) of every leaf the kernel writes,
    as ``init_ctrler_cluster`` makes them for (cfg, kcfg)."""
    from madraft_tpu_torch.tpusim.ctrler import SERVICE, init_ctrler_cluster

    ks = init_ctrler_cluster(cfg, kcfg, torch.zeros((1, 2), dtype=torch.int64))
    out = {f: (tuple(getattr(ks, f).shape[1:]), getattr(ks, f).dtype)
           for f in SERVICE}
    out.update({f: (tuple(getattr(ks.raft, f).shape[1:]),
                    getattr(ks.raft, f).dtype) for f in RAFT_WRITES})
    return out


def _lib(name: str):
    lib = _build.library(name)
    if not getattr(lib, "_typed", False):
        lib.ctrler_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.ctrler_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if (x.device != dev or tuple(x.shape) != shape or x.dtype != dtype
            or not x.is_contiguous()):
        raise ValueError(
            f"ctrler_tick: {name} is {tuple(x.shape)} {x.dtype} on "
            f"{x.device}, expected contiguous {shape} {dtype} on {dev}")


def check_shape(cfg: SimConfig, kcfg, what: str = "ctrler_chunk") -> None:
    """Refuse a shape past what csrc/ctrler.cuh takes, naming the limit
    (the kernels never hand a shape to the plain version): K10's and
    K6-ctrler's service limits are the same."""
    n, cap, nc = cfg.n_nodes, cfg.log_cap, kcfg.n_clients
    if (not 1 <= n <= MAX_NODES or cap > MAX_CAP or cap & (cap - 1)
            or not 1 <= nc <= MAX_CLIENTS
            or not 1 <= kcfg.n_configs <= MAX_CONFIGS):
        raise ValueError(
            f"{what} takes n <= {MAX_NODES}, a power-of-two cap <= "
            f"{MAX_CAP}, n_clients <= {MAX_CLIENTS} and n_configs <= "
            f"{MAX_CONFIGS}, got n={n} cap={cap} n_clients={nc} "
            f"n_configs={kcfg.n_configs}")


def _descriptor(cfg: SimConfig, kcfg, ks, pre_alive, pre_base, s, keys,
                table):
    """Check the inputs and allocate the new state: (the launch's
    descriptor, the new CtrlerState)."""
    from madraft_tpu_torch.tpusim.ctrler import SERVICE, CtrlerState

    check_shape(cfg, kcfg, "ctrler_tick")
    n, cap, nc = cfg.n_nodes, cfg.log_cap, kcfg.n_clients
    dev, b = s.tick.device, s.tick.shape[0]
    if b == 0:
        raise ValueError("ctrler_tick: an empty batch")
    shapes = leaf_shapes(cfg, kcfg)
    ins = [getattr(ks, f) for f in SERVICE] + [getattr(s, f)
                                                for f in RAFT_WRITES]
    names = SERVICE + RAFT_WRITES
    for name, x in zip(names, ins):
        lane, dtype = shapes[name]
        _check(name, x, (b, *lane), dtype, dev)
    lane_of = {"tick": (), "shadow_val": (cap,), "shadow_base": (),
               "shadow_len": ()}
    for name in RAFT_READS:
        _check(name, getattr(s, name), (b, *lane_of.get(name, (n,))),
               BOOL if name == "alive" else I32, dev)
    _check("pre_alive", pre_alive, (b, n), BOOL, dev)
    _check("pre_base", pre_base, (b, n), I32, dev)
    _check("keys", keys, (b, 2), torch.int64, dev)
    kf, ki = table
    _check("knob table (float32)", kf, (b, len(KNOB_F32)), torch.float32, dev)
    _check("knob table (int32)", ki, (b, len(KNOB_I32) + 1), I32, dev)
    # the new state: one allocation, each leaf a 16-byte aligned view
    offs, nbytes = [], 0
    for x in ins:
        offs.append(nbytes)
        nbytes += -(-x.numel() * x.element_size() // 16) * 16
    buf = torch.empty((max(nbytes, 16),), dtype=torch.uint8, device=dev)
    outs = [buf[at:at + x.numel() * x.element_size()].view(x.dtype)
            .view(x.shape) for x, at in zip(ins, offs)]
    reads = [getattr(s, f).data_ptr() for f in RAFT_READS] + [
        pre_alive.data_ptr(), pre_base.data_ptr(), keys.data_ptr(),
        kf.data_ptr(), ki.data_ptr()]
    nph, hb = s.phase_hist.shape[1:] if cfg.metrics else (0, 0)
    head = [b, n, cap, nc, kcfg.n_gids, kcfg.n_configs, kcfg.join_max,
            kcfg._arg_lim, kcfg.apply_max, kcfg.walk_max, hb, nph,
            int(prng.partitionable()), int(cfg.metrics)]
    leaves = []
    for x, y in zip(ins, outs):
        leaves += [x.data_ptr(), y.data_ptr(), x[0].numel(),
                   x.element_size()]
    desc = np.asarray(head + reads + leaves, dtype=np.int64)
    new = dict(zip(names, outs))
    raft = s._replace(**{f: new[f] for f in RAFT_WRITES})
    return desc, CtrlerState(raft, *(new[f] for f in SERVICE))


def _launch(cfg: SimConfig, kcfg, ks, pre_alive, pre_base, s, keys, table,
            lib, stream):
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``ctrler_launch``. Returns the new CtrlerState."""
    desc, out = _descriptor(cfg, kcfg, ks, pre_alive, pre_base, s, keys,
                            table)
    _build.check(lib.ctrler_launch(desc.ctypes.data, len(desc), stream),
                 "ctrler_launch")
    return out


def grid(cfg: SimConfig, kcfg, ks, pre_alive, pre_base, s, keys, table,
         lib) -> dict:
    """How ``lib`` lays a launch of these inputs out on the card
    (``ctrler_grid``): threads and clusters a block, shared bytes a block
    and the blocks an SM holds."""
    desc, _ = _descriptor(cfg, kcfg, ks, pre_alive, pre_base, s, keys, table)
    lib.ctrler_grid.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
    lib.ctrler_grid.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.check(lib.ctrler_grid(desc.ctypes.data, len(desc), out),
                 "ctrler_grid")
    return dict(zip(("threads_a_block", "clusters_a_block", "shared_bytes",
                     "blocks_an_sm"), out))


def ctrler_tick(cfg: SimConfig, kcfg, ks, pre_alive: torch.Tensor,
                pre_base: torch.Tensor, s, keys, kn, ckn, table=None,
                plain: bool = False):
    """The service share of one ctrler tick: the plain version on the CPU
    (or with ``plain``), kernel K10's build for ``cfg.metrics`` on CUDA.
    ``table`` is ``knob_table(kn, ckn, B)`` on the device when the caller
    has it."""
    dev = s.tick.device
    if dev.type == "cpu" or plain:
        from madraft_tpu_torch.tpusim.ctrler import _ctrler_service_tick

        return _ctrler_service_tick(cfg, kcfg, ks, pre_alive, pre_base, s,
                                    keys, kn, ckn)
    if dev.type != "cuda":
        raise ValueError(
            f"ctrler_tick: expected CPU or CUDA tensors, got {dev}")
    if table is None:
        table = knob_table(kn.to(dev), ckn.to(dev), s.tick.shape[0])
    out = _launch(cfg, kcfg, ks, pre_alive, pre_base, s, keys, table,
                  _lib(variant(cfg.metrics)),
                  torch.cuda.current_stream(dev).cuda_stream)
    ctrler_tick.launches += 1
    ctrler_tick.metrics_launches += int(cfg.metrics)
    return out


ctrler_tick.launches = 0
ctrler_tick.metrics_launches = 0


# ------------------------------------------------------------ K6-ctrler
class Side:
    """K6-ctrler's share of a launch (``kernels.tick._launch(...,
    side=)``): the ctrler state's service leaves, checked once, K10's knob
    table, the device rows (``dev``: a copy row a cluster for the pre-tick
    snap_hist an install adopts, and the spare history rows of a tile past
    the batch's end) and the descriptor ``csrc/ctrler.cuh`` ``set_side``
    reads (the header's n_clients .. metrics_on, the table's two pointers,
    the device rows, then in, out, count and bytes of each leaf of
    ``csrc/ctrler.cuh`` Leaf: a raft leaf the service writes is K6's own,
    and a metric leaf K6's, so those carry their count alone)."""

    def __init__(self, cfg: SimConfig, kcfg, ks, table):
        from madraft_tpu_torch.tpusim.ctrler import SERVICE

        check_shape(cfg, kcfg)
        dev, b = ks.raft.tick.device, ks.raft.tick.shape[0]
        shapes = leaf_shapes(cfg, kcfg)
        self.leaves = [getattr(ks, f) for f in SERVICE]
        for name, x in zip(SERVICE, self.leaves):
            lane, dtype = shapes[name]
            _check(name, x, (b, *lane), dtype, dev)
        kf, ki = table
        _check("knob table (float32)", kf, (b, len(KNOB_F32)), torch.float32,
               dev)
        _check("knob table (int32)", ki, (b, len(KNOB_I32) + 1), I32, dev)
        self.table = table
        hb, nph = ((ks.raft.phase_hist.shape[2], ks.raft.phase_hist.shape[1])
                   if cfg.metrics else (0, 0))
        self.head = [kcfg.n_clients, kcfg.n_gids, kcfg.n_configs,
                     kcfg.join_max, kcfg._arg_lim, kcfg.apply_max,
                     kcfg.walk_max, hb, nph, int(prng.partitionable()),
                     int(cfg.metrics)]
        self.counts = [math.prod(shapes[f][0]) for f in RAFT_WRITES]
        self.dev = torch.empty(
            ((b + 3) * cfg.n_nodes * kcfg.n_configs,), dtype=I32, device=dev)

    def descriptor(self, ins, outs) -> np.ndarray:
        """The descriptor over the service leaves ``ins`` (contiguous) and
        their new rows ``outs``."""
        return K6.side_words(
            self.head, [x.data_ptr() for x in (*self.table, self.dev)], ins,
            outs, self.counts)

    def state(self, raft, outs):
        """The new ``CtrlerState`` of the new raft state and service rows."""
        from madraft_tpu_torch.tpusim.ctrler import CtrlerState

        return CtrlerState(raft, *outs)


def ctrler_chunk_plain(cfg: SimConfig, kcfg, ks, keys, kn, ckn, m: int):
    """K6-ctrler's plain version: m ctrler ticks, each
    ``step.step_cluster`` then ``tpusim.ctrler._ctrler_service_tick``
    (K10's plain version) on its result."""
    from madraft_tpu_torch.tpusim.ctrler import _ctrler_service_tick
    from madraft_tpu_torch.tpusim.step import step_cluster

    for _ in range(m):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        ks = _ctrler_service_tick(cfg, kcfg, ks, pre.alive, pre.base, s,
                                  keys, kn, ckn)
    return ks


def ctrler_chunk(cfg: SimConfig, kcfg, ks, keys, kn, ckn, m: int,
                 table=None, ctable=None):
    """m ctrler ticks of every cluster: the plain version on the CPU,
    K6-ctrler's build for ``cfg.metrics`` on CUDA (one launch). ``table``
    and ``ctable`` are ``kernels.tick.knob_table(kn, B)`` and
    ``knob_table(kn, ckn, B)`` on the device when the caller has them."""
    dev = ks.raft.tick.device
    if dev.type == "cpu":
        return ctrler_chunk_plain(cfg, kcfg, ks, keys, kn, ckn, m)
    if dev.type != "cuda":
        raise ValueError(
            f"ctrler_chunk: expected CPU or CUDA tensors, got {dev}")
    b = keys.shape[0]
    if table is None:
        table = K6.knob_table(kn.to(dev), b)
    if ctable is None:
        ctable = knob_table(kn.to(dev), ckn.to(dev), b)
    out, launched = K6._launch(
        cfg, ks.raft, keys, kn, m,
        K6._lib(K6.variant(cfg.metrics, False, ctrler=True)),
        torch.cuda.current_stream(dev).cuda_stream, table=table,
        side=Side(cfg, kcfg, ks, ctable))
    if launched:
        ctrler_chunk.launches += 1
        ctrler_chunk.metrics_launches += int(cfg.metrics)
    return out


ctrler_chunk.launches = 0
ctrler_chunk.metrics_launches = 0
