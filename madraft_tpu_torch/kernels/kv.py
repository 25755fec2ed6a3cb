"""The kv service tick on the card: K6-kv, a chunk of kv ticks in one
launch (``kv_chunk``), and K9, one service tick a launch (``kv_tick``).

``kv_chunk(cfg, kcfg, ks, keys, kn, kkn, m)`` runs m kv ticks (the raft
tick, then the service tick) of every cluster: on CPU tensors its plain
version ``kv_chunk_plain`` (``step.step_cluster``, then
``tpusim.kv._kv_service_tick``, a tick after another); on CUDA tensors
the K6-kv build of ``csrc/tick.cu`` (``kernels.tick.variant(...,
kv=True)``: ``-DMADRAFT_K6_KV``, with ``-DMADRAFT_K6_METRICS`` for
``cfg.metrics``), which runs the service tick of ``csrc/kv.cuh`` on K6's
tile after each raft tick, the kv leaves staged in the cluster's shared
block for the chunk, or raises. ``kv_chunk.launches`` counts its
launches, ``kv_chunk.metrics_launches`` those of K6-metrics-kv; a kv run
on the card makes no ``tick_chunk`` and no ``kv_tick`` launch. The
wrapper checks the leaves and builds the descriptor once a launch
(``Side``) and returns the new ``KvState``.

K9 replaces the JAX reference's service tick (B7),
``madraft_tpu/tpusim/kv.py`` ``_kv_service_tick`` (425-989), and with the
metrics plane (K9-metrics, the build ``variant`` names) the clerks'
latency folds inside it (B5': ``metrics.py`` ``fold_latencies_by`` and
``clerk_phase_matrix`` with kv.py's folds at 662-679 and 830-849).
Sources: ``csrc/kv.cu`` (the kernel, its launch and the note on its bound
and design) and ``csrc/kv.cuh`` (the device code).

``kv_tick(cfg, kcfg, ks, pre_alive, pre_base, pre_shadow_len, s, keys,
kn, kkn)`` is the service share of one kv tick: ``ks`` the pre-tick kv
state, ``s`` its raft state after the raft tick, the pre-tick views the
raft state before it. On CPU tensors, or with ``plain=True`` (the eager
route's baseline on the card), it returns the plain version's result
(``tpusim.kv._kv_service_tick``); on CUDA tensors it launches K9 or
raises. The kernel writes a new state (the inputs stay as they were) and
hashes the tick's draws itself. ``kv_tick.launches`` counts its launches,
``kv_tick.metrics_launches`` those of K9-metrics. No kv run launches K9
since K6-kv: it is the per-tick design K6-kv is held against, with its
own tests and ``chip_smoke.py`` phase.
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

# csrc/kv.cuh limits
MAX_NODES = 16
MAX_CAP = 256
MAX_CLIENTS = 32
MAX_KEYS = 64

# The raft leaves the service tick writes, after the service leaves (the
# order of csrc/kv.cuh Leaf)
RAFT_WRITES = (
    "log_term", "log_val", "log_len", "durable_len", "violations",
    "first_violation_tick", "compact_floor", "lat_hist", "phase_hist",
    "phase_ticks", "lat_ticks", "worst_lat", "worst_phases", "worst_key",
    "worst_client", "worst_sub",
)
# The stepped raft state's leaves the kernel reads (csrc/kv.cuh Read), then
# come the pre-tick views, the keys and the knob table
RAFT_READS = ("tick", "term", "role", "alive", "base", "commit",
              "snap_installed_src", "shadow_val", "shadow_base", "shadow_len")

# The phases of a launch, in order (csrc/kv.cuh Phase), as the profile
# build (``_build.VARIANTS`` kv_profile) times them
PHASES = ("stage", "scan", "apply", "observe", "clerks", "submit",
          "write_back")

# The knob table's columns: the kv layer's float32 knobs, then its int32
# and bool ones (a bool as 0 / 1) with the raft knob flow_cap last
KNOB_F32 = ("p_op", "p_get", "p_put", "p_retry", "p_follow_hint",
            "open_rate", "zipf_a")
KNOB_I32 = ("retry_wait", "open_queue_cap", "bug_skip_dedup",
            "bug_apply_uncommitted", "bug_stale_read", "bug_stale_hint")


def variant(metrics: bool) -> str:
    """The build of csrc/kv.cu for a run (``_build.VARIANTS``)."""
    return "kv_metrics" if metrics else "kv"


def knob_table(kn, kkn, b: int) -> tuple:
    """The knobs as per-cluster rows: (float32 [B, 7], int32 [B, 7]),
    columns in KNOB_F32 / KNOB_I32 order then flow_cap; 0-d knobs are
    broadcast. A caller running many ticks builds it once."""
    f = torch.stack([getattr(kkn, k).to(torch.float32).expand(b)
                     for k in KNOB_F32], dim=1).contiguous()
    cols = [getattr(kkn, k).to(I32).expand(b) for k in KNOB_I32]
    cols.append(kn.flow_cap.to(I32).to(f.device).expand(b))
    return f, torch.stack(cols, dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def leaf_shapes(cfg: SimConfig, kcfg) -> dict:
    """name -> (per-cluster shape, dtype) of every leaf the kernel writes,
    as ``init_kv_cluster`` makes them for (cfg, kcfg)."""
    from madraft_tpu_torch.tpusim.kv import SERVICE, init_kv_cluster

    ks = init_kv_cluster(cfg, kcfg, torch.zeros((1, 2), dtype=torch.int64))
    out = {f: (tuple(getattr(ks, f).shape[1:]), getattr(ks, f).dtype)
           for f in SERVICE}
    out.update({f: (tuple(getattr(ks.raft, f).shape[1:]),
                    getattr(ks.raft, f).dtype) for f in RAFT_WRITES})
    return out


def _lib(name: str):
    lib = _build.library(name)
    if not getattr(lib, "_typed", False):
        lib.kv_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.kv_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_shape(cfg: SimConfig, kcfg, what: str = "kv_tick") -> None:
    """Refuse a shape past what csrc/kv.cuh takes, naming the limit (the
    kernel never hands a shape to the plain version)."""
    n, cap = cfg.n_nodes, cfg.log_cap
    nc, nk = kcfg.n_clients, kcfg.n_keys
    if (not 1 <= n <= MAX_NODES or cap > MAX_CAP or cap & (cap - 1)
            or not 1 <= nc <= MAX_CLIENTS or not 1 <= nk <= MAX_KEYS):
        raise ValueError(
            f"{what} takes n <= {MAX_NODES}, a power-of-two cap <= "
            f"{MAX_CAP}, n_clients <= {MAX_CLIENTS} and n_keys <= "
            f"{MAX_KEYS}, got n={n} cap={cap} n_clients={nc} n_keys={nk}")


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if (x.device != dev or tuple(x.shape) != shape or x.dtype != dtype
            or not x.is_contiguous()):
        raise ValueError(
            f"kv_tick: {name} is {tuple(x.shape)} {x.dtype} on {x.device}, "
            f"expected contiguous {shape} {dtype} on {dev}")


def _launch(cfg: SimConfig, kcfg, ks, pre_alive, pre_base, pre_shadow_len,
            s, keys, table, lib, stream):
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``kv_launch``. Returns the new KvState."""
    from madraft_tpu_torch.tpusim.kv import SERVICE, KvState

    check_shape(cfg, kcfg)
    n, cap = cfg.n_nodes, cfg.log_cap
    nc, nk = kcfg.n_clients, kcfg.n_keys
    dev, b = s.tick.device, s.tick.shape[0]
    if b == 0:
        raise ValueError("kv_tick: an empty batch")
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
    _check("pre_shadow_len", pre_shadow_len, (b,), I32, dev)
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
        pre_alive.data_ptr(), pre_base.data_ptr(), pre_shadow_len.data_ptr(),
        keys.data_ptr(), kf.data_ptr(), ki.data_ptr()]
    nph, hb = s.phase_hist.shape[1:] if cfg.metrics else (0, 0)
    head = [b, n, cap, nc, nk, kcfg.apply_max, hb, nph,
            int(prng.partitionable()), int(cfg.metrics)]
    leaves = []
    for x, y in zip(ins, outs):
        leaves += [x.data_ptr(), y.data_ptr(), x[0].numel(),
                   x.element_size()]
    desc = np.asarray(head + reads + leaves, dtype=np.int64)
    _build.check(lib.kv_launch(desc.ctypes.data, len(desc), stream),
                 "kv_launch")
    new = dict(zip(names, outs))
    raft = s._replace(**{f: new[f] for f in RAFT_WRITES})
    return KvState(raft, *(new[f] for f in SERVICE))


def kv_tick(cfg: SimConfig, kcfg, ks, pre_alive: torch.Tensor,
            pre_base: torch.Tensor, pre_shadow_len: torch.Tensor, s, keys,
            kn, kkn, table=None, plain: bool = False):
    """The service share of one kv tick: the plain version on the CPU (or
    with ``plain``), kernel K9's build for ``cfg.metrics`` on CUDA.
    ``table`` is ``knob_table(kn, kkn, B)`` on the device when the caller
    has it."""
    dev = s.tick.device
    if dev.type == "cpu" or plain:
        from madraft_tpu_torch.tpusim.kv import _kv_service_tick

        return _kv_service_tick(cfg, kcfg, ks, pre_alive, pre_base,
                                pre_shadow_len, s, keys, kn, kkn)
    if dev.type != "cuda":
        raise ValueError(f"kv_tick: expected CPU or CUDA tensors, got {dev}")
    if table is None:
        table = knob_table(kn.to(dev), kkn.to(dev), s.tick.shape[0])
    out = _launch(cfg, kcfg, ks, pre_alive, pre_base, pre_shadow_len, s, keys,
                  table, _lib(variant(cfg.metrics)),
                  torch.cuda.current_stream(dev).cuda_stream)
    kv_tick.launches += 1
    kv_tick.metrics_launches += int(cfg.metrics)
    return out


kv_tick.launches = 0
kv_tick.metrics_launches = 0


# ---------------------------------------------------------------- K6-kv
class Side:
    """K6-kv's share of a launch (``kernels.tick._launch(..., side=)``): the
    kv state's service leaves, checked once, K9's knob table, and the
    descriptor ``csrc/kv.cuh`` ``set_side`` reads (the header's n_clients
    .. metrics_on, the table's two pointers, then in, out, count and
    bytes of each leaf of ``csrc/kv.cuh`` Leaf: a raft leaf the service
    writes is K6's own, and a metric leaf K6's, so those carry their count
    alone)."""

    def __init__(self, cfg: SimConfig, kcfg, ks, table):
        from madraft_tpu_torch.tpusim.kv import SERVICE

        check_shape(cfg, kcfg, "kv_chunk")
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
        self.head = [kcfg.n_clients, kcfg.n_keys, kcfg.apply_max, hb, nph,
                     int(prng.partitionable()), int(cfg.metrics)]
        self.counts = [math.prod(shapes[f][0]) for f in RAFT_WRITES]

    def descriptor(self, ins, outs) -> np.ndarray:
        """The descriptor over the service leaves ``ins`` (contiguous) and
        their new rows ``outs``."""
        return K6.side_words(self.head, [x.data_ptr() for x in self.table],
                             ins, outs, self.counts)

    def state(self, raft, outs):
        """The new ``KvState`` of the new raft state and service rows."""
        from madraft_tpu_torch.tpusim.kv import KvState

        return KvState(raft, *outs)


def kv_chunk_plain(cfg: SimConfig, kcfg, ks, keys, kn, kkn, m: int):
    """K6-kv's plain version: m kv ticks, each ``step.step_cluster`` then
    ``tpusim.kv._kv_service_tick`` (K9's plain version) on its result."""
    from madraft_tpu_torch.tpusim.kv import _kv_service_tick
    from madraft_tpu_torch.tpusim.step import step_cluster

    for _ in range(m):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        ks = _kv_service_tick(cfg, kcfg, ks, pre.alive, pre.base,
                              pre.shadow_len, s, keys, kn, kkn)
    return ks


def kv_chunk(cfg: SimConfig, kcfg, ks, keys, kn, kkn, m: int, table=None,
             ktable=None):
    """m kv ticks of every cluster: the plain version on the CPU, K6-kv's
    build for ``cfg.metrics`` on CUDA (one launch). ``table`` and
    ``ktable`` are ``kernels.tick.knob_table(kn, B)`` and
    ``knob_table(kn, kkn, B)`` on the device when the caller has them."""
    dev = ks.raft.tick.device
    if dev.type == "cpu":
        return kv_chunk_plain(cfg, kcfg, ks, keys, kn, kkn, m)
    if dev.type != "cuda":
        raise ValueError(f"kv_chunk: expected CPU or CUDA tensors, got {dev}")
    b = keys.shape[0]
    if table is None:
        table = K6.knob_table(kn.to(dev), b)
    if ktable is None:
        ktable = knob_table(kn.to(dev), kkn.to(dev), b)
    out, launched = K6._launch(
        cfg, ks.raft, keys, kn, m, K6._lib(K6.variant(cfg.metrics, False,
                                                      kv=True)),
        torch.cuda.current_stream(dev).cuda_stream, table=table,
        side=Side(cfg, kcfg, ks, ktable))
    if launched:
        kv_chunk.launches += 1
        kv_chunk.metrics_launches += int(cfg.metrics)
    return out


kv_chunk.launches = 0
kv_chunk.metrics_launches = 0
