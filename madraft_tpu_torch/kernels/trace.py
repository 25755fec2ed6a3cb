"""Kernel K8: the flight recorder's row for one tick.

Replaces the JAX reference's per-tick record (B10),
``madraft_tpu/tpusim/trace.py`` ``_pack_rows`` (108), ``_deliveries``
(115-136) and ``_record`` (138-158). Sources: ``csrc/trace.cu`` (the kernel,
its launch and the note on its bound and design) and ``csrc/trace.cuh``
(the device code).

``record(cfg, prev, nxt, out)`` writes each cluster's row of the tick
``prev -> nxt`` (two wide states of B clusters) into ``out``, an int32
[B, W] tensor (W = ``record_width(cfg)``, a slice of the caller's [T, B,
W] buffer): the fields of ``tpusim.trace.TickRecord`` in order, each
flattened (``field_shapes``). On CPU tensors it copies ``record_plain``'s rows
in; on CUDA tensors it launches K8 or raises. ``record.launches`` counts
its launches. The traced replay on the card does not launch it: K6-trace
(``kernels/tick.py`` ``tick_chunk(..., trace=)``) writes the same rows
from inside the tick, and ``record_plain`` is the plain version of both.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim.config import SimConfig, metrics_dims
from madraft_tpu_torch.tpusim.state import ClusterState

I32 = torch.int32

# csrc/trace.cuh Kind
COPY32, COPY_BOOL, ADJ_MASK, DELIVERIES = range(4)
# The mailboxes whose due slots the deliveries count, in TickRecord's order
MAILS = ("rv_req_t", "rv_rsp_t", "ae_req_t", "ae_rsp_t", "sn_req_t")
DELIVERED = ("rv_req_delivered", "rv_rsp_delivered", "ae_req_delivered",
             "ae_rsp_delivered", "snap_delivered")
# TickRecord's fields after the deliveries that copy a post-tick leaf of
# the same name; before them role .. alive, then adj_mask
NODE_ROWS = ("role", "term", "commit", "log_len", "base", "durable_len",
             "alive")
LATER = ("snap_installed_src", "snap_installed_len", "shadow_len",
         "msg_count", "violations", "shadow_sub", "lat_hist", "ev_counts",
         "phase_ticks", "worst_lat", "worst_phases", "worst_key",
         "worst_client", "worst_sub")


def field_shapes(cfg: SimConfig) -> tuple:
    """(TickRecord field, its per-tick shape), in order."""
    n = cfg.n_nodes
    hb, evn, mcap, nph, reg = metrics_dims(cfg)
    later = {"snap_installed_src": (n,), "snap_installed_len": (n,),
             "shadow_len": (), "msg_count": (), "violations": (),
             "shadow_sub": (mcap,), "lat_hist": (hb,), "ev_counts": (evn,),
             "phase_ticks": (nph,), "worst_lat": (reg,),
             "worst_phases": (nph,), "worst_key": (reg,),
             "worst_client": (reg,), "worst_sub": (reg,)}
    return (tuple((f, (n,)) for f in NODE_ROWS) + (("adj_mask", (n,)),)
            + tuple((f, ()) for f in DELIVERED)
            + tuple((f, later[f]) for f in LATER))


def record_width(cfg: SimConfig) -> int:
    """W: the int32 columns of one cluster's row."""
    return sum(math.prod(shape) for _, shape in field_shapes(cfg))


def record_plain(prev: ClusterState, nxt: ClusterState) -> torch.Tensor:
    """K8's plain version: the tick's rows, int32 [B, W]."""
    b, n = nxt.role.shape
    t = nxt.tick[:, None, None]
    alive, adj = nxt.alive, nxt.adj

    def cnt(mail, extra=None):
        ok = (mail == t) & alive[:, :, None] & adj
        if extra is not None:
            ok = ok & extra
        return ok.any(-1).sum(-1, dtype=I32)

    w = torch.ones((), dtype=I32, device=adj.device) << torch.arange(
        n, dtype=I32, device=adj.device)
    adj_mask = torch.where(adj, w, 0).sum(-1, dtype=I32)
    delivered = [cnt(getattr(prev, m)) for m in MAILS[:-1]]
    delivered.append(cnt(prev.sn_req_t, alive[:, None, :]))
    cols = [getattr(nxt, f).to(I32) for f in NODE_ROWS] + [adj_mask]
    cols += [x[:, None] for x in delivered]
    cols += [getattr(nxt, f) for f in LATER]
    return torch.cat([x.reshape(b, -1) for x in cols], dim=1)


def decode(cfg: SimConfig, rows: np.ndarray) -> dict:
    """TickRecord's fields (name -> numpy array with a leading [T] axis)
    of one cluster's rows [T, W], the reference's dtypes: alive bool,
    the rest int32."""
    out, at = {}, 0
    for name, shape in field_shapes(cfg):
        size = math.prod(shape)
        x = rows[:, at:at + size].reshape(rows.shape[0], *shape)
        out[name] = x.astype(bool) if name == "alive" else x.astype(np.int32)
        at += size
    return out


def _lib():
    lib = _build.library("trace")
    if not getattr(lib, "_typed", False):
        lib.record_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.record_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _descriptor(cfg: SimConfig, prev: ClusterState, nxt: ClusterState,
                out: torch.Tensor) -> np.ndarray:
    """csrc/trace.cuh's descriptor of one launch, the inputs checked."""
    dev, b, n = out.device, nxt.tick.shape[0], cfg.n_nodes
    w = record_width(cfg)
    for label, s in (("prev", prev), ("nxt", nxt)):
        for name, x in zip(ClusterState._fields, s):
            if x.device != dev or x.shape[0] != b or not x.is_contiguous():
                raise ValueError(
                    f"record: {label}.{name} is {tuple(x.shape)} on "
                    f"{x.device}, expected a contiguous [{b}, ...] leaf on "
                    f"{dev}")
    if (tuple(out.shape) != (b, w) or out.dtype != I32
            or not out.is_contiguous()):
        raise ValueError(f"record: out is {tuple(out.shape)} {out.dtype}, "
                         f"expected contiguous [{b}, {w}] int32")
    segs = []
    for name, shape in field_shapes(cfg):
        count = math.prod(shape)
        if name == "adj_mask":
            segs.append((ADJ_MASK, nxt.adj.data_ptr(), count))
        elif name in DELIVERED:
            if name == DELIVERED[0]:
                segs.append((DELIVERIES, 0, len(DELIVERED)))
        else:
            x = getattr(nxt, name)
            if tuple(x.shape[1:]) != shape:
                raise ValueError(f"record: nxt.{name} is {tuple(x.shape)}, "
                                 f"expected [{b}, *{shape}]")
            kind = COPY_BOOL if x.dtype == torch.bool else COPY32
            segs.append((kind, x.data_ptr() if count else 0, count))
    head = [b, n, w, len(segs), out.data_ptr(), nxt.tick.data_ptr(),
            nxt.alive.data_ptr(), nxt.adj.data_ptr()]
    head += [getattr(prev, m).data_ptr() for m in MAILS]
    return np.asarray(head + [v for seg in segs for v in seg], np.int64)


def _launch(cfg, prev, nxt, out, lib, stream) -> None:
    desc = _descriptor(cfg, prev, nxt, out)
    _build.check(lib.record_launch(desc.ctypes.data, len(desc), stream),
                 "record_launch")


def record(cfg: SimConfig, prev: ClusterState, nxt: ClusterState,
           out: torch.Tensor) -> None:
    """The tick's rows into ``out`` [B, W]: plain version on the CPU,
    kernel K8 on CUDA."""
    dev = out.device
    if dev.type == "cpu":
        out.copy_(record_plain(prev, nxt))
        return
    if dev.type != "cuda":
        raise ValueError(f"record: expected CPU or CUDA tensors, got {dev}")
    _launch(cfg, prev, nxt, out, _lib(),
            torch.cuda.current_stream(dev).cuda_stream)
    record.launches += 1


record.launches = 0
