"""Kernel K4: the metrics plane's latency fold.

Replaces the JAX reference's ``madraft_tpu/tpusim/metrics.py``
``fold_latencies``, ``fold_phases`` and ``update_worst`` (lines 45-142),
which its tick runs in a row on the commit latencies with metrics on (ref
``step.py`` 1034-1053). One launch a tick over the batch computes what the
three compute together. Source: ``csrc/metrics.cu``, whose header gives the
bound and the design.

The signature is generic, not raft-specific: per cluster, ``m`` ops with a
latency, a mask, a phase matrix and key / client / submit columns, so the
service layers' clerks can fold through it too. Shapes: ``lat``, ``keys``,
``clients``, ``subs`` [B, m] int32, ``mask`` [B, m] bool, ``phases`` [B, P,
m] int32; registers ``lat_hist`` [B, 16], ``phase_hist`` [B, P, 16],
``phase_ticks`` [B, P], ``lat_ticks`` [B, 1] and ``worst`` = (worst_lat [B,
1], worst_phases [B, P], worst_key, worst_client, worst_sub [B, 1]), all
int32. Returns the updated registers as fresh tensors, in that order.

On CPU tensors ``latency_fold`` runs the plain versions
(``tpusim.metrics.latency_fold_plain``); on CUDA tensors it launches the
kernel or raises. ``latency_fold.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim.config import HIST_BUCKETS
from madraft_tpu_torch.tpusim.metrics import latency_fold_plain

ARGS = ("lat", "mask", "phases", "keys", "clients", "subs", "lat_hist",
        "phase_hist", "phase_ticks", "lat_ticks", "worst_lat",
        "worst_phases", "worst_key", "worst_client", "worst_sub")


def _lib():
    lib = _build.library("metrics")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.latency_fold_launch.argtypes = [p] * 24 + [i, i, i, p]
        lib.latency_fold_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _shapes(b: int, m: int, p: int) -> tuple:
    """Each argument's shape, in ARGS order."""
    hb = HIST_BUCKETS
    return ((b, m), (b, m), (b, p, m), (b, m), (b, m), (b, m), (b, hb),
            (b, p, hb), (b, p), (b, 1), (b, 1), (b, p), (b, 1), (b, 1),
            (b, 1))


def latency_fold(lat, mask, phases, keys, clients, subs, lat_hist,
                 phase_hist, phase_ticks, lat_ticks, worst: tuple):
    """The latency fold: plain versions on the CPU, kernel K4 on CUDA."""
    args = (lat, mask, phases, keys, clients, subs, lat_hist, phase_hist,
            phase_ticks, lat_ticks, *worst)
    dev = lat.device
    for name, x in zip(ARGS, args):
        if x.device != dev:
            raise ValueError(f"latency_fold: {name} is on {x.device}, "
                             f"lat on {dev}")
    if dev.type == "cpu":
        return latency_fold_plain(lat, mask, phases, keys, clients, subs,
                                  lat_hist, phase_hist, phase_ticks,
                                  lat_ticks, worst)
    b, m = lat.shape
    p = phases.shape[1]
    for name, x, shape in zip(ARGS, args, _shapes(b, m, p)):
        dtype = torch.bool if name == "mask" else torch.int32
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"latency_fold: {name} is {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, expected {shape} {dtype} on {dev}")
    if m < 1:
        raise ValueError("latency_fold: needs at least one op per cluster")
    ins = [x if x.is_contiguous() else x.contiguous() for x in args]
    # the nine outputs are views of one allocation, in register order
    hb = HIST_BUCKETS
    sizes = (hb, p * hb, p, 1, 1, p, 1, 1, 1)
    out = torch.empty((b * sum(sizes),), dtype=torch.int32, device=dev)
    outs, at = [], 0
    for shape, size in zip(_shapes(b, m, p)[6:], sizes):
        outs.append(out[at:at + b * size].view(shape))
        at += b * size
    if b:
        _build.check(_lib().latency_fold_launch(
            *(x.data_ptr() for x in ins), *(y.data_ptr() for y in outs),
            b, m, p, torch.cuda.current_stream(dev).cuda_stream),
            "latency_fold_launch")
        _counted.launches += 1
    return (*outs[:4], tuple(outs[4:]))


latency_fold.launches = 0
# the count lives on the wrapper itself, also while a hook that captures
# the fold's inputs stands in for the module's name
_counted = latency_fold
