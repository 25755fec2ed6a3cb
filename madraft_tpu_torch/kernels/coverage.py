"""Kernel K5: the coverage fingerprint and seen-set update.

Replaces the JAX reference's ``madraft_tpu/tpusim/coverage.py``
``abstract_code``, ``_fold_code``, ``_mix32`` and ``bitmap_index`` (lines
100-180) and the seen-set update of its coverage chunks (``engine.py``
1342-1361, sharded 1429-1446): one launch a tick, after the step, folds
every lane's abstract-state code and stamps its seen-set bit. Source:
``csrc/coverage.cu``, whose header gives the bound and the design.

Shapes: ``role``, ``term``, ``commit`` [B, n] int32 and ``alive`` [B, n]
bool (the post-step node rows), ``violations`` [B] int32, ``rows`` [B]
int32 (the seen-set row of each lane) or None (row 0), ``seen`` [R, bits]
int32 first-tick stamps (``coverage.UNSEEN`` = unset), ``new_fps`` [B]
int32 credits, ``t`` the pool's run-wide tick. ``seen`` and ``new_fps``
are updated in place and returned.

On CPU tensors ``seen_update`` runs the plain version
(``tpusim.coverage.seen_update_plain``); on CUDA tensors it launches the
kernel or raises. ``seen_update.launches`` counts launches. On the K6
route the fingerprint runs inside the tick (``kernels.tick``'s coverage
variant), so ``seen_update`` serves the eager tick only.

``credit_pass`` is the second launch after a K6-coverage chunk: from the
chunk's flat seen indices ``fp`` [m, B] (-1: a violated lane-tick) and the
stamps the chunk left, it credits lane-tick (b, i) iff ``seen`` holds its
own run-wide tick ``t0 + i`` at its bit (``credit_plain``, the plain
version; the kernel is ``credit_kernel`` in ``csrc/tick.cu``, which the
note there bounds). ``credit_pass.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim.config import CoverageConfig
from madraft_tpu_torch.tpusim.coverage import (
    UNSEEN,
    identity_mapped,
    node_alphabet,
    seen_update_plain,
)

MAX_NODES = 16  # csrc/coverage.cu kMaxNodes


def _lib():
    lib = _build.library("coverage")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seen_update_launch.argtypes = (
            [p] * 8 + [i, i, i, i, ctypes.c_uint, i, i, i, p])
        lib.seen_update_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def seen_update(ccfg: CoverageConfig, role, alive, term, commit, violations,
                rows, seen, new_fps, t: int):
    """One tick's fingerprints into the seen-set: the plain version on the
    CPU, kernel K5 on CUDA."""
    dev = role.device
    named = {"role": role, "alive": alive, "term": term, "commit": commit,
             "violations": violations, "seen": seen, "new_fps": new_fps}
    if rows is not None:
        named["rows"] = rows
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"seen_update: {name} is on {x.device}, role "
                             f"on {dev}")
    if not 0 <= t < UNSEEN:
        raise ValueError(f"seen_update: tick {t} outside [0, {UNSEEN})")
    if dev.type == "cpu":
        return seen_update_plain(ccfg, role, alive, term, commit, violations,
                                 rows, seen, new_fps, t)
    b, n = role.shape
    want = {"role": ((b, n), torch.int32), "alive": ((b, n), torch.bool),
            "term": ((b, n), torch.int32), "commit": ((b, n), torch.int32),
            "violations": ((b,), torch.int32),
            "seen": ((seen.shape[0], ccfg.bitmap_bits), torch.int32),
            "new_fps": ((b,), torch.int32), "rows": ((b,), torch.int32)}
    for name, x in named.items():
        shape, dtype = want[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"seen_update: {name} is {tuple(x.shape)} {x.dtype}, "
                f"expected {shape} {dtype}")
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"seen_update: {n} nodes, the kernel takes 1.."
                         f"{MAX_NODES}")
    if not (seen.is_contiguous() and new_fps.is_contiguous()):
        raise ValueError("seen_update: seen and new_fps are updated in "
                         "place and must be contiguous")
    ins = [x.contiguous() for x in (role, alive, term, commit, violations)]
    rows = None if rows is None else rows.contiguous()
    if b:
        _build.check(_lib().seen_update_launch(
            *(x.data_ptr() for x in ins),
            None if rows is None else rows.data_ptr(),
            seen.data_ptr(), new_fps.data_ptr(), b, n,
            ccfg.term_rank_levels, ccfg.commit_delta_levels,
            node_alphabet(ccfg) & 0xFFFFFFFF, ccfg.bitmap_bits,
            int(identity_mapped(n, ccfg)), int(t),
            torch.cuda.current_stream(dev).cuda_stream),
            "seen_update_launch")
        _counted.launches += 1
    return seen, new_fps


seen_update.launches = 0
# the count lives on the wrapper itself, also while a hook that captures
# the update's inputs stands in for the module's name
_counted = seen_update


def credit_plain(fp, seen, new_fps, t0: int):
    """The credit pass's plain version: ``new_fps`` [B] += the lane-ticks
    (b, i) of ``fp`` [m, B] whose flat index f >= 0 has ``seen.view(-1)[f]
    == t0 + i``. Updates ``new_fps`` in place and returns it."""
    m = fp.shape[0]
    ticks = t0 + torch.arange(m, dtype=torch.int32, device=fp.device)
    stamped = seen.view(-1)[fp.clamp(min=0).to(torch.int64)]
    hit = (fp >= 0) & (stamped == ticks[:, None])
    new_fps += hit.sum(0, dtype=torch.int32)
    return new_fps


def credit_pass(fp, seen, new_fps, t0: int, lib=None):
    """The credits of a K6-coverage chunk: the plain version on the CPU,
    the credit kernel of ``lib`` (a build of ``csrc/tick.cu``; the coverage
    variant's by default) on CUDA."""
    dev = fp.device
    for name, x in (("seen", seen), ("new_fps", new_fps)):
        if x.device != dev:
            raise ValueError(f"credit_pass: {name} is on {x.device}, fp on "
                             f"{dev}")
    if dev.type == "cpu":
        return credit_plain(fp, seen, new_fps, t0)
    m, b = fp.shape
    for name, x in (("fp", fp), ("seen", seen), ("new_fps", new_fps)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"credit_pass: {name} must be contiguous int32, "
                             f"got {x.dtype}")
    if tuple(new_fps.shape) != (b,):
        raise ValueError(f"credit_pass: new_fps is {tuple(new_fps.shape)}, "
                         f"expected ({b},)")
    if b and m:
        if lib is None:
            from madraft_tpu_torch.kernels import tick as K6

            lib = K6._lib(K6.variant(False, True))
        _build.check(lib.credit_launch(
            fp.data_ptr(), seen.data_ptr(), new_fps.data_ptr(), b, m, int(t0),
            torch.cuda.current_stream(dev).cuda_stream), "credit_launch")
        credit_pass.launches += 1
    return new_fps


credit_pass.launches = 0
