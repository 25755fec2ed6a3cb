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
kernel or raises. ``seen_update.launches`` counts launches.
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
