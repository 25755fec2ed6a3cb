"""Kernel K3: the packed carry's pack and unpack.

Replaces the JAX reference's ``madraft_tpu/tpusim/state.py``
``pack_state`` / ``unpack_state`` (lines 561-745, vmapped over the lanes):
wide ``ClusterState`` <-> ``PackedClusterState`` over the whole batch, one
launch per direction covering every leaf. Source: ``csrc/pack.cu``, whose
header gives the leaf kinds and the bound.

``pack_state(cfg, s)`` and ``unpack_state(cfg, p)`` run the plain versions
(``state.pack_state`` / ``state.unpack_state``) on CPU tensors; on CUDA
tensors they launch the kernel or raise. Each counts its launches in its
``launches`` attribute. Outputs are fresh tensors, as the reference is pure.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.tpusim import state as st

pack_state_plain = st.pack_state
unpack_state_plain = st.unpack_state

# csrc/pack.cu's codes
_TYPES = {torch.uint8: 0, torch.bool: 0, torch.int8: 1, torch.uint16: 2,
          torch.int16: 3, torch.uint32: 4, torch.int32: 5}
CAST, CMD, REL, BITS1, BITS2 = range(5)
ITEMS_PER_BLOCK = 1024  # csrc/pack.cu kItemsPerBlock


def _kind(packed_name: str) -> int:
    if packed_name == "role_bits":
        return BITS2
    if packed_name.endswith("_bits"):
        return BITS1
    if packed_name.endswith("_rel"):
        return REL
    if packed_name in ("log_val", "shadow_val"):
        return CMD
    return CAST


@functools.lru_cache(maxsize=None)
def _leaves(cfg) -> tuple:
    """Per leaf, in field order: (packed name, kind, wide dtype, wide
    per-lane shape, packed dtype, packed per-lane shape), read off the
    plain versions on one CPU lane, so the kernel's table cannot drift
    from the schema."""
    wide = st.init_cluster(cfg, torch.zeros((1, 2), dtype=torch.int64))
    packed = st.pack_state(cfg, wide)
    return tuple(
        (name, _kind(name), w.dtype, tuple(w.shape[1:]), p.dtype,
         tuple(p.shape[1:]))
        for name, w, p in zip(st.PackedClusterState._fields, wide, packed))


def _lib():
    lib = _build.library("pack")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pack_launch.argtypes = [p, i, i, p, i, ctypes.c_longlong, i, i, p]
        lib.pack_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(cfg, src, to_packed: bool):
    """One launch converting every leaf of ``src`` (a wide state when
    ``to_packed``, else a packed one); returns the fresh other form."""
    leaves = _leaves(cfg.static_key())
    out_type = st.PackedClusterState if to_packed else st.ClusterState
    dev = src.tick.device
    b = src.tick.shape[0]
    outs, ins, rows, blocks = [], [], [], 0
    for (name, kind, wdt, wshape, pdt, pshape), x in zip(leaves, src):
        sdt, sshape, ddt, dshape = ((wdt, wshape, pdt, pshape) if to_packed
                                    else (pdt, pshape, wdt, wshape))
        if x.device != dev or x.dtype != sdt or tuple(x.shape) != (b, *sshape):
            raise ValueError(
                f"{'pack' if to_packed else 'unpack'}_state: {name} is "
                f"{tuple(x.shape)} {x.dtype} on {x.device}, expected "
                f"{(b, *sshape)} {sdt} on {dev}")
        y = torch.empty((b, *dshape), dtype=ddt, device=dev)
        outs.append(y)
        items = y.numel()
        if not items:
            continue
        if items >= 2**31:
            raise ValueError(f"{name}: {items} elements exceed the kernel's "
                             "32-bit item index")
        ins.append(x if x.is_contiguous() else x.contiguous())  # kept alive
        rows.append((ins[-1].data_ptr(), y.data_ptr(), items, items // b,
                     kind, _TYPES[sdt], _TYPES[ddt], blocks))
        blocks += -(-items // ITEMS_PER_BLOCK)
    if rows:
        table = np.asarray(rows, dtype=np.int64)
        tick = ins[0]  # the tick leaf comes first and is never empty
        sp = st.packed_spec(cfg)
        _build.check(_lib().pack_launch(
            table.ctypes.data, len(rows), cfg.n_nodes, tick.data_ptr(),
            _TYPES[tick.dtype], sp.noop_code, blocks, int(to_packed),
            torch.cuda.current_stream(dev).cuda_stream),
            "pack_launch")
    return out_type(*outs), bool(rows)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {x.device}")


def pack_state(cfg, s: st.ClusterState) -> st.PackedClusterState:
    """Wide -> packed: plain version on the CPU, kernel K3 on CUDA."""
    if s.tick.device.type == "cpu":
        return pack_state_plain(cfg, s)
    _check_cuda(s.tick, "pack_state")
    p, launched = _launch(cfg, s, True)
    pack_state.launches += int(launched)
    return p


def unpack_state(cfg, p: st.PackedClusterState) -> st.ClusterState:
    """Packed -> wide: plain version on the CPU, kernel K3 on CUDA."""
    if p.tick.device.type == "cpu":
        return unpack_state_plain(cfg, p)
    _check_cuda(p.tick, "unpack_state")
    s, launched = _launch(cfg, p, False)
    unpack_state.launches += int(launched)
    return s


pack_state.launches = 0
unpack_state.launches = 0
