"""K7's and K8's device code built for the host (``tests/kernel_host_emu.cpp``)
with g++, K9's (``tests/kv_host_emu.cpp``, ``build_kv``), K10's
(``tests/ctrler_host_emu.cpp``, ``build_ctrler``) and K11's
(``tests/shardkv_host_emu.cpp``, ``build_shardkv``). The libraries have
the kernel entries' C signatures, so ``kernels.harvest._launch``,
``kernels.trace._launch``, ``kernels.kv._launch``,
``kernels.ctrler._launch`` and ``kernels.shardkv._launch`` drive them as
they drive the card's."""

from __future__ import annotations

import ctypes
import pathlib

import torch

import _host_build


def _compile(source: str, out: pathlib.Path, flags=()) -> ctypes.CDLL:
    """g++ of tests/<source> as the shared library named like ``out`` (in
    the run's cache: built once a run, ``_host_build``), loaded; skips the
    test when there is no g++."""
    path = _host_build.build(out.parent, {out.stem: (source, tuple(flags))})
    return ctypes.CDLL(str(path[out.stem]))


def build(out_dir: pathlib.Path) -> ctypes.CDLL:
    """K7's and K8's host library."""
    lib = _compile("kernel_host_emu.cpp", out_dir / "libkernel_host.so")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.harvest_launch.argtypes = [p, i, p, p]
    lib.harvest_launch.restype = i
    lib.refill_grid_launch.argtypes = [p, p, p, i, p]
    lib.refill_grid_launch.restype = i
    lib.record_launch.argtypes = [p, i, p]
    lib.record_launch.restype = i
    lib.harvest_host_threads.argtypes = [i]
    lib.harvest_host_threads.restype = None
    return lib


def build_kv(out_dir: pathlib.Path, metrics: bool) -> ctypes.CDLL:
    """K9's host library, its metrics build with ``metrics``."""
    name = "kv_metrics" if metrics else "kv"
    lib = _compile("kv_host_emu.cpp", out_dir / f"lib{name}_host.so",
                   ["-DMADRAFT_K9_METRICS"] if metrics else [])
    lib.kv_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.kv_launch.restype = ctypes.c_int
    return lib


def build_ctrler(out_dir: pathlib.Path, metrics: bool) -> ctypes.CDLL:
    """K10's host library, its metrics build with ``metrics``."""
    name = "ctrler_metrics" if metrics else "ctrler"
    lib = _compile("ctrler_host_emu.cpp", out_dir / f"lib{name}_host.so",
                   ["-DMADRAFT_K10_METRICS"] if metrics else [])
    lib.ctrler_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.ctrler_launch.restype = ctypes.c_int
    return lib


def build_shardkv(out_dir: pathlib.Path, metrics: bool) -> ctypes.CDLL:
    """K11's host library, its metrics build with ``metrics``."""
    name = "shardkv_metrics" if metrics else "shardkv"
    lib = _compile("shardkv_host_emu.cpp", out_dir / f"lib{name}_host.so",
                   ["-DMADRAFT_K11_METRICS"] if metrics else [])
    lib.shardkv_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.shardkv_launch.restype = ctypes.c_int
    return lib


def misaligned(x):
    """x (a tensor or a nested tuple of them) copied into views one element
    past a fresh allocation: a 4-byte leaf's rows start 4 bytes off a
    16-byte boundary (no row moves as a staging bulk row and the log rows
    move in words, csrc/stage.cuh), a byte leaf's one byte off."""
    if isinstance(x, tuple):
        return type(x)(*(misaligned(y) for y in x))
    if not isinstance(x, torch.Tensor):
        return x
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y
