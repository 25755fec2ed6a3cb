"""K6's device code built for the host (``tests/tick_host_emu.cpp``) with
g++, in the builds ``csrc/tick.cu`` has: the plain one and the metrics,
coverage and service variants (``_build.VARIANTS``' flags; K6-shardkv's
have ``shardkv_chunk_launch`` alone), one g++ a build,
all started together, each built once a run and shared by the run's
workers (``_host_build``). Each library has the kernel entries' C
signatures, so ``kernels.tick._launch`` drives it as it drives the
card's."""

from __future__ import annotations

import ctypes
import pathlib

import _host_build
from madraft_tpu_torch import _build


def _typed(lib):
    if not hasattr(lib, "tick_launch"):  # K6-shardkv's builds
        from madraft_tpu_torch.kernels.shardkv import typed_chunk_lib

        return typed_chunk_lib(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tick_launch.argtypes = [p, p, p, i, p, p, p, p, i, i, i, i, i, i, i,
                                i, p, p, p, i, p, i, p]
    lib.tick_launch.restype = ctypes.c_int
    lib.credit_launch.argtypes = [p, p, p, i, i, i, p]
    lib.credit_launch.restype = ctypes.c_int
    lib.tick_instance.argtypes = [i, i, i]
    lib.tick_instance.restype = ctypes.c_int
    lib.tick_words.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.tick_words.restype = ctypes.c_int
    return lib


def build(out_dir: pathlib.Path, names) -> dict:
    """{name: the host library of that build of tick.cu}; skips the test
    when there is no g++."""
    paths = _host_build.build(out_dir, {
        f"tick_host_{name}": (
            "tick_host_emu.cpp",
            () if name == "tick" else _build.VARIANTS[name][1])
        for name in names})
    return {name: _typed(ctypes.CDLL(str(paths[f"tick_host_{name}"])))
            for name in names}
