"""K6's device code built for the host (``tests/tick_host_emu.cpp``) with
g++, in the builds ``csrc/tick.cu`` has: the plain one and the metrics and
coverage variants (``_build.VARIANTS``' flags), one g++ a build, all
started together. Each library has the kernel entries' C signatures, so
``kernels.tick._launch`` drives it as it drives the card's."""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import pytest

from madraft_tpu_torch import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "madraft_tpu_torch" / "csrc"


def _typed(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tick_launch.argtypes = [p, p, p, i, p, p, p, p, i, i, i, i, i, i, i,
                                i, p, p, p, i, p]
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
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    jobs = {}
    for name in names:
        flags = () if name == "tick" else _build.VARIANTS[name][1]
        out = out_dir / f"lib{name}_host.so"
        jobs[name] = (out, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", *flags, "-I", str(CSRC), "-o", str(out),
             str(ROOT / "tests" / "tick_host_emu.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
        libs[name] = _typed(ctypes.CDLL(str(out)))
    return libs
