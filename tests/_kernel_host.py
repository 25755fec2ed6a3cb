"""K7's and K8's device code built for the host (``tests/kernel_host_emu.cpp``)
with g++. The library has the kernel entries' C signatures, so
``kernels.harvest._launch`` and ``kernels.trace._launch`` drive it as they
drive the card's."""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "madraft_tpu_torch" / "csrc"


def build(out_dir: pathlib.Path) -> ctypes.CDLL:
    """The host library; skips the test when there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code for the host")
    out = out_dir / "libkernel_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-I", str(CSRC), "-o", str(out),
         str(ROOT / "tests" / "kernel_host_emu.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, f"g++ failed:\n{proc.stdout}"
    lib = ctypes.CDLL(str(out))
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
