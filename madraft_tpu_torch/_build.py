"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at first use; the
library is loaded with ``ctypes``. The file name carries a hash of the
source and of the shared ``csrc/*.cuh`` headers, so an edited kernel never
loads a stale build. ``build_all`` starts
one ``nvcc`` per source at once, which is how ``chip_smoke.py`` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

# the raft verbs' sources, built by the engine's set-up before a run
SOURCES = ("threefry", "oracle", "pack", "metrics", "coverage", "tick",
           "harvest", "trace")
# K9's source (kernels/kv.py kv_tick, the per-tick service kernel, on no
# run's path since K6-kv: a kv run's set-up builds tick_kv or
# tick_metrics_kv, VARIANTS)
KV = "kv"
# K10's source (kernels/ctrler.py ctrler_tick, the per-tick service
# kernel, on no run's path since K6-ctrler: a ctrler run's set-up builds
# tick_ctrler or tick_metrics_ctrler, VARIANTS)
CTRLER = "ctrler"
# K11's source (kernels/shardkv.py shardkv_tick, the per-tick service
# kernel, on no run's path since K6-shardkv: a shardkv run's set-up builds
# tick_shardkv or tick_metrics_shardkv, VARIANTS)
SHARDKV = "shardkv"
# builds of a source with extra flags: name -> (source, flags). K6's
# metrics and coverage variants (kernels/tick.py variant) are built at
# their first use or by the engine's set-up before a run that takes them;
# the profile instances of K6, K6-metrics and K6-coverage (clock64() per
# phase group) are launched or read (their SASS) only by chip_smoke.py
VARIANTS = {
    "tick_metrics": ("tick", ("-DMADRAFT_K6_METRICS",)),
    "tick_coverage": ("tick", ("-DMADRAFT_K6_COVERAGE",)),
    "tick_metrics_coverage": ("tick", ("-DMADRAFT_K6_METRICS",
                                       "-DMADRAFT_K6_COVERAGE")),
    "tick_profile": ("tick", ("-DMADRAFT_K6_PROFILE",)),
    "tick_metrics_profile": ("tick", ("-DMADRAFT_K6_METRICS",
                                      "-DMADRAFT_K6_PROFILE")),
    "tick_coverage_profile": ("tick", ("-DMADRAFT_K6_COVERAGE",
                                       "-DMADRAFT_K6_PROFILE")),
    # K6-kv and K6-metrics-kv (kernels/kv.py kv_chunk): K6 with the kv
    # service tick after each raft tick of a chunk, the builds a kv run's
    # set-up builds
    "tick_kv": ("tick", ("-DMADRAFT_K6_KV",)),
    "tick_metrics_kv": ("tick", ("-DMADRAFT_K6_METRICS", "-DMADRAFT_K6_KV")),
    # K6-ctrler and K6-metrics-ctrler (kernels/ctrler.py ctrler_chunk): K6
    # with the shard controller's service tick after each raft tick of a
    # chunk, the builds a ctrler run's set-up builds
    "tick_ctrler": ("tick", ("-DMADRAFT_K6_CTRLER",)),
    "tick_metrics_ctrler": ("tick", ("-DMADRAFT_K6_METRICS",
                                     "-DMADRAFT_K6_CTRLER")),
    # K6-shardkv and K6-metrics-shardkv (kernels/shardkv.py
    # shardkv_chunk): a deployment a block, its groups' and controller's
    # raft ticks then K11's service tick, each tick of a chunk, the builds
    # a shardkv run's set-up builds
    "tick_shardkv": ("tick", ("-DMADRAFT_K6_SHARDKV",)),
    "tick_metrics_shardkv": ("tick", ("-DMADRAFT_K6_METRICS",
                                      "-DMADRAFT_K6_SHARDKV")),
    # K9-metrics (kernels/kv.py variant): the kv service tick with the
    # clerks' latency folds
    "kv_metrics": ("kv", ("-DMADRAFT_K9_METRICS",)),
    # K9's profile build (clock64() a phase), launched only by chip_smoke.py
    "kv_profile": ("kv", ("-DMADRAFT_K9_PROFILE",)),
    # K10-metrics (kernels/ctrler.py variant): the ctrler service tick with
    # the clerks' latency and phase folds
    "ctrler_metrics": ("ctrler", ("-DMADRAFT_K10_METRICS",)),
    # K10's profile build (clock64() a phase, and the walker's own cycles),
    # launched only by chip_smoke.py
    "ctrler_profile": ("ctrler", ("-DMADRAFT_K10_PROFILE",)),
    # K11-metrics (kernels/shardkv.py variant): the shardkv service tick
    # with the clerks' latency, phase and per-shard / per-client folds
    "shardkv_metrics": ("shardkv", ("-DMADRAFT_K11_METRICS",)),
    # K11's profile build (clock64() a phase, and the truth walker's own
    # cycles), launched only by chip_smoke.py
    "shardkv_profile": ("shardkv", ("-DMADRAFT_K11_PROFILE",)),
}
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built on this machine"
        )
    return path


def _source(name: str) -> tuple:
    return VARIANTS.get(name, (name, ()))


def _target(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha1((CSRC / f"{src}.cu").read_bytes())
    h.update(" ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include one
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    src, flags = _source(name)
    return [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out),
            str(CSRC / f"{src}.cu")]


def build_all(names=SOURCES) -> dict:
    """Compile each of ``names`` (a source or a variant) that has no
    current build, one ``nvcc`` each, all started together. Returns
    {name: seconds} for those it compiled; raises with the compiler's
    output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)  # ptxas's -v report
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all(SOURCES if name in SOURCES else (name,))
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry reported a CUDA error (it returns the value
    of ``cudaGetLastError()`` right after its launch)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def ptxas(name: str) -> dict:
    """What ptxas reported for build ``name`` (built first if needed),
    from the compiler's -v output kept beside the library: the registers
    of each kernel entry, the largest stack frame of any function, and
    the spill stores and loads summed over every function (the entries
    and the functions they call), and [stores, loads] of each function
    that spills."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        _target(name).unlink(missing_ok=True)
        build_all((name,))
    out = {"registers": {}, "stack": 0, "spill_stores": 0, "spill_loads": 0,
           "spills": {}}
    entry = func = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out["stack"] = max(out["stack"], int(m.group(1)))
            out["spill_stores"] += int(m.group(2))
            out["spill_loads"] += int(m.group(3))
            if int(m.group(2)) or int(m.group(3)):
                out["spills"][func] = [int(m.group(2)), int(m.group(3))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out["registers"][entry] = int(m.group(1))
            entry = None
    return out
