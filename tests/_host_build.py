"""One host build of the kernels' device code (``tests/*_host_emu.cpp``
with g++) shared by every test module and every xdist worker of a run:
a library is built once into a cache in the run's common base temp
directory, keyed by a hash of its command and of the sources it reads,
under a file lock (the first worker to want a build compiles it, the
others wait for it and load it)."""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "madraft_tpu_torch" / "csrc"
FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread")


def _cache(out_dir: pathlib.Path) -> pathlib.Path:
    """The run's cache: beside the workers' own base temp directories
    under xdist (out_dir is a directory tmp_path_factory made), else in
    the base temp directory."""
    base = pathlib.Path(out_dir).resolve().parent
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    cache = base / "host_builds"
    cache.mkdir(exist_ok=True)
    return cache


def _key(command: list, source: str) -> str:
    h = hashlib.sha1(" ".join(command).encode())
    for path in [ROOT / "tests" / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: pathlib.Path, jobs: dict) -> dict:
    """{name: path of the library} for jobs {name: (tests/<source>, extra
    flags)}, each built unless the run's cache has it, all that this
    worker builds started together; skips the test when there is no
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code for the host")
    cache = _cache(out_dir)
    started, waiting, done = {}, {}, {}
    for name, (source, flags) in jobs.items():
        command = [gxx, *FLAGS, *flags, "-I", str(CSRC),
                   str(ROOT / "tests" / source)]
        target = cache / f"lib{name}-{_key(command, source)}.so"
        lock = open(target.with_suffix(".lock"), "w")
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:  # another worker is building it
            waiting[name] = (target, lock, command)
            continue
        if target.exists():
            lock.close()
            done[name] = target
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        started[name] = (target, lock, tmp, subprocess.Popen(
            [*command, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (target, lock, tmp, proc) in started.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
        os.replace(tmp, target)
        lock.close()
        done[name] = target
    for name, (target, lock, command) in waiting.items():
        fcntl.flock(lock, fcntl.LOCK_EX)  # until the other worker is done
        if not target.exists():  # it failed: build here, for its log
            proc = subprocess.run([*command, "-o", str(target)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            assert proc.returncode == 0, f"g++ failed for {name}:\n{proc.stdout}"
        lock.close()
        done[name] = target
    return done
