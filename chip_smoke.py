#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``madraft_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the CUDA kernels from ``madraft_tpu_torch/csrc`` (one ``nvcc`` per
source, started together), holds every kernel against its plain PyTorch
version (bit-equal), reproduces the golden fuzz legs and the JAX fixture
legs on the card, drives the flagship run (``fuzz --storm --clusters 4096
--ticks 1024``, twice, through the CLI) and checks that it went through the
kernels, then times each kernel beside its plain version and its bound:
``ms`` is the kernel's own device time per launch (torch.profiler, matched
by the CUDA function's name), ``call_ms`` the wrapper's time per call as
the host issues it back to back (CUDA events).

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's ``name, power.limit`` from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero without that last line; it also exits non-zero, printing no
result, when no CUDA card is visible. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FLAGSHIP = ["fuzz", "--storm", "--clusters", "4096", "--ticks", "1024",
            "--seed", "12345", "--check-deterministic"]
FLAGSHIP_RUNS = 2  # --check-deterministic runs the program twice
# H100 SXM peaks (published datasheet figures): HBM bytes/s, and the
# non-tensor-core 32-bit rate (67 TFLOP/s float32), used here for the
# kernels' 32-bit integer operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# 32-bit operations of one threefry2x32 hash: 2 initial key adds, 20 rounds
# of (add, shl, shr, or, xor), 5 key injections of 3 adds, 2 xors for ks[2]
OPS_PER_HASH = 2 + 20 * 5 + 5 * 3 + 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_abs_err(a, b) -> float:
    import torch

    if a.shape != b.shape:
        raise RuntimeError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds of fn() over iters back-to-back calls, by CUDA
    events: the call's time as the host issues it, wrapper included."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, kernel: str, iters: int = 50, warmup: int = 3) -> float:
    """Mean device milliseconds of one launch of the CUDA kernel named
    ``kernel`` over iters calls of fn(i), from torch.profiler's CUPTI
    trace: the kernel's own execution, without the host's issue time or
    any other kernel the wrapper launches."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    name = re.compile(rf"(^|::|\s){re.escape(kernel)}(\(|<|$)")
    hits = [e for e in prof.key_averages() if name.search(e.key)]
    count = sum(e.count for e in hits)
    # CUPTI may drop an activity record now and then; the mean is over
    # the launches it recorded
    check(count >= iters * 9 // 10 and sum(_dev_us(e) for e in hits) > 0,
          f"profiler saw {count} launches of {kernel} over {iters} calls: "
          f"{[e.key[:80] for e in prof.key_averages()][:12]}")
    return sum(_dev_us(e) for e in hits) / count / 1e3


def rotations(nbytes_in: int) -> int:
    """Copies of a kernel's inputs to cycle through so that each launch
    reads its inputs from device memory (the 50 MB L2 cache holds none of
    them), as the bytes bound assumes."""
    return max(1, -(-2 * 50 * 2**20 // max(nbytes_in, 1)))


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def run_cli(argv):
    from madraft_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import oracle as K2
    from madraft_tpu_torch.kernels import threefry as K1
    from madraft_tpu_torch.tpusim import config, engine, prng, state, step

    dev = torch.device("cuda")
    errs = {"threefry_hash_pairs": 0.0, "threefry_tick_blocks": 0.0,
            "oracle": 0.0}
    edges = (1, 2, 1000, 2**20, 2**20 + 7, 2**31 - 1)

    # ---- 1. build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": {k: round(v, 3) for k, v in per_source.items()}})

    # ---- 2. K1 against its plain version, both layouts
    g = torch.Generator().manual_seed(2026)
    keys = torch.randint(0, 2**32, (4096, 2), generator=g, dtype=torch.int64)
    x0 = torch.randint(0, 2**32, (4096, 16), generator=g, dtype=torch.int64)
    x1 = torch.randint(0, 2**32, (4096, 16), generator=g, dtype=torch.int64)
    kd = keys.to(dev)
    for a, b in zip(K1.hash_pairs(kd, x0.to(dev), x1.to(dev)),
                    K1.hash_pairs_plain(kd, x0.to(dev), x1.to(dev))):
        errs["threefry_hash_pairs"] = max(errs["threefry_hash_pairs"], max_abs_err(a, b))
    checked = []
    for flag in (True, False):
        with prng.layout(flag):
            for name, got, want in (
                ("fold_in", prng.fold_in(kd, 2**31 + 5),
                 prng.fold_in(keys, 2**31 + 5)),
                ("split", prng.split(kd, 3), prng.split(keys, 3)),
                ("bits", prng.bits(kd, 133), prng.bits(keys, 133)),
                ("randint", prng.randint(kd, 7, 15, 31),
                 prng.randint(keys, 7, 15, 31)),
            ):
                e = max_abs_err(got.cpu(), want)
                errs["threefry_hash_pairs"] = max(errs["threefry_hash_pairs"], e)
                checked.append((name, flag, e))
        for n_nodes in (5, 7):
            total = step._block_total(n_nodes)
            # one chunk whose clusters start at the edge ticks in turn (the
            # chunks from 2**31 - 1 wrap), then each edge tick alone
            t0 = torch.tensor(edges, dtype=torch.int32).repeat(
                4096 // len(edges) + 1)[:4096].to(dev)
            e = max_abs_err(
                K1.tick_blocks(kd, t0, engine.DRAW_CHUNK, total, flag),
                K1.tick_blocks_plain(kd, t0, engine.DRAW_CHUNK, total, flag))
            errs["threefry_tick_blocks"] = max(errs["threefry_tick_blocks"], e)
            for t in edges:
                tt = torch.full((4096,), t, dtype=torch.int32, device=dev)
                e = max_abs_err(K1.tick_block(kd, tt, total, flag),
                                K1.tick_block_plain(kd, tt, total, flag))
                errs["threefry_tick_blocks"] = max(errs["threefry_tick_blocks"], e)
    check(errs["threefry_hash_pairs"] == 0 and errs["threefry_tick_blocks"] == 0,
          f"threefry kernel differs from its plain version: {errs} {checked}")
    emit({"phase": "k1_vs_plain", "layouts": ["partitionable", "legacy"],
          "n_nodes": [5, 7], "chunk_ticks": engine.DRAW_CHUNK,
          "max_abs_err": max(errs["threefry_hash_pairs"],
                             errs["threefry_tick_blocks"])})

    # ---- 3. K2 against its plain version: storm states and planted ones
    storm = config.storm_profiles()["storm"][0]
    ck = engine.cluster_keys(7, 512, dev)
    kn = storm.knobs(dev)
    s = state.init_cluster(storm, ck, kn)
    for _ in range(150):
        s = step.step_cluster(storm, s, ck, kn)
    h = state.state_to_numpy(s)
    planted, want_bits = _plant(h)

    for label, src in (("storm", h), ("planted", planted)):
        st = state.state_from_numpy(src, dev)
        got = K2.oracle(*oracle_args(st))
        want = K2.oracle_plain(*oracle_args(st))
        check(len(got) == len(want) == 9, "oracle returns 9 outputs")
        for a, b in zip(got, want):
            errs["oracle"] = max(errs["oracle"], max_abs_err(a, b))
        if label == "planted":
            v, fvt = got[0].cpu().tolist(), got[7].cpu().tolist()
            t = int(src["tick"][0]) + 1
            missed = {c: bit for c, bit in want_bits.items()
                      if not v[c] & bit or fvt[c] != t}
            check(not missed, f"planted violations not flagged: {missed}")
    check(errs["oracle"] == 0, f"oracle kernel differs from plain: {errs['oracle']}")
    emit({"phase": "k2_vs_plain", "states": ["storm@150", "planted"],
          "clusters": 512, "max_abs_err": errs["oracle"]})

    # ---- 4. golden legs (legacy layout, as recorded)
    golden = json.loads((ROOT / "tests" / "golden_fuzz.json").read_text())
    with prng.layout(False):
        for leg in ("clean", "bug"):
            rec = golden[leg]["report"]
            rc, out = run_cli(golden[leg]["argv"])
            bad = {k: (out.get(k), v) for k, v in rec.items() if out.get(k) != v}
            check(not bad, f"golden {leg} leg differs: {bad}")
            check(rc == (1 if rec["violating"] else 0), f"golden {leg} rc {rc}")
            emit({"phase": f"golden_{leg}", "match": True, "rc": rc,
                  "violating": out["violating"]})

    # ---- 5. JAX fixture legs (default layout), per-cluster bit-equal
    fixture = json.loads(
        (ROOT / "tests" / "torch_fixtures" / "fuzz_legs.json").read_text())
    with prng.layout(fixture["partitionable"]):
        for leg, rec in fixture["legs"].items():
            cfg = config.storm_profiles()[rec["profile"]][0].replace(bug=rec["bug"])
            rep = engine.fuzz(cfg, rec["seed"], fixture["n_clusters"],
                              fixture["n_ticks"], device=dev)
            for f, want in rec["report"].items():
                check(getattr(rep, f).tolist() == want,
                      f"fixture leg {leg}: field {f} differs")
            emit({"phase": f"fixture_{leg}", "match": True,
                  "violating": rep.n_violating})

    # ---- 6. the flagship, through the CLI, counting kernel launches
    for fn in (K1.hash_pairs, K1.tick_blocks, K2.oracle):
        fn.launches = 0
    prng.set_partitionable(True)
    t0 = time.perf_counter()
    rc, out = run_cli(FLAGSHIP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"threefry_hash_pairs": K1.hash_pairs.launches,
                "threefry_tick_blocks": K1.tick_blocks.launches,
                "oracle": K2.oracle.launches}
    ticks = 1024 * FLAGSHIP_RUNS
    chunks = -(-1024 // engine.DRAW_CHUNK) * FLAGSHIP_RUNS
    check(rc == 0 and out["violating"] == 0, f"flagship rc {rc}: {out}")
    check(out.get("deterministic") is True, "flagship double run differs")
    check(out["first_leader_tick_mean"] > 0 and out["committed_mean"] > 0,
          f"flagship made no progress: {out}")
    check(launches["threefry_tick_blocks"] == chunks
          and launches["oracle"] == ticks and launches["threefry_hash_pairs"] > 0,
          f"flagship launches {launches}, want {chunks} tick_blocks (one per "
          f"chunk of {engine.DRAW_CHUNK} ticks) and {ticks} oracle")
    tele = out["telemetry"]
    emit({"phase": "flagship", "argv": FLAGSHIP, "rc": rc,
          "cluster_steps_per_s": tele["steps_per_sec"],
          "execute_s": tele["execute_s"], "wall_s_both_runs": round(wall, 3),
          "launches": launches, "committed_mean": out["committed_mean"],
          "first_leader_tick_mean": out["first_leader_tick_mean"],
          "bytes_per_lane": tele["bytes_per_lane"]})

    # ---- 7. kernel timing at the flagship shapes
    b, n_nodes = 4096, 5
    total = step._block_total(n_nodes)
    fk = engine.cluster_keys(12345, b, dev)
    fkn = _storm_cfg().knobs(dev)
    fs = state.init_cluster(_storm_cfg(), fk, fkn)
    for _ in range(200):
        fs = step.step_cluster(_storm_cfg(), fs, fk, fkn)
    tt, chunk = fs.tick + 1, engine.DRAW_CHUNK
    hp_x = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    hp_k, hp_z = fk, torch.zeros_like(hp_x)
    args2 = oracle_args(fs)
    for a, bb in zip(K2.oracle(*args2), K2.oracle_plain(*args2)):
        errs["oracle"] = max(errs["oracle"], max_abs_err(a, bb))
    check(errs["oracle"] == 0, "oracle kernel differs at the flagship shape")
    k2_out = K2.oracle(*args2)
    counts = {fn: fn.launches for fn in (K1.hash_pairs, K1.tick_blocks, K2.oracle)}
    k2_rot = [args2] + [tuple(x.clone() for x in args2)
                        for _ in range(rotations(nbytes(*args2)) - 1)]

    def k2_call(i):
        return K2.oracle(*k2_rot[i % len(k2_rot)])

    def k2_plain(i):
        return K2.oracle_plain(*k2_rot[i % len(k2_rot)])

    # name: (device ms, call ms, plain ms, bytes, operations)
    timing = {
        # one chunk: [chunk, b, total] int64 words, b * chunk rows of 2
        # key folds and total hashes (partitionable layout) each
        "threefry_tick_blocks": (
            device_ms(lambda i: K1.tick_blocks(fk, tt, chunk, total, True),
                      "tick_blocks_kernel"),
            cuda_ms(lambda i: K1.tick_blocks(fk, tt, chunk, total, True)),
            cuda_ms(lambda i: K1.tick_blocks_plain(fk, tt, chunk, total, True),
                    iters=5, warmup=1),
            nbytes(fk, tt) + chunk * b * total * 8,
            chunk * b * ((2 + total) * OPS_PER_HASH + total)),
        "threefry_hash_pairs": (
            device_ms(lambda i: K1.hash_pairs(hp_k, hp_z, hp_x),
                      "hash_pairs_kernel"),
            cuda_ms(lambda i: K1.hash_pairs(hp_k, hp_z, hp_x)),
            cuda_ms(lambda i: K1.hash_pairs_plain(hp_k, hp_z, hp_x), iters=20),
            nbytes(hp_k.to(torch.int32)) + 4 * b * n_nodes * 4,
            b * n_nodes * OPS_PER_HASH),
        "oracle": (
            device_ms(k2_call, "oracle_kernel"),
            cuda_ms(k2_call),
            cuda_ms(k2_plain, iters=20),
            nbytes(*args2) + nbytes(*k2_out),
            # per cluster: n(n-1)/2 pairs x cap lanes x ~8 ops (log
            # matching), n x cap x ~12 (shadow walk), cap x ~10 (slide)
            b * (n_nodes * (n_nodes - 1) // 2 * 64 * 8 + n_nodes * 64 * 12
                 + 64 * 10)),
    }
    del k2_rot
    for fn, c in counts.items():  # timing launches are not main-path launches
        fn.launches = c
    emit({"phase": "timing", "clusters": b, "device_ms_from": "torch.profiler",
          "l2_cold_rotations": {"oracle": rotations(nbytes(*args2))},
          "shapes": {"tick_blocks": [chunk, b, total], "hash_pairs": [b, n_nodes],
                     "oracle_logs": [b, n_nodes, 64]}})

    # ---- 8. where a flagship tick's time goes (torch.profiler, one chunk)
    emit(_profile_ticks(fs, fk, fkn, chunk))

    sources = {
        "threefry_tick_blocks": ("madraft_tpu_torch/csrc/threefry.cu",
                                 "madraft_tpu/tpusim/step.py:128"),
        "threefry_hash_pairs": ("madraft_tpu_torch/csrc/threefry.cu",
                                "madraft_tpu/tpusim/engine.py:95"),
        "oracle": ("madraft_tpu_torch/csrc/oracle.cu",
                   "madraft_tpu/tpusim/step.py:961"),
    }
    rows = []
    for name, (ms, call_ms, plain_ms, nb, ops) in timing.items():
        t_bytes = nb / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    emit({"kernels": rows})

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: not available", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def oracle_args(st):
    """K2's inputs from a state: the state itself stands in for the
    mid-tick values, and the tick is st.tick + 1."""
    return (st.alive, st.role, st.term, st.log_term, st.log_val, st.log_len,
            st.base, st.commit, st.prefix_hash, st.shadow_term, st.shadow_val,
            st.shadow_base, st.shadow_len, st.shadow_prefix_hash,
            st.violations, st.first_violation_tick, st.first_leader_tick,
            st.tick + 1)


def _plant(h: dict):
    """Copy of a host state with one divergence planted per cluster:
    two live leaders in a term, a log-matching break, a changed committed
    entry, equal snapshot boundaries with different prefix hashes. Returns
    (state, {cluster: expected violation bit})."""
    p = {k: v.copy() for k, v in h.items()}
    cap = p["log_term"].shape[-1]
    n_clusters = p["log_term"].shape[0]
    want = {}
    p["alive"][:] = True
    p["violations"][:] = 0
    p["first_violation_tick"][:] = -1
    p["role"][0, :2] = 2
    p["term"][0, 1] = p["term"][0, 0]
    want[0] = 1
    free = list(range(1, n_clusters))
    for c in free:  # node 1 copies node 0's log, last value changed
        last = int(p["log_len"][c, 0])
        if last > int(p["base"][c, 0]):
            for f in ("log_term", "log_val", "log_len", "base"):
                p[f][c, 1] = p[f][c, 0]
            p["log_val"][c, 1, (last - 1) % cap] ^= 0x5A5A
            want[c] = 2
            break
    for c in (c for c in free if c not in want):  # a committed entry changes
        lo = max(int(p["base"][c, 0]), int(p["shadow_base"][c]))
        hi = min(int(p["commit"][c, 0]), int(p["shadow_len"][c]),
                 int(p["log_len"][c, 0]))
        if hi > lo:
            p["log_val"][c, 0, (hi - 1) % cap] ^= 0x5A5A
            want[c] = 4
            break
    c = next(c for c in free if c not in want)  # prefix hashes disagree
    p["base"][c, :2] = max(int(p["base"][c, 0]), 1)
    p["prefix_hash"][c, 1] = p["prefix_hash"][c, 0] ^ 1
    want[c] = 512
    check(sorted(want.values()) == [1, 2, 4, 512], f"could not plant: {want}")
    return p, want


def _profile_ticks(s, keys, kn, n_ticks: int) -> dict:
    """Wall time per flagship tick, the card's busy share over it, the
    kernels launched per tick, and the five kernels with the most device
    time, from torch.profiler, over one chunk of n_ticks ticks drawn as the
    engine draws them. Kernel launches here go to the counters' saved
    values afterwards, like the timing phase's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from madraft_tpu_torch.kernels import oracle as K2
    from madraft_tpu_torch.kernels import threefry as K1
    from madraft_tpu_torch.tpusim import prng, step

    counts = {fn: fn.launches for fn in (K1.hash_pairs, K1.tick_blocks, K2.oracle)}
    cfg = _storm_cfg()
    total = step._block_total(cfg.n_nodes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        words = K1.tick_blocks(keys, s.tick + 1, n_ticks, total,
                               prng.partitionable())
        for i in range(n_ticks):
            s = step.step_cluster(cfg, s, keys, kn, words=words[i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for fn, c in counts.items():
        fn.launches = c

    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", "")) and _dev_us(e) > 0]
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:5]
    return {
        "phase": "profile", "ticks": n_ticks, "clusters": int(s.tick.shape[0]),
        "wall_ms_per_tick": wall_ms / n_ticks,
        "device_busy_ms_per_tick": busy_ms / n_ticks if kernels else None,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "device_ops_per_tick": sum(e.count for e in kernels) / n_ticks,
        "top_device_ms_per_tick": {
            e.key[:60]: _dev_us(e) / 1e3 / n_ticks for e in top},
    }


def _storm_cfg():
    """The flagship's config: --storm on the default 5-node SimConfig."""
    from madraft_tpu_torch.__main__ import _storm
    from madraft_tpu_torch.tpusim.config import SimConfig

    return _storm(SimConfig())


if __name__ == "__main__":
    sys.exit(main())
