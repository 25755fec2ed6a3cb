#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``madraft_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the CUDA kernels from ``madraft_tpu_torch/csrc`` (one ``nvcc`` per
source, and one for each of K6's builds: metrics, coverage, both, profile,
started together), holds every kernel against its plain PyTorch version
(bit-equal; K6, the tick with its draws, on every leaf after every chunk
at n = 3, 5, 7 under every planted bug, with [B] knob rows, ragged chunks,
a pool state at mixed lane ticks, every template instance and the runtime
one under both threefry layouts, and ticks across the int32 and u32
wraps; K6-metrics, the tick with the metrics plane, on every leaf with the
metric leaves, every instance, both layouts, the wraps and planted metric
leaves; K6-coverage and its credit pass on the seen-set stamps and the
credits, one row, shard rows, the identity map, violated lanes and with
metrics), reproduces the golden fuzz and pool legs and the JAX fixture
legs on the card, drives the main paths through the CLI and checks that
each went through its kernels: the fuzz flagship (``fuzz --storm
--clusters 4096 --ticks 1024``, twice) and the pool flagship (``pool
--storm --clusters 4096 --ticks 512 --budget-ticks 1024``, twice), both K6
launches of up to 256 ticks and no draw launch, each again with
``--metrics`` at half the depth (K6-metrics: no K4, K2 or draw launch), the
coverage pool flagship (the pool flagship with ``--coverage``, twice:
K6-coverage and a credit pass a chunk, no K5 launch, the biased refill)
and the sweep flagships (``sweep --storm`` at 4096 clusters x 1024 ticks
on the CLI's default 12-cell grid, the per-cluster dispatch, and on an
8-cell grid, the uniform dispatch, again forced per-cluster), replays pool
hits and mutated coverage rows through ``replay``, runs the fuzz flagship,
the metrics fuzz flagship and the coverage pool flagship through the eager
tick (K1's draw chunks, K2, K2-metrics, K4, K5: the eager route's kernels)
and through K6 in turns (the pool's harvests through K7 and through its
plain version), runs the nine raft-layer game-day gates with metrics on,
holds K7, the pool harvest, against its plain version on planted batches
(every output, both id schemes, plain and coverage refills, metrics on and
off, both threefry layouts) and through the engine at the flagship's
shape, packed and wide, and its refill grid against the CPU twin's
SHA-256; drives ``explain`` on a planted-bug cluster (K6-trace: one K6
launch writes the 200 ticks' trace rows, no K8 launch) and holds
K6-trace's rows and K8's against the plain version's at every tick of a
storm and a bug cluster, metrics on and off; holds K9,
the kv service tick, and K9-metrics against their plain version on every
leaf after every tick (phase ``kv_k9``: n = 3, 5, 7, every kv bug, Puts,
hints with ``retry_wait``, the open loop with the Zipf key, [B] knob rows
mixing the bugs, states at mixed ticks, 32 clients and 64 keys, both
layouts, 1100 clusters; K9 is off the path since K6-kv), K6-kv and
K6-metrics-kv, K6 with the kv service tick after each raft tick of a
chunk, against the plain route on every leaf after every launch, a short
last one included (phase ``kv_k6kv``: the kv flagship's batch at tick 200
and K9's cases, with ptxas's report of both builds), and K10, the shard
controller's service tick,
and K10-metrics the same way (phase ``ctrler_k10``: n = 3, 5, 7, each
planted controller bug, 2 and 10 gids, one and three gids an op, a
history that fills, [B] knob rows mixing the bugs, states at mixed ticks,
32 clients, both layouts; K10 is off the path since K6-ctrler),
K6-ctrler and K6-metrics-ctrler, K6 with the shard controller's service
tick after each raft tick of a chunk, against the plain route on every
leaf after every launch (phase ``ctrler_k6ctrler``: the ctrler flagship's
batch at tick 200 and K10's cases, with ptxas's report of both builds
and a launch on their (5, 32) instance beside the runtime one),
drives the kv flagship (``kv-fuzz --storm --clusters 1024 --ticks 512``,
twice, then with ``--metrics``: K6-kv once a 256-tick chunk, no K6, K9,
draw chunk, K2, K4 or K5, the report equal to the eager route's at the
same depth and, over 32 ticks, to the CPU route's) and its
eager-vs-kernel A/B (``kv_ab``), the ctrler flagship
(``ctrler-fuzz --storm --clusters 1024 --ticks 512``, twice, then with
``--metrics``: K6-ctrler once a 256-tick chunk, no K6, K10, draw chunk,
K2, K4 or K5, the report equal to the eager route's at the same depth
and, over 32 ticks, to the CPU route's), the sweep's knob rows and a
replay on K6-ctrler (``ctrler_sweep_replay``) and its A/B
(``ctrler_ab``), holds
K11, the shardkv service tick, and K11-metrics against their plain version
(phase ``shardkv_k11``: the schedule mode's cases as [B] rows; phase
``shardkv_ctrl_k11``: the live and computed controller modes with their
bugs as rows, and an edge batch with the controller walker's planted
stall), holds K6-shardkv and K6-metrics-shardkv against the plain route
in each mode (phase ``shardkv_k6shardkv``), drives the shardkv flagship
(``shardkv-fuzz --storm --clusters 1024 --ticks 512``, twice, then with
``--metrics``: K6-shardkv once a 256-tick chunk, no K6 or K11, the report
equal to the eager route's at 64 ticks (the whole flagship's in
``tests/test_torch_cuda.py``) and, at 32 x 16, to the CPU route's) and
the same with
``--live-ctrler`` and with
``--computed-ctrler``, each with its A/B, runs the ``hot_key_openloop``
gate as a kv leg beside the raft gates, then
times each kernel beside its plain version and its bound: ``ms`` is the kernel's own device time per launch (torch.profiler,
matched by the CUDA function's name), ``call_ms`` the wrapper's time per
call as the host issues it back to back (CUDA events); ``share`` is the
bound over ``ms``, the bound the larger of the bytes over the HBM rate and
the 32-bit operations over the card's integer rate (phase ``card``). K6's
clock64() split by phase group (``k6_phases``, its profile build) and its
time as the warps an SM grow (``k6_scaling``) follow, K9's clock64()
split by phase (``kv_phases``, its profile build) and the kv tick's on
K6-kv (``profile_kv_tick``), the ctrler tick's on K6-ctrler
(``profile_ctrler_tick``) and the shardkv tick's on K6-shardkv in each
mode (``profile_shardkv_tick[_live|_computed]``);
``k6_metrics_phases`` gives K6-metrics' split, grid, waves and ms a launch
at 4096 clusters and at one wave, and ptxas's report of every K6 build;
``k6_only()`` runs just those three K6 phases, ``--k6-leg`` one leg of
an A/B of K6's builds between two trees, and ``--kv-leg`` one leg of an
A/B of the kv path (K6's builds, K9, K6-kv where the tree has it, the kv
flagships' wall a tick), ``--ctrler-leg`` one leg of an A/B of the ctrler
path (K6's builds, K6-kv, K10, K6-ctrler where the tree has it, the
ctrler flagships' wall a tick), ``--shardkv-leg`` one leg of an A/B of the
shardkv path (K6's builds, K6-kv, K6-ctrler, K11, K6-shardkv where the
tree has it, the three shardkv flagships' wall a tick).

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's ``name, power.limit`` from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero without that last line; it also exits non-zero, printing no
result, when no CUDA card is visible. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
FLAGSHIP = ["fuzz", "--storm", "--clusters", "4096", "--ticks", "1024",
            "--seed", "12345", "--check-deterministic"]
FLAGSHIP_RUNS = 2  # --check-deterministic runs the program twice
POOL_FLAGSHIP = ["pool", "--storm", "--clusters", "4096", "--ticks", "512",
                 "--budget-ticks", "1024", "--seed", "12345"]
# the metrics flagships at half the depth (the script's time): the fuzz
# flagship's first 512 ticks, the pool flagship's first horizon
METRICS_TICKS = 512
METRICS_FLAGSHIP = ["fuzz", "--storm", "--clusters", "4096", "--ticks",
                    str(METRICS_TICKS), "--seed", "12345",
                    "--check-deterministic", "--metrics"]
METRICS_POOL_FLAGSHIP = ["pool", "--storm", "--clusters", "4096", "--ticks",
                         "512", "--budget-ticks", "512", "--seed", "12345",
                         "--metrics"]
COVERAGE_POOL_FLAGSHIP = POOL_FLAGSHIP + ["--coverage"]
# the CLI's default grid (12 cells: the per-cluster dispatch) and an 8-cell
# grid (at most engine.SWEEP_UNIFORM_MAX_CELLS: the uniform dispatch)
SWEEP_FLAGSHIP = ["sweep", "--storm", "--clusters", "4096", "--ticks", "1024",
                  "--seed", "12345"]
SWEEP_UNIFORM_FLAGSHIP = SWEEP_FLAGSHIP + [
    "--loss", "0,0.1", "--crash", "0,0.01", "--repartition", "0,0.02"]
# mutated coverage rows replayed through the CLI
REPLAY_MUTATED = 3
# explain's main path: a planted-bug cluster whose first violation lands at
# tick 87 (the durability profile's ack_before_fsync, seed 5, cluster 32),
# traced for EXPLAIN_TICKS ticks; the storm cluster K8 is also held on
EXPLAIN_TICKS = 200
EXPLAIN = ["explain", "--profile", "durability", "--bug", "ack_before_fsync",
           "--seed", "5", "--cluster", "32", "--ticks", str(EXPLAIN_TICKS)]
EXPLAIN_FVT = 87
EXPLAIN_STORM = ("storm", "", 12345, 5)
# ticks of each K6-vs-plain case (phase tick_chunk), and of each case that
# holds a template instance under one threefry layout (cut from 256 and
# 128 to hold the script's time as it grew: five and two chunks of 32)
K6_TICKS = 160
K6_SHAPE_TICKS = 64
# the device operations of one packed pool harvest: K7's scan and lane
# kernels, K3's pack and the snapshot's copy to the host
HARVEST_OPS = ("ids_kernel", "lane_kernel", "pack_kernel", "Memcpy DtoH")
# the eager runs of the fuzz flagship's eager-vs-K6 A/B, cut to hold the
# script's time (the eager tick is host-bound, its rate flat in depth), and
# the eager tick's profiled windows (phases profile, profile_metrics,
# profile_coverage)
AB_EAGER_TICKS = 128
EAGER_PROFILE_TICKS = 16
# the report keys the metrics plane adds
METRIC_KEYS = ("latency", "events", "worst_op")
# the kv flagship's eager-vs-kernel A/B: the four runs' depth (the eager
# route is host-bound, about 30 ms a tick at 1024 clusters, its rate flat
# in depth)
KV_AB_TICKS = 32
# the kv flagship's batch on the CPU route beside K6-kv: its depth (the
# CPU route takes about 0.3-0.5 s a tick at 1024 clusters)
KV_CPU_TICKS = 32
# K6-kv against the plain route (phase kv_k6kv): each comparison's
# launches (ticks; a short last one) and the cases' clusters (past a whole
# number of two-cluster warps)
KV_K6KV_LAUNCHES = (16, 1, 7)
KV_K6KV_CLUSTERS = 301
# the kv flagship (bench.py's kv row at the flagship's depth), twice, and
# with the metrics plane
KV_FLAGSHIP = ["kv-fuzz", "--storm", "--clusters", "1024", "--ticks", "512",
               "--seed", "12345", "--check-deterministic"]
KV_METRICS_FLAGSHIP = KV_FLAGSHIP + ["--metrics"]
# K9 against its plain version (phase kv_k9): clusters (past a whole
# number of 4-cluster blocks), the ticks a case runs on K6 and K9 first
# (past the first elections, so that the compared ticks ack ops), the
# ticks it compares, and the cases: (name, n, kv knobs, metrics,
# partitionable layout); the card tests compare from the first tick
KV_K9_CLUSTERS, KV_K9_WARM, KV_K9_TICKS = 1100, 32, 24
KV_K9_CASES = (
    ("n3", 3, {}, False, True),
    ("n5_puts", 5, {"p_put": 0.2}, True, True),
    ("n7_legacy", 7, {"p_put": 0.2}, False, False),
    ("skip_dedup", 5, {"bug_skip_dedup": True}, True, True),
    ("apply_uncommitted", 5, {"bug_apply_uncommitted": True}, False, False),
    ("stale_read", 5, {"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2},
     True, True),
    ("stale_hint", 5, {"bug_stale_hint": True, "p_follow_hint": 0.9,
                       "retry_wait": 3}, True, False),
    ("hints_retry_wait", 5, {"p_follow_hint": 0.9, "retry_wait": 3}, False,
     True),
    ("hot_key_openloop", 5, "hot_key", True, True),
    ("hot_key_openloop_legacy", 5, "hot_key", False, False),
    ("zipf_nk8", 5, {"n_keys": 8, "zipf_a": 2.0}, True, True),
    ("zipf_nk16", 5, {"n_keys": 16, "zipf_a": 1.5}, False, False),
    ("mixed_rows", 5, "rows", True, True),
    ("mixed_rows_legacy", 7, "rows", False, False),
    ("storm_mixed_ticks", 5, {"p_put": 0.2, "bug_stale_read": True}, True,
     True),
    # 32 clients and 64 keys: K9's shared region past 48 KB a block
    ("wide_tables", 7, {"n_clients": 32, "n_keys": 64, "p_put": 0.2}, True,
     True),
)
# the ctrler flagship (bench.py's ctrler row: its 1024 clusters at the
# kv flagship's depth), twice, and with the metrics plane
CTRLER_FLAGSHIP = ["ctrler-fuzz", "--storm", "--clusters", "1024", "--ticks",
                   "512", "--seed", "12345", "--check-deterministic"]
CTRLER_METRICS_FLAGSHIP = CTRLER_FLAGSHIP + ["--metrics"]
# the ctrler flagship's eager-vs-kernel A/B: the four runs' depth
CTRLER_AB_TICKS = 32
# the ctrler flagship's batch on the CPU route beside K6-ctrler: its depth
CTRLER_CPU_TICKS = 32
# the sweep's knob rows on K6-ctrler beside the eager route: the depth (the
# planted bugs fire by then)
CTRLER_SWEEP_TICKS = 128
# K6-ctrler against the plain route (phase ctrler_k6ctrler): each
# comparison's launches (ticks; a short last one) and the cases' clusters
# (past a whole number of two-cluster warps, as many as K10's: some
# cases create few configs a cluster in the compared ticks); the cases
# are K10's
CTRLER_K6C_LAUNCHES = (16, 1, 7)
CTRLER_K6C_CLUSTERS = 1101
# K10 against its plain version (phase ctrler_k10): clusters, the ticks a
# case runs on K6 and K10 first (past the first elections and configs),
# the ticks it compares, and the cases: (name, n, ctrler config ("rows":
# the mixed knob rows), metrics, partitionable layout)
CTRLER_K10_CLUSTERS, CTRLER_K10_WARM, CTRLER_K10_TICKS = 1100, 48, 24
CTRLER_K10_CASES = (
    ("n3", 3, {}, False, True),
    ("n5_metrics", 5, {}, True, True),
    ("n7_legacy", 7, {}, False, False),
    ("rotate_tiebreak", 5, {"bug_rotate_tiebreak": True}, True, True),
    ("greedy_rebalance", 5, {"bug_greedy_rebalance": True}, False, False),
    ("full_reshuffle", 5, {"bug_full_reshuffle": True}, True, False),
    ("ng2_jm1", 5, {"n_gids": 2, "join_max": 1}, False, True),
    ("ng10_jm3", 7, {"n_gids": 10, "join_max": 3}, True, True),
    # a history of six configs: most clusters fill it, the room gate closes
    ("full_history", 5, {"n_configs": 6, "p_move": 0.3}, True, False),
    ("mixed_rows", 5, "rows", True, True),
    ("mixed_rows_legacy", 7, "rows", False, False),
    ("storm_mixed_ticks", 5, {"bug_rotate_tiebreak": True}, True, True),
    # 32 clients: a warp's every lane a clerk
    ("clients_32", 7, {"n_clients": 32, "n_gids": 10}, True, True),
)
# the shardkv flagship (the CLI's deployment: n = 5, cap 64, 3 groups, 10
# shards, 4 clerks, 6 configs; 1024 deployments, so 3072 group clusters a
# tick, at the kv and ctrler flagships' depth: cfg_interval 60 puts
# config 5 near tick 300), twice; then once with the metrics plane
SHARDKV_FLAGSHIP = ["shardkv-fuzz", "--storm", "--clusters", "1024",
                    "--ticks", "512", "--seed", "12345",
                    "--check-deterministic"]
SHARDKV_METRICS_FLAGSHIP = SHARDKV_FLAGSHIP[:-1] + ["--metrics"]
# the shardkv flagship's eager-vs-kernel A/B: the four runs' depth
SHARDKV_AB_TICKS = 32
# K11 against its plain version (phase shardkv_k11): the flagship's batch
# from tick SHARDKV_K11_WARM (the cases as [B] rows, shardkv_knob_rows),
# K11 under the partitionable layout and K11-metrics under the legacy
# one, and a small edge batch (deployments, n, shardkv config, warm
# ticks: five groups of seven, 32 clerks, a ragged batch), each compared
# for SHARDKV_K11_TICKS ticks
SHARDKV_K11_WARM, SHARDKV_K11_TICKS = 200, 24
SHARDKV_K11_EDGE = (37, 7, {"n_groups": 5, "n_clients": 32, "p_put": 0.2,
                            "cfg_interval": 20}, 60)
# K11's controller branches against the plain version (phase
# shardkv_ctrl_k11): the controller flagships' batches from tick
# SHARDKV_K11_WARM with the mode's cases as [B] rows (shardkv_knob_rows),
# K11 under the partitionable layout and K11-metrics under the legacy one,
# compared for SHARDKV_K11_TICKS ticks; then an edge batch a mode
# (deployments, n, the raft config's changes, shardkv config, warm ticks):
# cap 16, two walker steps a tick, 16 configs due every few ticks (the
# controller's log fills: it never compacts), its controller shadow slid
# past the walker on every other deployment after the warm ticks (the
# sticky stall: a run's own commits never slide a controller's shadow)
SHARDKV_CTRL_EDGE = (37, 5, {"log_cap": 16, "compact_every": 4,
                             "uncommitted_cap": 4},
                     {"walk_max": 2, "n_configs": 16, "cfg_interval": 4,
                      "p_phantom": 0.5}, 60)
# the controller flagships: the shardkv flagship with --live-ctrler or
# --computed-ctrler
SHARDKV_CTRL_FLAG = {"live": "--live-ctrler", "computed": "--computed-ctrler"}
# K6-shardkv against shardkv_chunk_plain (phase shardkv_k6shardkv, once a
# mode): the batches of shardkv_k11 / shardkv_ctrl_k11 from the same warm
# ticks, compared after each launch of these lengths (the last a short
# one)
SHARDKV_K6S_LAUNCHES = (16, 1, 7)
# the CPU route's batch and depth beside the card's K6-shardkv
SHARDKV_CPU_DEPLOYMENTS, SHARDKV_CPU_TICKS = 32, 16
# the eager route's depth beside K6-shardkv's report at the flagship's
# batch, a mode: the eager tick there is 65-145 ms (H100; the plain
# service tick a few thousand small operations), so the smoke holds its
# time with 64 ticks and tests/test_torch_cuda.py runs the whole flagship
# (test_k6_shardkv_flagship_equals_the_eager_route)
SHARDKV_EAGER_TICKS = {"schedule": 64, "live": 64, "computed": 64}
# the ticks of a K6-shardkv launch in the kernels line (the plain version,
# whose per-tick counts give the bound, takes 0.07-0.15 s a tick at the
# flagship's batch)
SHARDKV_K6S_TIMED_TICKS = 16
# the row cases of shardkv_knob_rows, deployment d taking case d % 7
SHARDKV_ROW_CASES = ("clean", "skip_freeze", "drop_dup_table",
                     "serve_frozen", "puts", "open_zipf", "requery")
# the metrics-on packed carry at n = 5, cap = 64 (the reference's pin)
METRICS_BYTES_PER_LANE = 3600
# a small pool whose broken quorum violates across refill generations
REPLAY_POOL = ["pool", "--storm", "--majority-override", "2", "--clusters",
               "64", "--ticks", "64", "--chunk-ticks", "32", "--budget-ticks",
               "192", "--seed", "7", "--emit", "violations"]
# run-to-run fields of a pool summary and its rows
WALL = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
        "violations_per_s", "compile_s", "dispatch_gap_s", "device_wait_s",
        "host_overlap_s")
# H100 SXM peak HBM rate (published datasheet figure), bytes/s
PEAK_BYTES_S = 3.35e12
# 32-bit integer lanes of an SM (Hopper: 16 in each of 4 sub-partitions);
# the kernels' integer bound is INT_LANES_PER_SM x SMs x the SM clock
# (nvidia-smi clocks.max.sm), 16.7 T operations/s at 132 x 1.98 GHz
INT_LANES_PER_SM = 64
# Integer ALU instructions of one threefry2x32 hash as ptxas issues it
# for sm_90a (cuobjdump -sass of threefry.cu's tick_blocks_kernel, the
# partitionable hash: 78 instructions): 20 SHF.L.W (a rotation is one
# funnel shift) and 21 LOP3 (20 xors and the key schedule's ks[2]) on the
# ALU pipe. The other 36 are adds (31 IMAD, which threefry.cuh's mad_one
# puts on the FMA pipe beside it, and 5 VIADD for ks + round) and are left
# out, so the bound stays a lower one (K1 runs faster than all 78 at the
# ALU rate would allow); the partitionable word's y0 ^ y1 is counted apart
OPS_PER_HASH = 20 + 21


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds
    since the script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
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


def _cupti_room() -> str:
    """Hands the card's cached, unused memory back before a profiler
    window, and says how much is free. CUPTI keeps its kernel records in
    device buffers of its own; when PyTorch's caching allocator holds
    nearly all the card's memory, as it does late in this script, CUPTI
    loses a window's first records or all of them (``cupti_probe.py``
    shows it on a full cache and its cure by ``empty_cache``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free"


def device_ms(fn, kernel, iters: int = 50, warmup: int = 3,
              attempts: int = 5) -> float:
    """Mean device milliseconds of one launch of the CUDA kernel named
    ``kernel`` (or the sum over a tuple of names, the launches of one
    call) over the calls of fn(i) it recorded, at least iters of them,
    from torch.profiler's CUPTI trace: the kernels' own execution, without
    the host's issue time or any other kernel the wrapper launches. Late
    in a long process CUPTI loses the records of a window's first timed
    launches (43 of a window's 50 K11 launches seen, 3 of 5 K6-kv, 7 of 10
    K6-trace, 41 of 50 credit-pass launches, five windows in a row; in
    one window the 6 of 10 K6-trace launches it kept were the last six,
    after 150 ms of spin kernels and a sync), so each window opens, as
    ``_profiled``'s do, with a warm-up step (the warmup calls; nothing they
    launch is kept) and spin kernels (``_spins``), then makes iters //
    2 + 2 more calls than iters, all timed, and closes with spin kernels;
    a window that recorded fewer than iters launches is measured again,
    up to ``attempts`` times, each with twice the previous window's timed
    calls, since the loss takes a window's first launches and not its
    last (K6-metrics' 256-tick launch, 4.4 ms: the first 5 of 9 lost, the
    last 4 kept, five windows in a row); a failure names the recorded
    launches' start times from the window's first event and the card's
    free memory before it. Each window starts with ``_cupti_room``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5)  # CUPTI's buffers come back asynchronously
        torch.cuda.synchronize()
        room = _cupti_room()
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for i in range(warmup):
                fn(i)
            torch.cuda.synchronize()
            prof.step()
            _spins()
            torch.cuda.synchronize()
            for i in range((iters + iters // 2 + 2) << attempt):
                fn(i)
            _spins()
            torch.cuda.synchronize()
            prof.step()
        avgs = prof.key_averages()
        seen = {}
        for k in names:
            name = re.compile(rf"(^|::|\s){re.escape(k)}(\(|<|$)")
            hits = [e for e in avgs if name.search(e.key)]
            seen[k] = (sum(e.count for e in hits),
                       sum(_dev_us(e) for e in hits))
        # the mean is over the launches CUPTI recorded, iters at least
        if all(n >= iters and us > 0 for n, us in seen.values()):
            return sum(us / n for n, us in seen.values()) / 1e3
    events = prof.events()
    t0 = min((e.time_range.start for e in events), default=0)
    starts = [round((e.time_range.start - t0) / 1e3, 3) for e in events
              if any(k in e.name for k in names)]
    check(False, f"profiler saw {seen} launches of {names}, {iters} wanted, "
          f"in {attempts} windows: {[e.key[:80] for e in avgs][:12]}; "
          f"the last window's launches start at {starts} ms; {room} before "
          f"it")


# spin kernels that open and close each device_ms window, around the
# timed calls: SPIN_KERNELS short ones and one of about SPIN_LONG_MS
SPIN_KERNELS = 16
SPIN_LONG_MS = 20


def _spins() -> None:
    import torch

    for _ in range(SPIN_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda._sleep(int(SPIN_LONG_MS * 2e6))  # cycles, at about 2 GHz


def rotations(nbytes_in: int) -> int:
    """Copies of a kernel's inputs to cycle through so that each launch
    reads its inputs from device memory (the 50 MB L2 cache holds none of
    them), as the bytes bound assumes."""
    return max(1, -(-2 * 50 * 2**20 // max(nbytes_in, 1)))


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def run_cli_lines(argv):
    """rc and every JSON line the CLI printed (a pool's rows come from its
    consumer thread; the redirect is process-wide, so they land here)."""
    from madraft_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def run_cli(argv):
    rc, lines = run_cli_lines(argv)
    return rc, lines[-1]


def _flag(argv, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def deterministic(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in WALL}


def counters():
    """Every kernel launch counter, by name: the wrappers' ``launches``,
    the oracle's count of metrics-instance launches and K6's of its
    metrics and coverage variants."""
    from madraft_tpu_torch.kernels import coverage as K5
    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import harvest as K7
    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.kernels import metrics as K4
    from madraft_tpu_torch.kernels import oracle as K2
    from madraft_tpu_torch.kernels import pack as K3
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.kernels import threefry as K1
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.kernels import trace as K8

    out = {"threefry_hash_pairs": (K1.hash_pairs, "launches"),
           "threefry_tick_blocks": (K1.tick_blocks, "launches"),
           "oracle": (K2.oracle, "launches"),
           "oracle_metrics": (K2.oracle, "metrics_launches"),
           "pack_state": (K3.pack_state, "launches"),
           "unpack_state": (K3.unpack_state, "launches"),
           "latency_fold": (K4.latency_fold, "launches"),
           "seen_update": (K5.seen_update, "launches"),
           "tick_chunk": (K6.tick_chunk, "launches"),
           "tick_chunk_metrics": (K6.tick_chunk, "metrics_launches"),
           "tick_chunk_coverage": (K6.tick_chunk, "coverage_launches"),
           "tick_chunk_trace": (K6.tick_chunk, "trace_launches"),
           "credit_pass": (K5.credit_pass, "launches"),
           "harvest": (K7.harvest, "launches"),
           "record": (K8.record, "launches"),
           "kv_tick": (K9.kv_tick, "launches"),
           "kv_tick_metrics": (K9.kv_tick, "metrics_launches"),
           # K6-kv's (absent from an older tree: kv_leg's parent)
           "kv_chunk": (getattr(K9, "kv_chunk", None), "launches"),
           "kv_chunk_metrics": (getattr(K9, "kv_chunk", None),
                                "metrics_launches"),
           "ctrler_tick": (K10.ctrler_tick, "launches"),
           "ctrler_tick_metrics": (K10.ctrler_tick, "metrics_launches"),
           # K6-ctrler's (absent from an older tree: ctrler_leg's parent)
           "ctrler_chunk": (getattr(K10, "ctrler_chunk", None), "launches"),
           "ctrler_chunk_metrics": (getattr(K10, "ctrler_chunk", None),
                                    "metrics_launches"),
           "shardkv_tick": (K11.shardkv_tick, "launches"),
           "shardkv_tick_metrics": (K11.shardkv_tick, "metrics_launches"),
           "shardkv_tick_live": (K11.shardkv_tick, "live_launches"),
           "shardkv_tick_computed": (K11.shardkv_tick,
                                     "computed_launches"),
           "shardkv_tick_metrics_live": (K11.shardkv_tick,
                                         "live_metrics_launches"),
           "shardkv_tick_metrics_computed": (K11.shardkv_tick,
                                             "computed_metrics_launches")}
    # K6-shardkv's (absent from an older tree: shardkv_leg's parent)
    chunk = getattr(K11, "shardkv_chunk", None)
    for name, a in (("shardkv_chunk", "launches"),
                    ("shardkv_chunk_metrics", "metrics_launches"),
                    ("shardkv_chunk_live", "live_launches"),
                    ("shardkv_chunk_computed", "computed_launches"),
                    ("shardkv_chunk_metrics_live", "live_metrics_launches"),
                    ("shardkv_chunk_metrics_computed",
                     "computed_metrics_launches")):
        out[name] = (chunk, a)
    return {k: v for k, v in out.items() if v[0] is not None}


def read_counts() -> dict:
    return {k: getattr(fn, a) for k, (fn, a) in counters().items()}


def set_counts(values=None) -> None:
    """Set every counter to 0, or back to the values of ``read_counts``."""
    for k, (fn, a) in counters().items():
        setattr(fn, a, 0 if values is None else values[k])


class KeepFirst:
    """A stand-in for a function the engine or the CLI calls: it keeps
    ``keep(args)`` of the first call (or of call number ``at``; with
    ``result``, ``keep`` of what that call returned) and returns what the
    function does."""

    def __init__(self, fn, keep, at: int = 0, result: bool = False):
        self.fn, self.keep, self.kept = fn, keep, []
        self.at, self.calls, self.result = at, 0, result

    def __call__(self, *args, **kwargs):
        at = self.calls == self.at
        self.calls += 1
        if at and not self.result:
            self.kept.append(self.keep(*args))
        out = self.fn(*args, **kwargs)
        if at and self.result:
            self.kept.append(self.keep(out))
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import coverage as K5
    from madraft_tpu_torch.kernels import harvest as K7
    from madraft_tpu_torch.kernels import metrics as K4
    from madraft_tpu_torch.kernels import oracle as K2
    from madraft_tpu_torch.kernels import pack as K3
    from madraft_tpu_torch.kernels import threefry as K1
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.kernels import trace as K8
    from madraft_tpu_torch.tpusim import (
        config,
        coverage,
        engine,
        kv,
        metrics,
        prng,
        state,
        step,
    )
    from madraft_tpu_torch.tpusim import trace

    dev = torch.device("cuda")
    errs = {k: 0.0 for k in counters()}
    edges = (1, 2, 1000, 2**20, 2**20 + 7, 2**31 - 1)

    # ---- 1. build
    t0 = time.perf_counter()
    per_source = _build.build_all(_build.SOURCES + (
        _build.KV, _build.CTRLER, _build.SHARDKV) + tuple(_build.VARIANTS))
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

    # ---- 3a. K2's metrics instance against its plain version, shadow_sub
    # included: metrics-on storm states at n = 3, 5, 7 and a planted copy
    checked = []
    for n_nodes in (3, 5, 7):
        cfg = storm.replace(n_nodes=n_nodes, metrics=True)
        ck = engine.cluster_keys(7, 512, dev)
        kn = cfg.knobs(dev)
        hm = state.state_to_numpy(engine._advance(
            cfg, state.init_cluster(cfg, ck, kn), ck, kn, 150))
        srcs = [("storm@150", hm)]
        if n_nodes == 5:
            srcs.append(("planted", _plant(hm)[0]))
        for label, src in srcs:
            _k2m_vs_plain(state.state_from_numpy(src, dev), errs,
                          f"n={n_nodes} {label}")
            checked.append(f"n{n_nodes}:{label}")
    emit({"phase": "k2_metrics_vs_plain", "states": checked, "clusters": 512,
          "max_abs_err": errs["oracle_metrics"]})

    # ---- 3b'. K4 against its plain version on planted inputs: every
    # bucket edge, ties, all and no ops masked, held registers, int32 wrap
    shapes = ((4096, 64, 4), (1001, 64, 4), (64, 33, 5), (9, 1, 0))
    for b_, m_, p_ in shapes:
        _k4_vs_plain(metrics.planted_fold_inputs(b_, m_, p_, b_ + m_), dev,
                     errs, f"planted {b_}x{m_}x{p_}")
    emit({"phase": "k4_vs_plain_planted", "shapes": shapes,
          "max_abs_err": errs["latency_fold"]})

    # ---- 3c. K5 against its plain version on planted batches: n = 3, 5,
    # 7; identity (the ground-truth alphabet) and hashed seen-sets (65536
    # bits, and 16 bits where many lanes collide); violated lanes; eight
    # lanes on one code a tick; one row, a [1, bits] sharded row, 4 rows
    gt_cfg, gt_ccfg, gt_horizon = config.coverage_ground_truth()
    checked = []
    for n_nodes in (3, 5, 7):
        for mode, ccfg in (("identity", gt_ccfg),
                           ("hashed", config.CoverageConfig()),
                           ("hashed16", config.CoverageConfig(bitmap_bits=16))):
            if mode == "identity":
                space = coverage.code_space(n_nodes, ccfg)
                if space > 1 << 23:
                    continue
                ccfg = ccfg.replace(bitmap_bits=1 << (space - 1).bit_length())
            for shards in (None, 1, 4):
                cpu_in = coverage.planted_fingerprint_inputs(n_nodes, 4096,
                                                             n_nodes)
                _k5_vs_plain(ccfg, cpu_in, shards, dev, errs,
                             f"n={n_nodes} {mode} shards={shards}")
                checked.append(f"n{n_nodes}:{mode}:{shards}")
    emit({"phase": "k5_vs_plain_planted", "lanes": 4096, "cases": checked,
          "ticks_each": 3, "max_abs_err": errs["seen_update"]})

    # ---- 3d. the refill's float32 arithmetic (XLA's exp2 and FMA as the
    # plain version forms them) on the card over all 2^23 uniforms, held
    # against the SHA-256 of the JAX package's results
    cov_fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                         "coverage_legs.json").read_text())
    grid = {}
    for name, ccfg in (("default", config.CoverageConfig()),
                       ("ground_truth", gt_ccfg)):
        mut, fresh = coverage.refill_grid(ccfg, dev)
        digest = coverage.grid_sha256([mut.cpu(), fresh.cpu()])
        check(digest == cov_fx["exp_grid"][name]["sha256"],
              f"refill arithmetic on the card differs from the JAX "
              f"package's over the uniform grid ({name})")
        # K7's refill (true FMAs on the card) against the CPU twin's
        mut, fresh = K7.refill_grid(ccfg, dev)
        k7_digest = coverage.grid_sha256([mut.cpu(), fresh.cpu()])
        check(k7_digest == coverage.grid_sha256(coverage.refill_grid(ccfg))
              == digest, f"K7's refill grid differs from the CPU twin's "
              f"({name})")
        grid[name] = digest[:16]
    del mut, fresh
    emit({"phase": "refill_grid", "values": 1 << 23, "sha256_prefix": grid,
          "k7_match": True, "match": True})

    # ---- 3b. K3 against its plain version (on the CPU, same inputs):
    # n = 3, 5, 7; fresh clusters, storm@150, and a state at the edges of
    # the packed bounds; unpack(pack(s)) == s on each
    states_checked = []
    for n_nodes in (3, 5, 7):
        cfg = storm.replace(n_nodes=n_nodes)
        ck = engine.cluster_keys(7, 256, dev)
        kn = cfg.knobs(dev)
        s0 = state.init_cluster(cfg, ck, kn)
        h150 = state.state_to_numpy(engine._advance(cfg, s0, ck, kn, 150))
        for label, h in (("init", state.state_to_numpy(s0)),
                         ("storm@150", h150),
                         ("edge", state.planted_edge_state(cfg, h150,
                                                           n_nodes))):
            _k3_vs_plain(cfg, h, dev, errs, f"n={n_nodes} {label}")
            states_checked.append(f"n{n_nodes}:{label}")
    check(errs["pack_state"] == 0 and errs["unpack_state"] == 0,
          f"K3 differs from its plain version: {errs}")
    emit({"phase": "k3_vs_plain", "states": states_checked, "clusters": 256,
          "max_abs_err": max(errs["pack_state"], errs["unpack_state"])})

    # ---- 3e. K6 against its plain version (its words drawn, the eager
    # tick looped over the chunk), every leaf after every chunk: n = 3, 5,
    # 7 under every planted bug (--storm, 0-d knobs, chunks of 32), [B]
    # knob rows in ragged chunks of 7, a pool state at mixed per-lane ticks
    # and keys, a broken quorum that violates (the partitionable layout),
    # then every template instance and the runtime one, each under both
    # threefry layouts, and lanes across the int32 and u32 tick wraps; the
    # flagship's shape is held in phase 7
    cap16 = dict(log_cap=16, compact_every=4, uncommitted_cap=4)
    cases = [(f"n{n_nodes}:{bug or 'clean'}",
              storm.replace(n_nodes=n_nodes, bug=bug), 128, 32, None, False,
              True, K6_TICKS)
             for n_nodes in (3, 5, 7) for bug in config.RAFT_BUGS]
    cases += [("n5:knob_rows:chunk7", storm, 256, 7, "rows", False, True,
               K6_TICKS),
              ("n5:pool_mixed_ticks", storm, 256, 32, None, True, True,
               K6_TICKS),
              ("n5:majority2", storm.replace(majority_override=2), 256, 32,
               None, False, True, K6_TICKS)]
    shapes = [(f"n{n_nodes}:cap{cap}", storm.replace(
        n_nodes=n_nodes, **(cap16 if cap == 16 else {})))
        for n_nodes, cap in K6.SHAPES]
    # the runtime instance: a shape with none, and the flagship's shape
    # with one more entry a message than the instances take
    shapes += [("n4:cap32:runtime", storm.replace(
        n_nodes=4, log_cap=32, compact_every=8)),
        (f"n5:cap64:ae{K6.SHAPE_AE + 1}:runtime",
         storm.replace(ae_max=K6.SHAPE_AE + 1))]
    cases += [(f"{label}:{'partitionable' if flag else 'legacy'}", cfg, 128,
               32, None, False, flag, K6_SHAPE_TICKS)
              for label, cfg in shapes for flag in (True, False)]
    rolling = config.storm_profiles()["rolling_wave"][0]
    cases += [("n5:tick_wraps", storm, 128, 32, "wrap", False, True,
               K6_SHAPE_TICKS),
              ("n5:rolling_wave", rolling, 128, 32, None, False, True,
               K6_SHAPE_TICKS),
              ("n5:rolling_wave:tick_wraps", rolling, 128, 32, "wrap", False,
               True, K6_SHAPE_TICKS),
              ("n5:127_lanes", storm, 127, 32, None, False, True,
               K6_SHAPE_TICKS)]
    k6_cases = {}
    instances = set()
    for label, cfg, b_, chunk_, rows_, mixed, flag, ticks_ in cases:
        with prng.layout(flag):
            ck = engine.cluster_keys(7, b_, dev)
            kn = _knob_rows(b_, dev) if rows_ == "rows" else cfg.knobs(dev)
            s6 = state.init_cluster(cfg, ck, kn)
            if mixed:  # two lanes in three 90 ticks on, under other keys
                ck2 = engine.cluster_keys(7, b_, dev, id0=b_)
                later = engine._advance(cfg, state.init_cluster(cfg, ck2, kn),
                                        ck2, kn, 90)
                sel = torch.arange(b_, device=dev) % 3 != 0
                s6 = state.ClusterState(*(
                    torch.where(sel.view(-1, *(1,) * (x.dim() - 1)), y, x)
                    if x.numel() else x for x, y in zip(s6, later)))
                ck = torch.where(sel[:, None], ck2, ck)
            if rows_ == "wrap":
                s6 = s6._replace(tick=torch.tensor(
                    [(2**31 - 10, -20, 1000)[i % 3] for i in range(b_)],
                    dtype=torch.int32, device=dev))
            s6 = _k6_vs_plain(cfg, s6, ck, kn, ticks_, chunk_, errs, label)
            instances.add(K6.instance(cfg))
            k6_cases[label] = [int((s6.violations != 0).sum()),
                               int(s6.shadow_len.sum()),
                               int(s6.snap_install_count.sum())]
    check(k6_cases["n5:majority2"][0] > 0,
          f"the broken quorum did not violate: {k6_cases['n5:majority2']}")
    check(instances == set(range(len(K6.SHAPES) + 1)),
          f"the cases ran instances {sorted(instances)}")
    emit({"phase": "tick_chunk", "ticks": K6_TICKS,
          "shape_ticks": K6_SHAPE_TICKS, "instances": sorted(instances),
          "cases": {k: {"violating": v[0], "committed": v[1], "installs": v[2]}
                    for k, v in k6_cases.items()},
          "max_abs_err": errs["tick_chunk"]})
    del s6

    # ---- 3f. K6-metrics against its plain version (the eager tick with
    # metrics), every leaf, the metric leaves included, after every chunk:
    # all seven instances (the runtime one at the flagship's shape, one more
    # entry a message), both threefry layouts, 256-tick launches at the
    # flagship's shape, lanes across the int32 and u32 tick wraps, [B] knob
    # rows under a planted bug, and metric leaves planted at their edges
    # (stale stamps in every ring slot, sums at the int32 wrap, empty, held
    # and kept worst-op registers); the grid and resident clusters an SM
    mstorm = storm.replace(metrics=True)
    mcases = [(f"n{n_nodes}:cap{cap}", mstorm.replace(
        n_nodes=n_nodes, **(cap16 if cap == 16 else {})), True, None, 128)
        for n_nodes, cap in K6.SHAPES]
    mcases += [("n5:cap64:runtime", mstorm.replace(ae_max=K6.SHAPE_AE + 1),
                True, None, K6_TICKS),
               ("n5:cap64:legacy", mstorm, False, None, K6_TICKS),
               ("n5:cap64:runtime:legacy",
                mstorm.replace(ae_max=K6.SHAPE_AE + 1), False, None, 128),
               ("n5:tick_wraps", mstorm, True, "wrap", 128),
               ("n5:planted_registers", mstorm, True, "registers", K6_TICKS),
               ("n5:knob_rows:commit_any_term",
                mstorm.replace(bug="commit_any_term"), True, "rows", 128)]
    minstances, mops = set(), {}
    for label, cfg, flag, special, ticks_ in mcases:
        with prng.layout(flag):
            b_ = 128
            ck = engine.cluster_keys(7, b_, dev)
            kn = _knob_rows(b_, dev) if special == "rows" else cfg.knobs(dev)
            s6 = state.init_cluster(cfg, ck, kn)
            if special == "wrap":
                s6 = s6._replace(tick=torch.tensor(
                    [(2**31 - 10, -20, 1000)[i % 3] for i in range(b_)],
                    dtype=torch.int32, device=dev))
            if special == "registers":
                s6 = _plant_metric_leaves(s6)
            hist0 = s6.lat_hist.to(torch.int64)
            s6 = _k6_variant_vs_plain(cfg, s6, ck, kn, ticks_, ticks_, errs,
                                      label)
            minstances.add(K6.instance(cfg))
            # the ops the case acked (the planted sums wrap int32)
            mops[label] = int(((s6.lat_hist.to(torch.int64) - hist0)
                               % 2**32).sum())
    check(minstances == set(range(len(K6.SHAPES) + 1)),
          f"the metrics cases ran instances {sorted(minstances)}")
    check(all(v > 0 for v in mops.values()), f"a case acked no op: {mops}")
    mgrid = _k6_grid(_storm_cfg(), "tick_metrics")
    check(mgrid["waves_at_4096"] == 1,
          f"K6-metrics takes {mgrid['waves_at_4096']} waves at 4096 "
          f"clusters: {mgrid}")
    emit({"phase": "k6_metrics_vs_plain", "clusters": 128,
          "instances": sorted(minstances), "acked_ops": mops,
          "grid_flagship_shape": mgrid,
          "grid_flagship_shape_metrics_off": _k6_grid(_storm_cfg()),
          "max_abs_err": errs["tick_chunk_metrics"]})

    # ---- 3g. K6-coverage and the credit pass against the per-tick plain
    # fingerprint (seen_update_plain after each eager tick): the state, the
    # seen-set stamps and the credits after every chunk. One row; shard
    # rows on a 16-bit seen-set (many lanes on one bit a tick, and every
    # lane on one code at tick 1); the identity map (the ground-truth
    # config); violated lanes (a broken quorum); the combined variant with
    # metrics; a 256-tick launch at the flagship's shape
    gt_cfg_, gt_ccfg_, _ = config.coverage_ground_truth()
    ccases = [("one_row", storm, config.CoverageConfig(), None, K6_TICKS),
              ("shards4_16bits", storm, config.CoverageConfig(bitmap_bits=16),
               4, 128),
              ("identity", gt_cfg_, gt_ccfg_, None, 128),
              ("violated", storm.replace(majority_override=2),
               config.CoverageConfig(), None, K6_TICKS),
              ("metrics_shards2", mstorm, config.CoverageConfig(), 2, 128)]
    cstats = {}
    for label, cfg, ccfg, shards, ticks_ in ccases:
        with prng.layout(True):
            b_ = 512
            ck = engine.cluster_keys(7, b_, dev)
            kn = cfg.knobs(dev)
            s6 = state.init_cluster(cfg, ck, kn)
            rows_ = (None if shards is None
                     else coverage.lane_shards(b_, shards, dev))
            seen6 = torch.full((shards or 1, ccfg.bitmap_bits),
                               coverage.UNSEEN, dtype=torch.int32, device=dev)
            cov6 = K6.Seen(ccfg.fingerprint_key(), seen6, rows_,
                           torch.zeros(b_, dtype=torch.int32, device=dev), 0)
            s6, cov6 = _k6_variant_vs_plain(cfg, s6, ck, kn, ticks_, ticks_,
                                            errs, label, cov6)
            cstats[label] = {
                "seen_bits": int((cov6.seen != coverage.UNSEEN).sum()),
                "credits": int(cov6.new_fps.sum()),
                "violating": int((s6.violations != 0).sum())}
    check(cstats["violated"]["violating"] > 0
          and all(v["seen_bits"] > 1 for v in cstats.values()),
          f"coverage cases: {cstats}")
    emit({"phase": "k6_coverage_vs_plain", "clusters": 512, "cases": cstats,
          "max_abs_err": max(errs["tick_chunk_coverage"],
                             errs["credit_pass"])})
    del s6

    # ---- 3h. K7 against its plain version (on the CPU, same inputs), every
    # output (state, keys, ids, book, snapshot, knob rows, kinds, credits):
    # planted batches (every leaf random, a quarter of the lanes violated)
    # where some, all or no lanes retire, and where the election timeout
    # span is empty or eto_max + 1 wraps; both id schemes next to the int32
    # wrap, the plain pool and the coverage pool guided and unguided,
    # metrics on and off, both threefry layouts; the mixed case at the
    # flagship's 4096 lanes, the others at 1100 (the monotone ranks carry
    # across the scan's 1024-lane tiles)
    k7_cases = []
    for case in ("mixed", "all", "none", "eto_edge"):
        b_ = 4096 if case == "mixed" else 1100
        for cov_mode in (None, "guided", "random"):
            for lane_ids in (False, True):
                for m_on in (False, True):
                    cfg = storm.replace(metrics=m_on)
                    for flag in (True, False):
                        with prng.layout(flag):
                            args = K7.planted_inputs(cfg, b_, case, lane_ids,
                                                     cov_mode, 9)
                            want = K7.harvest_plain(cfg, *args)
                            got = K7.harvest(cfg, *K7.inputs_to(args, dev))
                            bad = K7.differences(want, got)
                        check(not bad, f"K7 differs from its plain version "
                              f"({case}, {cov_mode}, lane_ids {lane_ids}, "
                              f"metrics {m_on}, partitionable {flag}): {bad}")
                        for a, bb in ((got.snapshot, want.snapshot),
                                      (got.ids, want.ids),
                                      (got.keys, want.keys),
                                      (got.book, want.book)):
                            errs["harvest"] = max(errs["harvest"],
                                                  max_abs_err(a.cpu(), bb))
                        k7_cases.append(int(want.snapshot[:, 0].sum()))
    check(0 in k7_cases and 1100 in k7_cases,
          f"K7 cases retired {sorted(set(k7_cases))}")
    emit({"phase": "k7_vs_plain", "cases": len(k7_cases),
          "clusters": [4096, 1100], "retired_counts": sorted(set(k7_cases)),
          "max_abs_err": errs["harvest"]})
    del args, want, got

    # ---- 4. golden legs (legacy layout, as recorded)
    golden = json.loads((ROOT / "tests" / "golden_fuzz.json").read_text())
    with prng.layout(False):
        for leg in ("clean", "bug", "pool"):
            rec = golden[leg].get("report") or golden[leg]["summary"]
            rc, out = run_cli(golden[leg]["argv"])
            bad = {k: (out.get(k), v) for k, v in rec.items() if out.get(k) != v}
            check(not bad, f"golden {leg} leg differs: {bad}")
            found = rec.get("violating", rec.get("retired_violating"))
            check(rc == (1 if found else 0), f"golden {leg} rc {rc}")
            if leg == "pool":
                check(out["state_layout"] == "packed"
                      and out["bytes_per_lane"] == 2612.0,
                      f"golden pool layout {out['state_layout']} "
                      f"{out['bytes_per_lane']}")
            emit({"phase": f"golden_{leg}", "match": True, "rc": rc,
                  "violating": found})

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
    pool_fx = json.loads(
        (ROOT / "tests" / "torch_fixtures" / "pool_legs.json").read_text())
    with prng.layout(pool_fx["partitionable"]):
        for leg, rec in pool_fx["legs"].items():
            cfg = config.storm_profiles()[rec["profile"]][0].replace(bug=rec["bug"])
            rows = []
            before = K7.harvest.launches
            out = engine.run_pool(
                cfg, rec["seed"], pool_fx["lanes"], pool_fx["horizon"],
                chunk_ticks=pool_fx["chunk_ticks"],
                budget_ticks=pool_fx["budget_ticks"], devices=rec["devices"],
                on_retired=rows.append, device=dev)
            check(K7.harvest.launches - before == pool_fx["budget_ticks"]
                  // pool_fx["chunk_ticks"], f"fixture pool leg {leg}: "
                  f"{K7.harvest.launches - before} K7 launches")
            got = [[r[f] for f in pool_fx["row_fields"]] for r in rows]
            check(got == rec["rows"], f"fixture pool leg {leg}: rows differ")
            bad = {k: (out.get(k), v) for k, v in rec["summary"].items()
                   if out.get(k) != v}
            check(not bad, f"fixture pool leg {leg}: summary differs: {bad}")
            emit({"phase": f"fixture_pool_{leg}", "match": True,
                  "retired": out["retired"],
                  "violating": out["retired_violating"],
                  "state_layout": out["state_layout"]})
    _metrics_fixture_legs(dev)
    _coverage_fixture_legs(dev, cov_fx)

    # ---- 6. the flagship, through the CLI, counting kernel launches; the
    # state of its first run at tick METRICS_TICKS (the end of a K6 chunk)
    # is kept on the host (metric leaves aside) for the metrics flagship to
    # be held against
    set_counts()
    prng.set_partitionable(True)
    final_off = KeepFirst(K6.tick_chunk, _non_metric_leaves,
                          at=METRICS_TICKS // engine.KERNEL_CHUNK - 1,
                          result=True)
    engine.K6 = _k6_standin(final_off)
    try:
        t0 = time.perf_counter()
        rc, out = run_cli(FLAGSHIP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.K6 = K6
    launches = read_counts()
    chunks = -(-_flag(FLAGSHIP, "--ticks") // engine.KERNEL_CHUNK) * FLAGSHIP_RUNS
    check(rc == 0 and out["violating"] == 0, f"flagship rc {rc}: {out}")
    check(out.get("deterministic") is True, "flagship double run differs")
    check(out["first_leader_tick_mean"] > 0 and out["committed_mean"] > 0,
          f"flagship made no progress: {out}")
    check(launches["tick_chunk"] == chunks
          and launches["threefry_tick_blocks"] == launches["oracle"] == 0
          and launches["threefry_hash_pairs"] > 0
          and launches["oracle_metrics"] == launches["latency_fold"] == 0
          and launches["tick_chunk_metrics"] == 0
          and launches["tick_chunk_coverage"] == launches["credit_pass"] == 0,
          f"flagship launches {launches}, want {chunks} tick_chunk (one a "
          f"chunk of {engine.KERNEL_CHUNK} ticks), no tick_blocks, no "
          "oracle and no metrics or coverage launch")
    tele = out["telemetry"]
    emit({"phase": "flagship", "argv": FLAGSHIP, "rc": rc,
          "cluster_steps_per_s": tele["steps_per_sec"],
          "execute_s": tele["execute_s"], "wall_s_both_runs": round(wall, 3),
          "launches": launches, "committed_mean": out["committed_mean"],
          "first_leader_tick_mean": out["first_leader_tick_mean"],
          "bytes_per_lane": tele["bytes_per_lane"]})

    # ---- 6m. the metrics flagship: the flagship's first METRICS_TICKS
    # ticks with --metrics. Every non-metric leaf of its final state equals
    # the flagship's at that tick (the report's fields are read off those
    # leaves); K6-metrics runs it, no K4, K2 or draw launch
    set_counts()
    final_on = KeepFirst(engine.report, _non_metric_leaves)
    engine.report = final_on
    try:
        t0 = time.perf_counter()
        rc_m, out_m = run_cli(METRICS_FLAGSHIP)
        torch.cuda.synchronize()
        wall_m = time.perf_counter() - t0
    finally:
        engine.report = final_on.fn
    launches_m = read_counts()
    check(rc_m == 0 and out_m.get("deterministic") is True,
          f"metrics flagship rc {rc_m} or double run differs: {out_m}")
    check(set(out_m) - set(METRIC_KEYS) == set(out),
          f"metrics changed the flagship's report keys: {sorted(out_m)}")
    bad = [f for f, a in final_off.kept[0].items()
           if not (a.dtype == final_on.kept[0][f].dtype
                   and (a == final_on.kept[0][f]).all())]
    check(not bad, f"metrics changed the flagship's final leaves {bad}")
    _check_latency_mass(out_m["latency"], "metrics flagship")
    chunks_m = -(-METRICS_TICKS // engine.KERNEL_CHUNK) * FLAGSHIP_RUNS
    check(launches_m["tick_chunk"] == launches_m["tick_chunk_metrics"]
          == chunks_m
          and launches_m["latency_fold"] == launches_m["oracle_metrics"]
          == launches_m["oracle"] == launches_m["threefry_tick_blocks"] == 0,
          f"metrics flagship launches {launches_m}, want {chunks_m} "
          "K6-metrics launches and no K4, K2 or tick_blocks launch")
    tele_m = out_m["telemetry"]
    emit({"phase": "metrics_flagship", "argv": METRICS_FLAGSHIP, "rc": rc_m,
          "cluster_steps_per_s": tele_m["steps_per_sec"],
          "execute_s": tele_m["execute_s"],
          "wall_s_both_runs": round(wall_m, 3), "launches": launches_m,
          "latency": {k: out_m["latency"][k] for k in
                      ("ops", "p50_ticks", "p99_ticks", "ticks_total")},
          "worst_op": out_m["worst_op"], "events": out_m["events"],
          "bytes_per_lane": tele_m["bytes_per_lane"],
          "trajectory_unchanged": True})
    del final_off, final_on

    # ---- 6b. the pool flagship, through the CLI, twice, counting launches
    cfg = _storm_cfg()
    packed_bpl = state.tree_bytes(state.pack_state(cfg, state.init_cluster(
        cfg, engine.cluster_keys(0, 8, "cpu")))) / 8
    set_counts()
    runs = []
    # keep a host copy of the wide carry the first harvest packs (a few ms
    # of the first run; no device memory kept), so phase 7 can hold K3
    # against its plain version at this path's shape. The engine sees K3
    # through a stand-in whose pack keeps that copy and calls the kernel's
    # wrapper, which counts its launch as always
    harvested = KeepFirst(K3.pack_state,
                          lambda cfg_, s_: state.state_to_numpy(s_))
    engine.K3 = types.SimpleNamespace(pack_state=harvested,
                                      unpack_state=K3.unpack_state)
    try:
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            rc, lines = run_cli_lines(POOL_FLAGSHIP)
            torch.cuda.synchronize()
            runs.append((rc, lines[:-1], lines[-1],
                         torch.cuda.max_memory_allocated()))
    finally:
        engine.K3 = K3
    pool_launches = read_counts()
    (rc1, rows1, out1, peak1), (rc2, rows2, out2, peak2) = runs
    lanes, horizon, budget = (_flag(POOL_FLAGSHIP, f) for f in
                              ("--clusters", "--ticks", "--budget-ticks"))
    chunk_ticks = engine.default_chunk_ticks(horizon)
    gens = budget // chunk_ticks  # chunks per run
    want = {"threefry_tick_blocks": 0,
            "tick_chunk": 2 * gens * -(-chunk_ticks // engine.KERNEL_CHUNK),
            "oracle": 0, "pack_state": 2 * gens,
            "unpack_state": 2 * (gens - 1), "harvest": 2 * gens}
    # a clean run retires every lane at each horizon it reaches
    retired = lanes * (budget // horizon)
    check(rc1 == rc2 == 0 and out1["retired"] == retired
          and out1["retired_violating"] == 0, f"pool flagship: {out1}")
    check([deterministic(r) for r in rows1] == [deterministic(r) for r in rows2]
          and deterministic(out1) == deterministic(out2),
          "pool flagship double run differs")
    check(len(rows1) == retired, f"pool flagship streamed {len(rows1)} rows")
    check(out1["state_layout"] == "packed"
          and out1["bytes_per_lane"] == packed_bpl,
          f"pool flagship layout {out1['state_layout']} "
          f"{out1['bytes_per_lane']} vs {packed_bpl}")
    check(all(pool_launches[k] == v for k, v in want.items())
          and pool_launches["threefry_hash_pairs"] > 0,
          f"pool flagship launches {pool_launches}, want {want} (a K6 "
          "launch per pool chunk, a K7 harvest and a pack per harvest, an "
          "unpack per chunk but the first)")
    emit({"phase": "pool_flagship", "argv": POOL_FLAGSHIP, "rc": rc1,
          "retired": out1["retired"], "launches": pool_launches,
          "runs": [{k: o[k] for k in ("wall_s", "steps_per_sec",
                                      "effective_steps_per_sec",
                                      "dispatch_gap_s", "device_wait_s",
                                      "host_overlap_s", "compile_s")}
                   | {"peak_memory_bytes": pk}
                   for o, pk in ((out1, peak1), (out2, peak2))],
          "state_layout": out1["state_layout"],
          "state_hbm_bytes": out1["state_hbm_bytes"],
          "bytes_per_lane": out1["bytes_per_lane"]})

    # ---- 6m'. the metrics pool flagship (the pool flagship's first
    # horizon), twice: deterministic, its rows equal to the pool flagship's
    # first generation but for the metric columns, the histogram mass
    # invariants, K4 once a tick
    set_counts()
    mruns = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        rc, lines = run_cli_lines(METRICS_POOL_FLAGSHIP)
        torch.cuda.synchronize()
        mruns.append((rc, lines[:-1], lines[-1],
                      torch.cuda.max_memory_allocated()))
    mpool_launches = read_counts()
    (mrc1, mrows1, mout1, mpeak1), (mrc2, mrows2, mout2, mpeak2) = mruns
    check(mrc1 == mrc2 == 0, f"metrics pool flagship rc {mrc1} {mrc2}")
    check([deterministic(r) for r in mrows1] == [deterministic(r) for r in mrows2]
          and deterministic(mout1) == deterministic(mout2),
          "metrics pool flagship double run differs")
    row_cols = ("latency_hist", "events", "latency_phases", "worst_op")
    m_lanes = _flag(METRICS_POOL_FLAGSHIP, "--clusters")
    check([deterministic({k: v for k, v in r.items() if k not in row_cols})
           for r in mrows1] == [deterministic(r) for r in rows1
                                if r["cluster_id"] < m_lanes],
          "metrics changed the pool flagship's rows")
    check(mout1["retired"] == m_lanes and mout1["retired_violating"] == 0
          and set(mout1) - set(METRIC_KEYS) == set(out1),
          f"metrics pool flagship summary: {deterministic(mout1)}")
    check(mout1["state_layout"] == "packed"
          and mout1["bytes_per_lane"] == METRICS_BYTES_PER_LANE,
          f"metrics pool carry {mout1['state_layout']} "
          f"{mout1['bytes_per_lane']} B a lane")
    _check_latency_mass(mout1["latency"], "metrics pool flagship")
    for r in mrows1:
        check(all(sum(h) == sum(r["latency_hist"])
                  for h in r["latency_phases"].values()),
              f"pool row {r['cluster_id']}: phase rows' mass differs")
    check(sum(sum(r["latency_hist"]) for r in mrows1) <= mout1["latency"]["ops"],
          "pool rows hold more ops than the summary")
    m_budget = _flag(METRICS_POOL_FLAGSHIP, "--budget-ticks")
    m_gens = m_budget // chunk_ticks
    m_chunks = 2 * m_gens * -(-chunk_ticks // engine.KERNEL_CHUNK)
    mwant = {"threefry_tick_blocks": 0, "oracle": 0,
             "pack_state": 2 * m_gens, "unpack_state": 2 * (m_gens - 1),
             "harvest": 2 * m_gens,
             "latency_fold": 0, "oracle_metrics": 0,
             "tick_chunk": m_chunks, "tick_chunk_metrics": m_chunks}
    check(all(mpool_launches[k] == v for k, v in mwant.items()),
          f"metrics pool flagship launches {mpool_launches}, want {mwant}")
    emit({"phase": "metrics_pool_flagship", "argv": METRICS_POOL_FLAGSHIP,
          "rc": mrc1, "retired": mout1["retired"], "launches": mpool_launches,
          "runs": [{k: o[k] for k in ("wall_s", "steps_per_sec",
                                      "dispatch_gap_s", "device_wait_s",
                                      "host_overlap_s", "compile_s")}
                   | {"peak_memory_bytes": pk}
                   for o, pk in ((mout1, mpeak1), (mout2, mpeak2))],
          "latency": {k: mout1["latency"][k] for k in
                      ("ops", "p50_ticks", "p99_ticks", "ticks_total")},
          "worst_op": mout1["worst_op"],
          "state_hbm_bytes": mout1["state_hbm_bytes"],
          "bytes_per_lane": mout1["bytes_per_lane"]})
    del mruns, mrows1, mrows2

    # ---- 6c. pool hits replay through the CLI's replay
    rc, lines = run_cli_lines(REPLAY_POOL)
    hits = lines[:-1]
    lanes = _flag(REPLAY_POOL, "--clusters")
    later = [r for r in hits if r["cluster_id"] >= lanes]
    check(rc == 1 and hits and later,
          f"replay pool: rc {rc}, hits {[r['cluster_id'] for r in hits]}")
    replayed = []
    for r in hits[:2] + later[:2]:
        rc, out = run_cli(["replay", "--storm", "--majority-override", "2",
                           "--seed", "7", "--cluster", str(r["cluster_id"]),
                           "--ticks", str(r["ticks_run"])])
        check(rc == 1 and out["state_layout"] == "packed"
              and all(out[k] == r[k] for k in
                      ("violations", "first_violation_tick", "committed")),
              f"pool hit {r} replays as {out}")
        replayed.append(r["cluster_id"])
    emit({"phase": "pool_replay", "hits": len(hits), "replayed": replayed,
          "generations": sorted({c // lanes for c in replayed})})

    # ---- 6e. explain on the card, through the CLI: the bug cluster's
    # traced replay (K6-trace: launches of up to KERNEL_CHUNK ticks that
    # write each tick's row, no K8 launch), its header against the CLI's
    # replay of the same cluster; then K6-trace's rows against the eager
    # tick's record_plain rows at every tick of the storm and the bug
    # cluster, metrics on and off (K8 held against the same rows at every
    # tick), each traced final state against replay_cluster's, and the
    # traced replay's time a tick
    set_counts()
    t0 = time.perf_counter()
    rc, lines = run_cli_lines(EXPLAIN)
    torch.cuda.synchronize()
    explain_wall = time.perf_counter() - t0
    explain_launches = read_counts()
    head, events = lines[0], lines[1:]
    check(rc == 0 and head["violations"] != 0
          and head["first_violation_tick"] == EXPLAIN_FVT
          and head["events_shown"] == len(events)
          and any(e["event"] == "violation" for e in events),
          f"explain on the card: rc {rc}, {head}")
    explain_chunks = -(-EXPLAIN_TICKS // engine.KERNEL_CHUNK)
    check(explain_launches["tick_chunk"]
          == explain_launches["tick_chunk_trace"] == explain_chunks
          and explain_launches["record"] == explain_launches["harvest"] == 0,
          f"explain launches {explain_launches}, want {explain_chunks} "
          "K6-trace launches and no K8 launch")
    rc_r, rep = run_cli(["replay" if x == "explain" else x for x in EXPLAIN])
    check(rc_r == 1 and all(rep[k] == head[k] for k in (
        "violations", "first_violation_tick", "committed", "state_layout")),
        f"explain header {head} vs replay {rep}")
    saved = read_counts()
    record_cases = {}
    for (profile, bug, seed_, cl), label in (
            (EXPLAIN_STORM, "storm"),
            (("durability", "ack_before_fsync", 5, 32), "bug")):
        for m_on in (False, True):
            cfg = config.storm_profiles()[profile][0].replace(
                bug=bug, metrics=m_on)
            with prng.layout(True):
                final, rows = trace.traced_rows(cfg, seed_, cl,
                                                EXPLAIN_TICKS, device=dev)
                plain = engine.replay_cluster(cfg, seed_, cl, EXPLAIN_TICKS,
                                              device=dev)
                plain_rows, k8_rows, s_end = _trace_rows_plain(
                    cfg, seed_, cl, EXPLAIN_TICKS, dev)
            errs["tick_chunk_trace"] = max(errs["tick_chunk_trace"],
                                           max_abs_err(rows, plain_rows))
            errs["record"] = max(errs["record"],
                                 max_abs_err(k8_rows, plain_rows))
            check(errs["tick_chunk_trace"] == 0 and errs["record"] == 0,
                  f"K6-trace or K8 rows differ from record_plain's ({label}, "
                  f"metrics {m_on}): {errs['tick_chunk_trace']} "
                  f"{errs['record']}")
            check(all(torch.equal(a, b) and torch.equal(a, c)
                      for a, b, c in zip(final, plain, s_end)),
                  f"traced final state differs from replay_cluster's "
                  f"({label}, metrics {m_on})")
            rec = trace.TickRecord(**K8.decode(cfg, rows[:, 0].cpu().numpy()))
            record_cases[f"{label}:metrics_{m_on}"] = {
                "events": len(trace.decode_events(rec)),
                "first_violation_tick": int(final.first_violation_tick[0])}
    set_counts(saved)
    emit({"phase": "k6_trace_vs_plain", "ticks": EXPLAIN_TICKS,
          "cases": record_cases, "max_abs_err": errs["tick_chunk_trace"],
          "k8_max_abs_err": errs["record"]})
    # the traced replay's time a tick, the kernels' launches included
    with prng.layout(True):
        cfg = config.storm_profiles()["durability"][0].replace(
            bug="ack_before_fsync")
        trace.replay_cluster_traced(cfg, 5, 32, 8, device=dev)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace.replay_cluster_traced(cfg, 5, 32, EXPLAIN_TICKS, device=dev)
        traced_ms_per_tick = (time.perf_counter() - t0) * 1e3 / EXPLAIN_TICKS
    set_counts(saved)
    emit({"phase": "explain", "argv": EXPLAIN, "rc": rc,
          "header": head, "wall_s": round(explain_wall, 3),
          "launches": explain_launches, "record_cases": record_cases,
          "traced_replay_ms_per_tick": traced_ms_per_tick,
          "max_abs_err": errs["tick_chunk_trace"]})

    # ---- 6v. the coverage pool flagship, twice: deterministic, K6-coverage
    # and a credit pass a chunk (no K5 launch), the pool flagship's K3
    # launches; its first harvest's rows equal the pool flagship's but for
    # the coverage columns; mutated rows replay bit-exactly through the
    # CLI's replay --knobs-json
    set_counts()
    cruns = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc, lines = run_cli_lines(COVERAGE_POOL_FLAGSHIP)
        torch.cuda.synchronize()
        cruns.append((rc, lines[:-1], lines[-1],
                      torch.cuda.max_memory_allocated(),
                      time.perf_counter() - t0))
    cov_launches = read_counts()
    (crc1, crows1, cout1, cpeak1, _), (crc2, crows2, cout2, cpeak2, _) = cruns
    check(crc1 == crc2 == 0 and cout1["retired"] == retired,
          f"coverage pool flagship: rc {crc1} {crc2}, {cout1}")
    check([deterministic(r) for r in crows1] == [deterministic(r) for r in crows2]
          and _cov_deterministic(cout1) == _cov_deterministic(cout2),
          "coverage pool flagship double run differs")
    cov_cols = ("new_fingerprints", "refill", "knobs")
    pool_lanes = _flag(POOL_FLAGSHIP, "--clusters")
    first_gen = [deterministic({k: v for k, v in r.items() if k not in cov_cols})
                 for r in crows1 if r["cluster_id"] < pool_lanes]
    check(first_gen == [deterministic(r) for r in rows1
                        if r["cluster_id"] < pool_lanes],
          "coverage changed the pool flagship's first generation")
    cdict = cout1["coverage"]
    check(cdict["seen_fingerprints"] > 0 and cdict["refills_mutated"] > 0
          and cdict["generations"] == gens
          and sum(cdict["new_fp_per_gen"]) == cdict["seen_fingerprints"],
          f"coverage pool flagship's coverage: {cdict}")
    cwant = dict(want, seen_update=0, oracle=0,
                 tick_chunk_coverage=want["tick_chunk"],
                 credit_pass=want["tick_chunk"], tick_chunk_metrics=0,
                 threefry_tick_blocks=0)
    check(all(cov_launches[k] == v for k, v in cwant.items()),
          f"coverage pool flagship launches {cov_launches}, want {cwant} "
          "(K6-coverage, a credit pass and a K7 harvest a chunk, no K5 or "
          "K2 launch)")
    mutated = [r for r in crows1 if r["refill"] == "mutate"]
    check(len(mutated) >= REPLAY_MUTATED, f"{len(mutated)} mutated rows")
    replayed = []
    for r in mutated[::max(1, len(mutated) // REPLAY_MUTATED)][:REPLAY_MUTATED]:
        rc, out = run_cli(["replay", "--storm", "--seed", "12345", "--cluster",
                           str(r["cluster_id"]), "--ticks",
                           str(r["ticks_run"]), "--knobs-json",
                           json.dumps(r["knobs"])])
        check(rc == (1 if r["violations"] else 0)
              and all(out[k] == r[k] for k in
                      ("violations", "first_violation_tick", "committed")),
              f"mutated row {r['cluster_id']} replays as {out}")
        replayed.append(r["cluster_id"])
    emit({"phase": "coverage_pool_flagship", "argv": COVERAGE_POOL_FLAGSHIP,
          "rc": crc1, "retired": cout1["retired"], "launches": cov_launches,
          "runs": [{k: o[k] for k in ("wall_s", "steps_per_sec",
                                      "effective_steps_per_sec",
                                      "dispatch_gap_s", "device_wait_s",
                                      "host_overlap_s", "compile_s")}
                   | {"peak_memory_bytes": pk,
                      "seen_fingerprints": o["coverage"]["seen_fingerprints"],
                      "new_fingerprints_per_s":
                          o["coverage"]["new_fingerprints_per_s"]}
                   for o, pk in ((cout1, cpeak1), (cout2, cpeak2))],
          "coverage": {k: cdict[k] for k in (
              "bitmap_bits", "identity", "seen_fingerprints",
              "lane_new_fps_total", "generations", "new_fp_per_gen",
              "refills_mutated", "refills_fresh")},
          "mutated_rows": len(mutated), "replayed": replayed,
          "pool_flagship_steps_per_sec": [out1["steps_per_sec"],
                                          out2["steps_per_sec"]],
          "state_layout": cout1["state_layout"],
          "bytes_per_lane": cout1["bytes_per_lane"]})
    del cruns, crows1, crows2, rows1, rows2

    # ---- 6s. the sweep flagships through the CLI: the default 12-cell grid
    # (per-cluster dispatch) and an 8-cell grid (uniform dispatch), that one
    # again with the per-cluster layout forced: both layouts' reports equal
    sweeps = {}
    for label, argv, force in (("per_cluster", SWEEP_FLAGSHIP, False),
                               ("uniform", SWEEP_UNIFORM_FLAGSHIP, False),
                               ("uniform_forced", SWEEP_UNIFORM_FLAGSHIP, True)):
        set_counts()
        make = engine.make_sweep_fn
        if force:
            engine.make_sweep_fn = functools.partial(make, uniform_max_cells=0)
        try:
            t0 = time.perf_counter()
            rc, out = run_cli(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine.make_sweep_fn = make
        sl = read_counts()
        cells = len(out["cells"])
        runs_ = cells if out["dispatch"] == "uniform" else 1
        chunks_ = runs_ * -(-_flag(argv, "--ticks") // engine.KERNEL_CHUNK)
        check(rc == 0 and out["violating"] == 0
              and out["clusters_run"]
              == _flag(argv, "--clusters") // cells * cells
              and out["dispatch"] == ("per_cluster" if force or cells > 8
                                      else "uniform"),
              f"sweep {label}: rc {rc}, {out['dispatch']}, {out['violating']}")
        check(sl["oracle"] == sl["threefry_tick_blocks"] == 0
              and sl["tick_chunk"] == chunks_,
              f"sweep {label} launches {sl}")
        check(all(c["live"] > 0 for c in out["cells"]), f"sweep {label}: "
              "a cell made no progress")
        sweeps[label] = out
        tele = out["telemetry"]
        emit({"phase": f"sweep_{label}", "argv": argv, "rc": rc,
              "dispatch": out["dispatch"], "cells": cells,
              "cluster_steps_per_s": tele["steps_per_sec"],
              "execute_s": tele["execute_s"], "wall_s": round(wall, 3),
              "launches": sl,
              "committed_mean_by_cell": [c["committed_mean"]
                                         for c in out["cells"]]})
    same = {k: v for k, v in sweeps["uniform"].items()
            if k not in ("telemetry", "dispatch")}
    check(same == {k: v for k, v in sweeps["uniform_forced"].items()
                   if k not in ("telemetry", "dispatch")},
          "the sweep's two layouts report differently")

    # ---- 6ab. the fuzz flagship, the metrics fuzz flagship and the
    # coverage pool flagship each through the eager tick and through K6
    # (engine._advance's tick=), in turns eager, kernel, kernel, eager on
    # this card; the eager runs are cut to AB_EAGER_TICKS ticks (the pool's
    # to one chunk: --budget-ticks)
    pairs = {
        "fuzz": (FLAGSHIP[:FLAGSHIP.index("--check-deterministic")],
                 "--ticks"),
        "metrics": ([x for x in METRICS_FLAGSHIP
                     if x != "--check-deterministic"], "--ticks"),
        "coverage_pool": (COVERAGE_POOL_FLAGSHIP, "--budget-ticks"),
    }
    ab_out = {"phase": "ab_eager_vs_kernel", "card": _smi(), "clusters": 4096}
    eager_launches = {}  # each pair's first eager run: the eager route's
    advance, harvest = engine._advance, engine._harvest
    for pair, (argv0, depth) in pairs.items():
        ab = []
        for route in ("eager", "kernel", "kernel", "eager"):
            n_ab = (AB_EAGER_TICKS if route == "eager"
                    else _flag(FLAGSHIP, "--ticks"))
            at = argv0.index(depth) + 1
            argv = argv0[:at] + [str(n_ab)] + argv0[at + 1:]
            set_counts()
            # every verb's chunks go through _advance, a pool's harvests
            # through _harvest (K7 or the plain one)
            engine._advance = functools.partial(advance, tick=route)
            engine._harvest = functools.partial(harvest, tick=route)
            try:
                rc, lines = run_cli_lines(argv)
            finally:
                engine._advance, engine._harvest = advance, harvest
            out = lines[-1]
            ran = read_counts()
            ticks_run = out.get("lane_ticks", n_ab)  # a pool's whole chunks
            check(rc == 0 and out.get("violating",
                                      out.get("retired_violating")) == 0
                  and (ran["tick_chunk"] > 0) == (route == "kernel")
                  and (ran["harvest"] > 0) == (route == "kernel"
                                               and "pool" in pair)
                  and (ran["oracle"] == ticks_run) == (route == "eager"),
                  f"A/B {pair} {route} run: rc {rc}, launches {ran}")
            if route == "eager":
                eager_launches.setdefault(pair, (ran, ticks_run))
            tele = out.get("telemetry", out)
            ab.append({"route": route, "ticks": n_ab,
                       "cluster_steps_per_s": tele["steps_per_sec"],
                       "wall_s": tele.get("execute_s", out.get("wall_s")),
                       "launches": {k: v for k, v in ran.items() if v}})
        rate = {r: sum(x["cluster_steps_per_s"] for x in ab
                       if x["route"] == r) / 2 for r in ("eager", "kernel")}
        ab_out[pair] = {"argv": argv0, "runs": ab,
                        "kernel_over_eager": rate["kernel"] / rate["eager"]}
    (em, em_ticks), (ec, ec_ticks) = (eager_launches["metrics"],
                                      eager_launches["coverage_pool"])
    check(em["latency_fold"] == em["oracle_metrics"] == em_ticks
          and em["threefry_tick_blocks"] == -(-em_ticks // engine.DRAW_CHUNK)
          and ec["seen_update"] == ec_ticks and em["tick_chunk"] == 0,
          f"the eager route's launches: metrics {em}, coverage pool {ec}")
    emit(ab_out)

    # ---- 6g. the raft layer's game-day gates (config.profile_gates) with
    # metrics on at their bench scale: no violation, liveness (acked ops a
    # lane) at or above the floor, p99 at or below the ceiling
    # (a profile with a workload runs as a kv leg, as bench.py runs it)
    gates = {}
    with prng.layout(True):
        for name, g in config.profile_gates().items():
            cfg = config.storm_profiles()[name][0].replace(metrics=True)
            lanes_g, ticks_g = g["bench_scale"]
            if g["workload"]:
                rep_g = kv.kv_fuzz(
                    cfg.replace(p_client_cmd=0.0, compact_at_commit=False),
                    kv.KvConfig(p_get=0.3, p_put=0.2, **g["workload"]),
                    12345, lanes_g, ticks_g, device=dev)
            else:
                rep_g = engine.fuzz(cfg, 12345, lanes_g, ticks_g, device=dev)
            lat = metrics.latency_summary(rep_g.lat_hist.sum(axis=0))
            live = round(lat["ops"] / lanes_g, 2)
            gates[name] = {"violating": rep_g.n_violating, "liveness": live,
                           "floor": g["liveness_floor"],
                           "p99_ticks": lat["p99_ticks"],
                           "ceiling": g["p99_ceiling"],
                           **({"workload": g["workload"]} if g["workload"]
                              else {})}
            check(rep_g.n_violating == 0 and live >= g["liveness_floor"]
                  and lat["p99_ticks"] is not None
                  and lat["p99_ticks"] <= g["p99_ceiling"],
                  f"profile gate {name} fails: {gates[name]}")
    emit({"phase": "profile_gates", "seed": 12345, "gates": gates})

    # ---- 6k. the kv path: K9 and K9-metrics against the plain service
    # tick, K6-kv and K6-metrics-kv against the plain route, then the kv
    # flagships through the CLI (K6-kv once a chunk) and the
    # eager-vs-kernel A/B
    emit(_kv_k9(dev, errs))
    emit(_kv_k6kv(dev, errs))
    kv_launches, kv_launches_m = _kv_path(dev)

    # ---- 6l. the ctrler path: K10 and K10-metrics against the plain
    # service tick, K6-ctrler and K6-metrics-ctrler against the plain
    # route, then the ctrler flagships through the CLI (K6-ctrler once a
    # chunk), the sweep rows, a replay and the eager-vs-kernel A/B
    emit(_ctrler_k10(dev, errs))
    emit(_ctrler_k6ctrler(dev, errs))
    ctrler_launches, ctrler_launches_m = _ctrler_path(dev)

    # ---- 6m. the shardkv path: K11 and K11-metrics (off the path) against
    # the plain service tick in each mode; then in each mode K6-shardkv and
    # K6-metrics-shardkv against the plain route, the flagships through the
    # CLI (K6-shardkv once a chunk), the eager and CPU routes' reports and
    # the eager-vs-kernel A/B
    # (in a child process of its own, with K6-shardkv's timing and the
    # shardkv ticks' profiles: see _shardkv_section)
    shardkv_launches, k6s_timing = _shardkv_section(errs)

    # ---- 7. kernel timing at the flagship shapes
    b, n_nodes = 4096, 5
    total = step._block_total(n_nodes)
    fcfg, fs, fk, fkn = _flagship_state(dev, b)
    tt, chunk = fs.tick + 1, engine.DRAW_CHUNK
    hp_x = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    hp_k, hp_z = fk, torch.zeros_like(hp_x)
    args2 = oracle_args(fs)
    for a, bb in zip(K2.oracle(*args2), K2.oracle_plain(*args2)):
        errs["oracle"] = max(errs["oracle"], max_abs_err(a, bb))
    check(errs["oracle"] == 0, "oracle kernel differs at the flagship shape")
    k2_out = K2.oracle(*args2)
    # K6 at the flagship's shape: one chunk from the storm state at tick
    # 200, its template instance and (one more entry a message) the
    # runtime one, both layouts
    rcfg = fcfg.replace(ae_max=K6.SHAPE_AE + 1)
    for flag in (True, False):
        with prng.layout(flag):
            for c in (fcfg, rcfg):
                _k6_vs_plain(c, fs, fk, fkn, chunk, chunk, errs,
                             f"flagship shape {flag} ae_max {c.ae_max}")
    emit({"phase": "tick_chunk_flagship_shape", "clusters": b,
          "from_tick": int(fs.tick[0]), "ticks": chunk,
          "instances": [K6.instance(fcfg), K6.instance(rcfg)],
          "layouts": ["partitionable", "legacy"],
          "max_abs_err": errs["tick_chunk"]})
    fs_bytes = nbytes(*fs[:state.METRIC_LEAF0])
    counts = read_counts()
    k2_rot = [args2] + [tuple(x.clone() for x in args2)
                        for _ in range(rotations(nbytes(*args2)) - 1)]

    # the metrics flagship's shape: a metrics-on state after 200 ticks, the
    # latency fold's inputs of its last tick kept as the tick gives them
    mcfg = fcfg.replace(metrics=True)
    ms_ = state.init_cluster(mcfg, fk, fkn)
    for _ in range(199):
        ms_ = step.step_cluster(mcfg, ms_, fk, fkn)
    fold_in = KeepFirst(K4.latency_fold, lambda *a: a)
    K4.latency_fold = fold_in
    try:
        ms_ = step.step_cluster(mcfg, ms_, fk, fkn)
    finally:
        K4.latency_fold = fold_in.fn
    k4_args = fold_in.kept[0]
    _k4_vs_plain(_to(k4_args, "cpu"), dev, errs, "storm tick 200")
    emit({"phase": "k4_vs_plain_storm_tick", "clusters": b, "tick": 200,
          "ops_folded": int(k4_args[1].sum()),
          "max_abs_err": errs["latency_fold"]})
    args2m = oracle_args(ms_)
    _k2m_vs_plain(ms_, errs, "flagship shape")
    k2m_out = K2.oracle(*args2m, log_tick=ms_.log_tick)
    k2m_rot = [(args2m, ms_.log_tick)] + [
        (tuple(x.clone() for x in args2m), ms_.log_tick.clone())
        for _ in range(rotations(nbytes(*args2m, ms_.log_tick)) - 1)]
    k4_rot = [k4_args] + [_clone(k4_args) for _ in range(
        rotations(nbytes(*_flat(k4_args))) - 1)]
    hm_ = state.state_to_numpy(ms_)
    for label, h in (("metrics_storm@200", hm_),
                     ("metrics_edge", state.planted_edge_state(mcfg, hm_, b))):
        _k3_vs_plain(mcfg, h, dev, errs, label)
    mp = K3.pack_state(mcfg, ms_)
    check(nbytes(*mp) == METRICS_BYTES_PER_LANE * b,
          f"metrics-on packed carry {nbytes(*mp) / b} B a lane")
    emit({"phase": "k3_vs_plain_metrics_carry", "clusters": b,
          "states": ["metrics_storm@200", "metrics_edge"],
          "packed_bytes_per_lane": nbytes(*mp) / b,
          "max_abs_err": max(errs["pack_state"], errs["unpack_state"])})
    del hm_, mp
    # K3 at the shape the pool flagship gives it: the wide carry its first
    # harvest packed, and a copy planted at the packed bounds' edges (every
    # lane at its own tick)
    check(len(harvested.kept) == 1 and harvested.kept[0]["tick"].shape[0] == b,
          f"pool flagship carry not kept: {len(harvested.kept)}")
    h_pool = harvested.kept.pop()
    for label, h in (("pool_harvest", h_pool),
                     ("pool_edge", state.planted_edge_state(fcfg, h_pool, b))):
        _k3_vs_plain(fcfg, h, dev, errs, label)
    emit({"phase": "k3_vs_plain_pool_shape", "clusters": b,
          "n_nodes": n_nodes, "states": ["pool_harvest", "pool_edge"],
          "max_abs_err": max(errs["pack_state"], errs["unpack_state"])})
    del h_pool
    fp = K3.pack_state(fcfg, fs)
    k3p_rot = [fs] + [state.ClusterState(*(x.clone() for x in fs))
                      for _ in range(rotations(nbytes(*fs)) - 1)]
    k3u_rot = [fp] + [state.PackedClusterState(*(x.clone() for x in fp))
                      for _ in range(rotations(nbytes(*fp)) - 1)]
    # one operation per element read or written; the bytes bound it
    k3_ops = sum(x.numel() for x in fs) + sum(x.numel() for x in fp)

    def k2_call(i):
        return K2.oracle(*k2_rot[i % len(k2_rot)])

    def k2_plain(i):
        return K2.oracle_plain(*k2_rot[i % len(k2_rot)])

    def k2m_call(i):
        a, lt = k2m_rot[i % len(k2m_rot)]
        return K2.oracle(*a, log_tick=lt)

    def k2m_plain(i):
        a, lt = k2m_rot[i % len(k2m_rot)]
        return K2.oracle_plain(*a, log_tick=lt)

    def k4_call(i):
        return K4.latency_fold(*k4_rot[i % len(k4_rot)])

    def k4_plain(i):
        return metrics.latency_fold_plain(*k4_rot[i % len(k4_rot)])

    k4_out = _flat(K4.latency_fold(*k4_args))
    n_ph = k4_args[2].shape[1]

    # K5 at the coverage pool flagship's shape (K5 runs on its eager
    # route): the inputs the pool's 200th tick gives it, its first 199
    # ticks' fingerprints stamped by K6-coverage (the first generation's
    # lanes are the fuzz flagship's clusters under the base knobs, so its
    # tick-200 state is fs), against the plain version on the same inputs
    ccfg5 = config.CoverageConfig().fingerprint_key()
    k5_seen = torch.full((1, ccfg5.bitmap_bits), coverage.UNSEEN,
                         dtype=torch.int32, device=dev)
    k5_nf = torch.zeros(b, dtype=torch.int32, device=dev)
    s199 = engine._advance(fcfg, state.init_cluster(fcfg, fk, fkn), fk, fkn,
                           199, K6.Seen(ccfg5, k5_seen, None, k5_nf, 0))
    s200 = engine._advance(fcfg, s199, fk, fkn, 1)
    check(all(torch.equal(x, y) for x, y in zip(s200, fs)),
          "the coverage pool's tick-200 state differs from the flagship's")
    del s199, s200
    k5_t = 199
    k5_node = [fs.role, fs.alive, fs.term, fs.commit, fs.violations]
    k5_rows = None
    got = K5.seen_update(ccfg5, *k5_node, k5_rows, k5_seen.clone(),
                         k5_nf.clone(), k5_t)
    want5 = coverage.seen_update_plain(ccfg5, *k5_node, k5_rows,
                                       k5_seen.clone(), k5_nf.clone(), k5_t)
    for a, bb in zip(got, want5):
        errs["seen_update"] = max(errs["seen_update"], max_abs_err(a, bb))
    check(errs["seen_update"] == 0,
          "K5 differs from its plain version on the coverage flagship's tick")
    emit({"phase": "k5_vs_plain_coverage_tick", "clusters": b,
          "tick": k5_t + 1, "seen_bits": int(coverage.seen_bits(k5_seen)),
          "credited": int((want5[1] - k5_nf).sum()),
          "max_abs_err": errs["seen_update"]})
    k5_rot = [tuple(k5_node)] + [tuple(x.clone() for x in k5_node)
                                 for _ in range(rotations(nbytes(*k5_node)) - 1)]
    k5_ok = int((k5_node[4] == 0).sum())

    def k5_call(i):
        return K5.seen_update(ccfg5, *k5_rot[i % len(k5_rot)], None, k5_seen,
                              k5_nf, k5_t + 1 + i)

    def k5_plain(i):
        return coverage.seen_update_plain(ccfg5, *k5_rot[i % len(k5_rot)],
                                          None, k5_seen, k5_nf, k5_t + 1 + i)

    k6_table = K6.knob_table(fkn, b)
    k6_m = engine.KERNEL_CHUNK  # ticks a launch, as the engine launches K6

    def k6_call(m):
        return lambda i: K6.tick_chunk(fcfg, fs, fk, fkn, m, k6_table)

    # K6's bytes: the wide state read and written once, the keys and knob
    # rows read once
    k6_bytes = 2 * fs_bytes + nbytes(fk) + b * 28 * 4

    # K6-metrics at the metrics flagship's shape (ms_, the metrics-on state
    # at tick 200) and K6-coverage at the coverage pool flagship's (fs under
    # [B] knob rows, the seen-set of its first 199 ticks, run-wide tick
    # 200), each held against its plain version over a chunk first; the
    # credit pass on the indices of one 256-tick K6-coverage launch
    _k6_variant_vs_plain(mcfg, ms_, fk, fkn, chunk, chunk, errs,
                         "metrics flagship shape")
    cov_kn = fkn.broadcast(b)
    cov_table = K6.knob_table(cov_kn, b)
    cov_at = K6.Seen(ccfg5, k5_seen.clone(), None, k5_nf.clone(), k5_t + 1)
    _k6_variant_vs_plain(fcfg, fs, fk, cov_kn, chunk, chunk, errs,
                         "coverage flagship shape", cov_at._replace(
                             seen=cov_at.seen.clone(),
                             new_fps=cov_at.new_fps.clone()))
    fp_buf = torch.empty((k6_m, b), dtype=torch.int32, device=dev)
    K6._launch(fcfg, fs, fk, cov_kn, k6_m, K6._lib(K6.variant(False, True)),
               torch.cuda.current_stream(dev).cuda_stream, table=cov_table,
               cov=cov_at, fp=fp_buf)
    fp_ok = int((fp_buf >= 0).sum())
    k6m_bytes = 2 * nbytes(*ms_) + nbytes(fk) + b * 28 * 4

    def k6m_call(m):
        return lambda i: K6.tick_chunk(mcfg, ms_, fk, fkn, m, k6_table)

    def k6c_call(m):
        return lambda i: K6.tick_chunk(fcfg, fs, fk, cov_kn, m, cov_table,
                                       cov_at)

    def k6c_bytes(m):
        """K6-coverage's bytes for m ticks: K6's, the fp row written each
        tick, and a clean lane-tick's stamp read and written."""
        return k6_bytes + 4 * m * b + 8 * fp_ok * m // k6_m

    def credit_call(i):
        return K5.credit_pass(fp_buf, cov_at.seen, cov_at.new_fps, k5_t + 1)

    def credit_plain(i):
        return K5.credit_plain(fp_buf, cov_at.seen, cov_at.new_fps, k5_t + 1)

    def k6_ops(m):
        """K6's counted operations for m ticks: per cluster and tick the
        tick's total + 2 hashes and total xors. The raft logic around them
        is left out of the bound (k6_raft_ops)."""
        return b * m * ((2 + total) * OPS_PER_HASH + total)

    def k6_raft_ops(m):
        """An estimate of the raft logic's operations for m ticks, not
        counted from the code: per cluster and tick n(n-1)/2 x cap x 8
        (log matching) + n x cap x 15 (shadow walk, compaction, the
        AppendEntries hint, as if each ran every tick) + 60 n^2 (delivery,
        sends) + 40 n."""
        return b * m * (n_nodes * (n_nodes - 1) // 2 * 64 * 8
                        + n_nodes * 64 * 15 + 60 * n_nodes ** 2
                        + 40 * n_nodes)

    # name: (device ms, call ms, plain ms, bytes, operations)
    timing = {
        # one launch of the engine's KERNEL_CHUNK ticks, as K6's row; the
        # metric leaves add their bytes, the fold a few operations a slot
        # (left out: the bound counts the hashes, as K6's)
        "tick_chunk_metrics": (
            device_ms(k6m_call(k6_m), "tick_chunk_kernel", iters=5,
                      warmup=1),
            cuda_ms(k6m_call(k6_m), iters=5, warmup=1),
            cuda_ms(lambda i: K6.tick_chunk_plain(mcfg, ms_, fk, fkn, k6_m),
                    iters=1, warmup=0),
            k6m_bytes, k6_ops(k6_m)),
        # the fingerprint adds per lane-tick n^2 compares, about 12
        # operations a node and 12 for the hash (K5's count)
        "tick_chunk_coverage": (
            device_ms(k6c_call(k6_m), "tick_chunk_kernel", iters=5,
                      warmup=1),
            cuda_ms(k6c_call(k6_m), iters=5, warmup=1),
            cuda_ms(lambda i: K6.tick_chunk_plain(
                fcfg, fs, fk, cov_kn, k6_m, cov_at._replace(
                    seen=cov_at.seen.clone(),
                    new_fps=cov_at.new_fps.clone())), iters=1, warmup=0),
            k6c_bytes(k6_m),
            k6_ops(k6_m) + k6_m * b * (n_nodes * n_nodes + 12 * n_nodes
                                       + 12)),
        # fp read once, a stamp read for each clean lane-tick, the credits
        # read and written; about 4 operations a lane-tick
        "credit_pass": (
            device_ms(credit_call, "credit_kernel"),
            cuda_ms(credit_call),
            cuda_ms(credit_plain, iters=20),
            nbytes(fp_buf) + 4 * fp_ok + 2 * nbytes(cov_at.new_fps),
            4 * k6_m * b),
        # one launch of the engine's KERNEL_CHUNK ticks
        "tick_chunk": (
            device_ms(k6_call(k6_m), "tick_chunk_kernel", iters=5,
                      warmup=1),
            cuda_ms(k6_call(k6_m), iters=5, warmup=1),
            cuda_ms(lambda i: K6.tick_chunk_plain(fcfg, fs, fk, fkn, k6_m),
                    iters=1, warmup=0),
            k6_bytes, k6_ops(k6_m)),
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
        # the metrics instance also reads log_tick and writes shadow_sub;
        # one more operation per node and lane in the walk
        "oracle_metrics": (
            device_ms(k2m_call, "oracle_kernel"),
            cuda_ms(k2m_call),
            cuda_ms(k2m_plain, iters=20),
            nbytes(*args2m, ms_.log_tick) + nbytes(*k2m_out),
            b * (n_nodes * (n_nodes - 1) // 2 * 64 * 8 + n_nodes * 64 * 13
                 + 64 * 10)),
        # per op: (1 + P) rows of a bucket (about 4 operations) and a sum,
        # 3 for the argmax; the bytes bound it
        "latency_fold": (
            device_ms(k4_call, "latency_fold_kernel"),
            cuda_ms(k4_call),
            cuda_ms(k4_plain, iters=20),
            nbytes(*_flat(k4_args)) + nbytes(*k4_out),
            b * 64 * ((1 + n_ph) * 5 + 3)),
        # the node rows and violation word read once, each credit read and
        # written, one stamp read and written a clean lane; per lane n^2
        # compares, about 12 operations a node (quantize, fold) and 12 for
        # the hash
        "seen_update": (
            device_ms(k5_call, "seen_update_kernel"),
            cuda_ms(k5_call),
            cuda_ms(k5_plain, iters=20),
            nbytes(*k5_node) + 2 * nbytes(k5_nf) + 8 * k5_ok,
            b * (n_nodes * n_nodes + 12 * n_nodes + 12)),
        # one direction reads one form and writes the other
        "pack_state": (
            device_ms(lambda i: K3.pack_state(fcfg, k3p_rot[i % len(k3p_rot)]),
                      "pack_kernel"),
            cuda_ms(lambda i: K3.pack_state(fcfg, k3p_rot[i % len(k3p_rot)])),
            cuda_ms(lambda i: state.pack_state(fcfg, k3p_rot[i % len(k3p_rot)]),
                    iters=20),
            nbytes(*fs) + nbytes(*fp), k3_ops),
        "unpack_state": (
            device_ms(lambda i: K3.unpack_state(fcfg, k3u_rot[i % len(k3u_rot)]),
                      "unpack_kernel"),
            cuda_ms(lambda i: K3.unpack_state(fcfg, k3u_rot[i % len(k3u_rot)])),
            cuda_ms(lambda i: state.unpack_state(fcfg,
                                                 k3u_rot[i % len(k3u_rot)]),
                    iters=20),
            nbytes(*fs) + nbytes(*fp), k3_ops),
    }
    # K7 at the pool flagship's harvest: the tick-200 state with every lane
    # retiring (horizon 0, so each call refills the whole batch; the kernel
    # writes the refilled lanes into its copy of the state), the plain pool
    # and the guided coverage pool (half the lanes productive, restored
    # before each call)
    k7_state = state.ClusterState(*(x.contiguous().clone() for x in fs))
    k7_ids = torch.arange(b, dtype=torch.int32, device=dev)
    k7_book = torch.tensor(b, dtype=torch.int32, device=dev)
    k7_fps = k7_ids % 2
    k7_cov = K7.Cov(config.CoverageConfig(), fkn.broadcast(b),
                    torch.zeros(b, dtype=torch.int32, device=dev),
                    k7_fps.clone(), torch.full(
                        (1, 1 << 16), coverage.UNSEEN, dtype=torch.int32,
                        device=dev))
    k7_cov.seen[0, ::3] = 5

    def k7_call(i):
        return K7.harvest(fcfg, k7_state, k7_ids, k7_book, 12345, 0, fkn,
                          False)

    def k7c_call(i):
        k7_cov.new_fps.copy_(k7_fps)
        return K7.harvest(fcfg, k7_state, k7_ids, k7_book, 12345, 0, fkn,
                          False, k7_cov)

    def k7_plain(i, cov=None):
        return K7.harvest_plain(fcfg, k7_state, k7_ids, k7_book, 12345, 0,
                                fkn, False, cov)

    k7_cols = K7.snapshot_cols(fs, False)
    # read: violations, tick and the other 5 scalars, the ids; written:
    # the snapshot row, new ids and keys, the fresh state (every lane)
    k7_bytes = b * (7 * 4 + 4 + 4 * k7_cols + 4 + 16) + 8 + fs_bytes
    # a lane's hashes: its key, then 4 for each election timer (the split
    # and the two bit streams); the coverage refill adds 2 a knob (the
    # salted key, the word) and about 40 float operations of the exp
    k7_ops = b * (1 + 4 * n_nodes) * OPS_PER_HASH
    k7c_bytes = (k7_bytes + b * 4 * 13 + nbytes(k7_cov.seen)
                 + b * 2 * (4 * 9 + 8))
    k7c_ops = k7_ops + b * 9 * (2 * OPS_PER_HASH + 40)
    # K8 at explain's shape: one cluster, the bug cluster's tick 87 -> 88
    with prng.layout(True):
        k8_cfg = config.storm_profiles()["durability"][0].replace(
            bug="ack_before_fsync")
        k8_keys = engine.cluster_keys(5, 1, dev, id0=32)
        k8_kn = k8_cfg.knobs(dev)
        k8_prev = engine._advance(k8_cfg, state.init_cluster(
            k8_cfg, k8_keys, k8_kn), k8_keys, k8_kn, EXPLAIN_FVT)
        k8_nxt = K6.tick_chunk(k8_cfg, k8_prev, k8_keys, k8_kn, 1)
    k8_out = torch.empty((1, K8.record_width(k8_cfg)), dtype=torch.int32,
                         device=dev)
    K8.record(k8_cfg, k8_prev, k8_nxt, k8_out)
    errs["record"] = max(errs["record"], max_abs_err(
        k8_out, K8.record_plain(k8_prev, k8_nxt)))
    check(errs["record"] == 0, "K8 differs from plain at explain's shape")
    k8_copied = [getattr(k8_nxt, f) for f in K8.NODE_ROWS + K8.LATER]
    # read: the copied post-tick leaves, adj, the five pre-tick mailboxes
    # and the tick; written: the row. Per mailbox n^2 compares of 4
    # operations, a row mask of n
    k8_bytes = (nbytes(*k8_copied, k8_nxt.adj, k8_nxt.tick, k8_out)
                + sum(nbytes(getattr(k8_prev, m)) for m in K8.MAILS))
    k8_ops = 5 * 4 * k8_cfg.n_nodes ** 2 + 2 * k8_cfg.n_nodes ** 2
    timing["harvest"] = (
        device_ms(k7_call, ("ids_kernel", "lane_kernel"), iters=20),
        cuda_ms(k7_call, iters=20),
        cuda_ms(k7_plain, iters=5, warmup=1),
        k7_bytes, k7_ops)
    timing["harvest_coverage"] = (
        device_ms(k7c_call, ("ids_kernel", "lane_kernel"), iters=20),
        cuda_ms(k7c_call, iters=20),
        cuda_ms(lambda i: k7_plain(i, k7_cov), iters=5, warmup=1),
        k7c_bytes, k7c_ops)
    timing["record"] = (
        device_ms(lambda i: K8.record(k8_cfg, k8_prev, k8_nxt, k8_out),
                  "record_kernel"),
        cuda_ms(lambda i: K8.record(k8_cfg, k8_prev, k8_nxt, k8_out)),
        cuda_ms(lambda i: K8.record_plain(k8_prev, k8_nxt), iters=20),
        k8_bytes, k8_ops)
    # K6-trace at explain's shape: one launch of EXPLAIN_TICKS ticks of the
    # bug cluster from tick 0, each tick's row into a [T, 1, W] buffer, as
    # the traced replay runs it. Bytes: the wide state read and written
    # once, the key and knob rows, the rows written; operations: the
    # hashes, as K6's bound counts them
    with prng.layout(True):
        k6t_s = state.init_cluster(k8_cfg, k8_keys, k8_kn)
    k6t_table = K6.knob_table(k8_kn, 1)
    k6t_rows = torch.empty((EXPLAIN_TICKS, 1, K8.record_width(k8_cfg)),
                           dtype=torch.int32, device=dev)
    k6t_plain_rows = torch.empty_like(k6t_rows)

    def k6t_call(i):
        return K6.tick_chunk(k8_cfg, k6t_s, k8_keys, k8_kn, EXPLAIN_TICKS,
                             k6t_table, trace=k6t_rows)

    timing["tick_chunk_trace"] = (
        device_ms(k6t_call, "tick_chunk_kernel", iters=10, warmup=2),
        cuda_ms(k6t_call, iters=10, warmup=2),
        cuda_ms(lambda i: K6.tick_chunk_plain(
            k8_cfg, k6t_s, k8_keys, k8_kn, EXPLAIN_TICKS,
            trace=k6t_plain_rows), iters=1, warmup=0),
        2 * nbytes(*k6t_s[:state.METRIC_LEAF0]) + nbytes(k8_keys) + 28 * 4
        + nbytes(k6t_rows),
        EXPLAIN_TICKS * ((2 + total) * OPS_PER_HASH + total))
    check(torch.equal(k6t_rows, k6t_plain_rows),
          "K6-trace's rows differ from the plain version's at explain's "
          "shape")
    # K9 and K9-metrics at the kv flagship's shape, and K6-kv and
    # K6-metrics-kv a 256-tick chunk there
    kv_timing, kv_bytes = _kv_timing(dev)
    timing.update(kv_timing)
    timing.update(_k6kv_timing(dev))
    # K10 and K10-metrics at the ctrler flagship's shape, and K6-ctrler and
    # K6-metrics-ctrler a 256-tick chunk there
    ctrler_timing, ctrler_bytes = _ctrler_timing(dev)
    timing.update(ctrler_timing)
    timing.update(_k6ctrler_timing(dev))
    # K6 one tick a launch at explain's shape, as the traced replay runs it
    k6_one_tick_ms = device_ms(
        lambda i: K6.tick_chunk(k8_cfg, k8_prev, k8_keys, k8_kn, 1),
        "tick_chunk_kernel")
    del k7_state
    card = _card()

    def k6_bounds(m):
        """K6's bound for m ticks, and the bound if the raft estimate
        counted."""
        t_bytes, ops_s = k6_bytes / PEAK_BYTES_S, card["int32_ops_per_s"]
        return {"bound_ms": max(t_bytes, k6_ops(m) / ops_s) * 1e3,
                "bound_ms_with_raft_estimate": max(
                    t_bytes, (k6_ops(m) + k6_raft_ops(m)) / ops_s) * 1e3}

    # K6 a 32-tick chunk, PR 6's unit
    k6_32 = {"ticks": chunk,
             "ms": device_ms(k6_call(chunk), "tick_chunk_kernel", iters=20),
             "call_ms": cuda_ms(k6_call(chunk), iters=20),
             **k6_bounds(chunk)}
    del k2_rot, k3p_rot, k3u_rot, k2m_rot, k4_rot, k5_rot, fp_buf
    set_counts(counts)  # timing launches are not main-path launches
    emit({"phase": "timing", "clusters": b, "device_ms_from": "torch.profiler",
          "l2_cold_rotations": {"oracle": rotations(nbytes(*args2)),
                                "latency_fold": rotations(
                                    nbytes(*_flat(k4_args))),
                                "seen_update": rotations(nbytes(*k5_node)),
                                "pack_state": rotations(nbytes(*fs)),
                                "unpack_state": rotations(nbytes(*fp))},
          "tick_chunk_32": k6_32,
          "tick_chunk_launch": {"ticks": k6_m, **k6_bounds(k6_m)},
          "tick_chunk_one_tick_one_cluster_ms": k6_one_tick_ms,
          "coverage_clean_lane_ticks": fp_ok,
          "kv_tick_bytes": kv_bytes,
          "ctrler_tick_bytes": ctrler_bytes,
          "shapes": {"tick_chunk": [k6_m, b, fs_bytes // b],
                     "harvest": [b, k7_cols, fs_bytes // b],
                     "record": [1, K8.record_width(k8_cfg)],
                     "tick_blocks": [chunk, b, total], "hash_pairs": [b, n_nodes],
                     "oracle_logs": [b, n_nodes, 64],
                     "latency_fold": [b, 64, n_ph],
                     "seen_update": [b, n_nodes, ccfg5.bitmap_bits],
                     "pack_bytes": [nbytes(*fs), nbytes(*fp)]}})

    # ---- 8. where a flagship tick's and a pool harvest's time goes
    # (torch.profiler), and the bytes behind B2-rest's bound
    emit(_k6_phases(fcfg, fs, fk, fkn, chunk))
    emit(_k6_scaling(fcfg, fs, fk, fkn, chunk))
    emit(_k6_metrics_phases(fcfg, fs, mcfg, ms_, fk, fkn, chunk))
    emit(_k6_sass(card, k6_m, b, timing["tick_chunk"][0], k6_bytes))
    emit(_k6_sass(card, k6_m, b, timing["tick_chunk_metrics"][0], k6m_bytes,
                  "tick_metrics"))
    emit(_k6_sass(card, k6_m, b, timing["tick_chunk_coverage"][0],
                  k6c_bytes(k6_m), "tick_coverage"))
    # a harvest's device operations, before the eager tick's long profiled
    # windows (after those CUPTI handed the harvest's short one no record)
    emit(_profile_harvest(fs, fk, fkn))
    emit(_profile_harvest(fs, fk, fkn, config.CoverageConfig()))
    emit(_kv_phases(dev))
    emit(_ctrler_phases(dev))
    # the kv and ctrler ticks' profiles and K11's timing, in a fresh
    # process (see _child)
    late = _child("--late-profiles", "late_profiles")
    emit(_profile_ticks(fcfg, fs, fk, fkn, chunk, "profile_k6", tick="kernel"))
    emit(_profile_ticks(fcfg, fs, fk, fkn, EAGER_PROFILE_TICKS, "profile"))
    emit(_profile_ticks(mcfg, ms_, fk, fkn, chunk, "profile_k6_metrics",
                        tick="kernel"))
    emit(_profile_ticks(mcfg, ms_, fk, fkn, EAGER_PROFILE_TICKS,
                        "profile_metrics"))
    # a coverage tick: the flagship tick under [B] knob rows, then its
    # fingerprints: inside K6-coverage (and the credit pass), or K5
    for phase, route in (("profile_k6_coverage", "kernel"),
                         ("profile_coverage", "eager")):
        emit(_profile_ticks(fcfg, fs, fk, cov_kn, chunk if route == "kernel"
                            else EAGER_PROFILE_TICKS, phase, tick=route,
                            cov=cov_at))
    del cov_at
    wide_bpl, packed_bpl = nbytes(*fs) / b, nbytes(*fp) / b
    # a harvest reads the chunk's wide state, ids and keys once and writes
    # the packed carry, the [B, 9] snapshot and the new ids and keys once
    harvest_bpl = wide_bpl + packed_bpl + 9 * 4 + 2 * (4 + 16)
    emit({"phase": "bytes", "wide_bytes_per_lane": wide_bpl,
          "packed_bytes_per_lane": packed_bpl,
          "metrics_wide_bytes_per_lane": nbytes(*ms_) / b,
          "draw_bytes_per_lane_tick": total * 8,
          # the wide state read and written once per tick, plus the tick's
          # draw words
          "b2_rest_bound_ms_per_tick":
              b * (2 * wide_bpl + total * 8) / PEAK_BYTES_S * 1e3,
          "b4_harvest_bytes_per_lane": harvest_bpl,
          "b4_harvest_bound_ms": b * harvest_bpl / PEAK_BYTES_S * 1e3})
    emit(_harvest_routes(fs, fk, fkn, errs))
    # K11 and K11-metrics at the shardkv flagship's shape (timed in the
    # late profiles' process)
    shardkv_timing = {k: tuple(v) for k, v in late["shardkv_timing"].items()}
    shardkv_bytes = late["shardkv_bytes"]
    timing.update(shardkv_timing)
    # K6-shardkv and K6-metrics-shardkv a chunk there, in each mode (timed
    # in the shardkv section's process)
    timing.update(k6s_timing)
    emit({"phase": "shardkv_timing", "card": _smi(),
          "shardkv_tick_bytes": shardkv_bytes,
          **{k: dict(zip(("ms", "call_ms", "plain_ms", "bytes", "operations"),
                         v)) for k, v in shardkv_timing.items()}})
    emit(_shardkv_phases(dev))

    emit(card)
    # name: (label, source, the reference region it replaces)
    sources = {
        "tick_chunk": ("K6", "madraft_tpu_torch/csrc/tick.cu",
                       "madraft_tpu/tpusim/step.py:293"),
        "tick_chunk_metrics": ("K6-metrics", "madraft_tpu_torch/csrc/tick.cu",
                               "madraft_tpu/tpusim/step.py:1008"),
        "tick_chunk_coverage": ("K6-coverage",
                                "madraft_tpu_torch/csrc/tick.cu",
                                "madraft_tpu/tpusim/engine.py:1342"),
        "credit_pass": ("credit pass", "madraft_tpu_torch/csrc/tick.cu",
                        "madraft_tpu/tpusim/engine.py:1356"),
        "threefry_tick_blocks": ("K1", "madraft_tpu_torch/csrc/threefry.cu",
                                 "madraft_tpu/tpusim/step.py:128"),
        "threefry_hash_pairs": ("K1", "madraft_tpu_torch/csrc/threefry.cu",
                                "madraft_tpu/tpusim/engine.py:95"),
        "oracle": ("K2", "madraft_tpu_torch/csrc/oracle.cu",
                   "madraft_tpu/tpusim/step.py:961"),
        "oracle_metrics": ("K2-metrics", "madraft_tpu_torch/csrc/oracle.cu",
                           "madraft_tpu/tpusim/step.py:1008"),
        "latency_fold": ("K4", "madraft_tpu_torch/csrc/metrics.cu",
                         "madraft_tpu/tpusim/metrics.py:45"),
        "seen_update": ("K5", "madraft_tpu_torch/csrc/coverage.cu",
                        "madraft_tpu/tpusim/coverage.py:100"),
        "pack_state": ("K3", "madraft_tpu_torch/csrc/pack.cu",
                       "madraft_tpu/tpusim/state.py:561"),
        "unpack_state": ("K3", "madraft_tpu_torch/csrc/pack.cu",
                         "madraft_tpu/tpusim/state.py:656"),
        "harvest": ("K7", "madraft_tpu_torch/csrc/harvest.cu",
                    "madraft_tpu/tpusim/engine.py:837"),
        "harvest_coverage": ("K7-coverage",
                             "madraft_tpu_torch/csrc/harvest.cu",
                             "madraft_tpu/tpusim/engine.py:1368"),
        "record": ("K8", "madraft_tpu_torch/csrc/trace.cu",
                   "madraft_tpu/tpusim/trace.py:138"),
        "tick_chunk_trace": ("K6-trace", "madraft_tpu_torch/csrc/tick.cu",
                             "madraft_tpu/tpusim/trace.py:160"),
        "kv_tick": ("K9", "madraft_tpu_torch/csrc/kv.cu",
                    "madraft_tpu/tpusim/kv.py:425"),
        "kv_tick_metrics": ("K9-metrics", "madraft_tpu_torch/csrc/kv.cu",
                            "madraft_tpu/tpusim/metrics.py:65"),
        "kv_chunk": ("K6-kv", "madraft_tpu_torch/csrc/tick.cu",
                     "madraft_tpu/tpusim/kv.py:407"),
        "kv_chunk_metrics": ("K6-metrics-kv",
                             "madraft_tpu_torch/csrc/tick.cu",
                             "madraft_tpu/tpusim/kv.py:407"),
        "ctrler_tick": ("K10", "madraft_tpu_torch/csrc/ctrler.cu",
                        "madraft_tpu/tpusim/ctrler.py:593"),
        "ctrler_tick_metrics": ("K10-metrics",
                                "madraft_tpu_torch/csrc/ctrler.cu",
                                "madraft_tpu/tpusim/ctrler.py:750"),
        "ctrler_chunk": ("K6-ctrler", "madraft_tpu_torch/csrc/tick.cu",
                         "madraft_tpu/tpusim/ctrler.py:576"),
        "ctrler_chunk_metrics": ("K6-metrics-ctrler",
                                 "madraft_tpu_torch/csrc/tick.cu",
                                 "madraft_tpu/tpusim/ctrler.py:576"),
        "shardkv_tick": ("K11", "madraft_tpu_torch/csrc/shardkv.cu",
                         "madraft_tpu/tpusim/shardkv.py:907"),
        "shardkv_tick_metrics": ("K11-metrics",
                                 "madraft_tpu_torch/csrc/shardkv.cu",
                                 "madraft_tpu/tpusim/shardkv.py:1768"),
        "shardkv_tick_live": ("K11 live controller",
                              "madraft_tpu_torch/csrc/shardkv.cu",
                              "madraft_tpu/tpusim/shardkv.py:942"),
        "shardkv_tick_computed": ("K11 computed controller",
                                  "madraft_tpu_torch/csrc/shardkv.cu",
                                  "madraft_tpu/tpusim/shardkv.py:969"),
        "shardkv_tick_metrics_live": ("K11-metrics live controller",
                                      "madraft_tpu_torch/csrc/shardkv.cu",
                                      "madraft_tpu/tpusim/shardkv.py:1768"),
        "shardkv_tick_metrics_computed": (
            "K11-metrics computed controller",
            "madraft_tpu_torch/csrc/shardkv.cu",
            "madraft_tpu/tpusim/shardkv.py:1768"),
        **{_k6s_name(metrics_on, mode): (
            "K6-" + "metrics-" * metrics_on + "shardkv"
            + ("" if mode == "schedule" else f" {mode} controller"),
            "madraft_tpu_torch/csrc/tick.cu",
            "madraft_tpu/tpusim/shardkv.py:876")
           for metrics_on in (False, True)
           for mode in ("schedule", *SHARDKV_CTRL_FLAG)},
    }
    # each kernel's launches on the path that runs it: the fuzz flagship
    # for K6 and K1's key hashes, the pool flagship for K3, the metrics
    # flagship for K6-metrics, the coverage pool flagship for K6-coverage
    # and the credit pass. K1's draw chunks, K2, its metrics instance and
    # K4 run on the eager route only (0 launches on the flagships): their
    # counts come from the metrics pair's first eager run of the A/B, K5's
    # from the coverage pool pair's
    launches.update({k: pool_launches[k] for k in ("pack_state",
                                                   "unpack_state")})
    launches["tick_chunk_metrics"] = launches_m["tick_chunk_metrics"]
    launches.update({k: cov_launches[k] for k in (
        "tick_chunk_coverage", "credit_pass")})
    launches.update({k: em[k] for k in (
        "threefry_tick_blocks", "oracle", "oracle_metrics", "latency_fold")})
    launches["seen_update"] = ec["seen_update"]
    # K7's from the pool flagship and the coverage pool flagship, K8's
    # from explain
    launches["harvest"] = pool_launches["harvest"]
    launches["harvest_coverage"] = cov_launches["harvest"]
    launches["record"] = explain_launches["record"]
    launches["tick_chunk_trace"] = explain_launches["tick_chunk_trace"]
    # K6-kv's from the kv flagship, K6-metrics-kv's from the kv metrics
    # flagship; K9's there too (0: off the path since K6-kv)
    launches["kv_chunk"] = kv_launches["kv_chunk"]
    launches["kv_chunk_metrics"] = kv_launches_m["kv_chunk_metrics"]
    launches["kv_tick"] = kv_launches["kv_tick"]
    launches["kv_tick_metrics"] = kv_launches_m["kv_tick_metrics"]
    # K6-ctrler's from the ctrler flagship, K6-metrics-ctrler's from its
    # metrics run; K10's there too (0: off the path since K6-ctrler)
    launches["ctrler_chunk"] = ctrler_launches["ctrler_chunk"]
    launches["ctrler_chunk_metrics"] = ctrler_launches_m[
        "ctrler_chunk_metrics"]
    launches["ctrler_tick"] = ctrler_launches["ctrler_tick"]
    launches["ctrler_tick_metrics"] = ctrler_launches_m["ctrler_tick_metrics"]
    # K6-shardkv's from each mode's flagship, K6-metrics-shardkv's from its
    # metrics run; K11's rows there too (0: off the path since K6-shardkv)
    for mode, runs in shardkv_launches.items():
        tail = "" if mode == "schedule" else f"_{mode}"
        for metrics_on in (False, True):
            ran = runs[int(metrics_on)]
            launches[_k6s_name(metrics_on, mode)] = ran[
                _k6s_name(metrics_on, mode)]
            name = "shardkv_tick" + "_metrics" * metrics_on + tail
            launches[name] = ran[name]
    errs["harvest_coverage"] = errs["harvest"]
    rows = []
    for name, (ms, call_ms, plain_ms, nb, ops) in timing.items():
        t_bytes = nb / PEAK_BYTES_S * 1e3
        t_ops = ops / card["int32_ops_per_s"] * 1e3
        rows.append({
            "name": name, "label": sources[name][0], "route": "cuda",
            "source": sources[name][1], "replaces": sources[name][2],
            "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share": max(t_bytes, t_ops) / ms,
            "library_ms": None,
        })
    emit({"kernels": rows})

    print(_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _flagship_state(dev, b: int = 4096, ticks: int = 200,
                    metrics_on: bool = False):
    """The fuzz flagship's batch (seed 12345, --storm, n = 5, cap = 64;
    the metrics flagship's with ``metrics_on``) after ``ticks`` eager
    ticks: (cfg, state, keys, knobs)."""
    from madraft_tpu_torch.tpusim import engine, state, step

    cfg = _storm_cfg().replace(metrics=metrics_on)
    keys = engine.cluster_keys(12345, b, dev)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    for _ in range(ticks):
        s = step.step_cluster(cfg, s, keys, kn)
    return cfg, s, keys, kn


def k6_only() -> int:
    """K6's and K6-metrics' measurements alone, for comparing two trees in
    one call: the builds of K6, K6-metrics and their profile instances,
    then phases ``k6_phases`` and ``k6_scaling`` at the flagship's shape,
    ``k6_metrics_phases`` at the metrics flagship's, and the card's
    clocks; no result line. Run from the repository root:

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.k6_only())'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch import _build

    dev = torch.device("cuda")
    _build.build_all(K6_BUILDS)
    fcfg, fs, fk, fkn = _flagship_state(dev)
    emit(_k6_phases(fcfg, fs, fk, fkn, 32))
    emit(_k6_scaling(fcfg, fs, fk, fkn, 32))
    mcfg, ms, _, _ = _flagship_state(dev, metrics_on=True)
    emit(_k6_metrics_phases(fcfg, fs, mcfg, ms, fk, fkn, 32))
    emit(_card())
    print(_smi(), flush=True)
    return 0


def service_timing(dev) -> dict:
    """K10's and K11's builds timed at their flagships' shapes (tick 200
    to 201, ``_ctrler_timing`` and ``_shardkv_timing``): each row's ms,
    call ms, bound and share of it."""
    card = _card()
    rows = {}
    for timed, _ in (_ctrler_timing(dev), _shardkv_timing(dev)):
        for name, (ms, call_ms, plain_ms, nb, ops) in timed.items():
            bound = max(nb / PEAK_BYTES_S, ops / card["int32_ops_per_s"]) * 1e3
            rows[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "share": bound / ms}
    return {"phase": "service_timing", "card": _smi(), "rows": rows}


def service_only() -> int:
    """K10's and K11's measurements alone, for comparing two trees in one
    call: the builds, phases ``ctrler_phases`` and ``shardkv_phases``,
    then ``service_timing``; no result line. Run from the repository
    root:

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.service_only())'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    per_source = _build.build_all(_build.SOURCES + (
        _build.CTRLER, _build.SHARDKV, "ctrler_metrics", "ctrler_profile",
        "shardkv_metrics", "shardkv_profile"))
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": {k: round(v, 3) for k, v in per_source.items()}})
    emit(_ctrler_phases(dev))
    emit(_shardkv_phases(dev))
    emit(service_timing(dev))
    print(_smi(), flush=True)
    return 0


def service_leg(label: str, tree: str = "") -> int:
    """One leg of an A/B of K10's and K11's builds between two trees in one
    call: the madraft_tpu_torch package of ``tree`` (a ``git archive`` of
    another commit; this checkout's when empty), its kernels built into
    its own build directory, measured by this script's ``service_timing``
    and by the service flagships' wall a tick (one run each, 1024 x 512);
    prints one JSON line. Run in turns, for example parent, change,
    change, parent:

        python3 chip_smoke.py --service-leg parent _proof/parent
        python3 chip_smoke.py --service-leg change
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if tree:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import madraft_tpu_torch
    from madraft_tpu_torch import _build

    root = pathlib.Path(tree).resolve() if tree else ROOT
    check(pathlib.Path(madraft_tpu_torch.__file__).is_relative_to(root),
          f"service_leg measures {madraft_tpu_torch.__file__}, not {root}")
    for k, (fn, a) in counters().items():  # an older tree's lack some
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    _build.build_all(_build.SOURCES + (
        _build.CTRLER, _build.SHARDKV, "ctrler_metrics", "shardkv_metrics"))
    out = {"leg": label, **service_timing(torch.device("cuda")),
           "flagship_walls": {}}
    for name, argv in (
            ("ctrler", CTRLER_FLAGSHIP[:-1]),
            ("shardkv", SHARDKV_FLAGSHIP[:-1]),
            ("shardkv_live", SHARDKV_FLAGSHIP[:-1] + ["--live-ctrler"]),
            ("shardkv_computed",
             SHARDKV_FLAGSHIP[:-1] + ["--computed-ctrler"])):
        rc, rep = run_cli(argv)
        check(rc == 0 and rep["violating"] == 0, f"{name} flagship rc {rc}")
        tele = rep["telemetry"]
        out["flagship_walls"][name] = {
            "wall_ms_per_tick": tele["execute_s"] / _flag(argv, "--ticks")
            * 1e3, "steps_per_sec": tele["steps_per_sec"]}
    emit(out)
    return 0


def k6_timing(dev) -> dict:
    """K6, K6-metrics and K6-coverage timed at the flagships' tick-200
    states (seed 12345, --storm, 4096 clusters): the device ms of one
    KERNEL_CHUNK-tick launch of each (K6-coverage under [B] knob rows on
    an empty seen-set at run-wide tick 200, as the coverage pool runs it),
    K6-metrics' also at the clusters one wave of its grid holds, and the
    grid of each build."""
    import torch

    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import config, coverage, engine

    counts = read_counts()
    fcfg, fs, fk, fkn = _flagship_state(dev)
    mcfg, ms, _, _ = _flagship_state(dev, metrics_on=True)
    b, m = int(fs.tick.shape[0]), engine.KERNEL_CHUNK
    table = K6.knob_table(fkn, b)
    cov_kn = fkn.broadcast(b)
    cov_table = K6.knob_table(cov_kn, b)
    ccfg = config.CoverageConfig().fingerprint_key()
    seen = K6.Seen(ccfg, torch.full((1, ccfg.bitmap_bits), coverage.UNSEEN,
                                    dtype=torch.int32, device=dev), None,
                   torch.zeros(b, dtype=torch.int32, device=dev), 200)
    grids = {name: _k6_grid(fcfg, name)
             for name in ("tick", "tick_metrics", "tick_coverage")}
    one_wave = min(grids["tick_metrics"]["clusters_an_sm"]
                   * torch.cuda.get_device_properties(0).multi_processor_count,
                   b)
    ms_w = ms.__class__(*(x[:one_wave].contiguous() for x in ms))
    kw, table_w = fk[:one_wave].contiguous(), K6.knob_table(fkn, one_wave)
    rows = {
        "tick_chunk": lambda i: K6.tick_chunk(fcfg, fs, fk, fkn, m, table),
        "tick_chunk_metrics": lambda i: K6.tick_chunk(mcfg, ms, fk, fkn, m,
                                                      table),
        "tick_chunk_metrics_one_wave": lambda i: K6.tick_chunk(
            mcfg, ms_w, kw, fkn, m, table_w),
        "tick_chunk_coverage": lambda i: K6.tick_chunk(
            fcfg, fs, fk, cov_kn, m, cov_table, seen),
    }
    out = {name: device_ms(call, "tick_chunk_kernel", iters=5, warmup=1)
           for name, call in rows.items()}
    set_counts(counts)
    return {"ticks": m, "clusters": b, "one_wave_clusters": one_wave,
            "ms": out, "grids": grids}


def k6_leg(label: str, tree: str = "") -> int:
    """One leg of an A/B of K6's builds between two trees in one call: the
    madraft_tpu_torch package of ``tree`` (a ``git archive`` of another
    commit; this checkout's when empty), its kernels built into its own
    build directory, measured by ``k6_timing`` and by the fuzz and
    metrics fuzz flagships' cluster-steps/s (one run each); prints one
    JSON line. Run in turns, for example parent, change, change, parent:

        python3 chip_smoke.py --k6-leg parent _proof/parent
        python3 chip_smoke.py --k6-leg change
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if tree:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import madraft_tpu_torch
    from madraft_tpu_torch import _build

    root = pathlib.Path(tree).resolve() if tree else ROOT
    check(pathlib.Path(madraft_tpu_torch.__file__).is_relative_to(root),
          f"k6_leg measures {madraft_tpu_torch.__file__}, not {root}")
    for k, (fn, a) in counters().items():  # an older tree's lack some
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    _build.build_all(_build.SOURCES + ("tick_metrics", "tick_coverage"))
    out = {"leg": label, "card": _smi(),
           **k6_timing(torch.device("cuda")), "flagships": {}}
    for name, argv in (("fuzz", FLAGSHIP[:-1]),
                       ("metrics_fuzz", METRICS_FLAGSHIP[:-2] + ["--metrics"])):
        rc, rep = run_cli(argv)
        check(rc == 0 and rep["violating"] == 0, f"{name} flagship rc {rc}")
        out["flagships"][name] = rep["telemetry"]["steps_per_sec"]
    emit(out)
    return 0


def kv_leg(label: str, tree: str = "") -> int:
    """One leg of an A/B of the kv path between two trees in one call: the
    madraft_tpu_torch package of ``tree`` (a ``git archive`` of another
    commit; this checkout's when empty), its kernels built into its own
    build directory, measured by ``k6_timing`` (K6, K6-metrics,
    K6-coverage), by ``_kv_timing`` (K9 and K9-metrics a tick), by
    ``_k6kv_timing`` where the tree has K6-kv, and by the kv flagships'
    wall a tick and cluster-steps/s (1024 x 512 from a warm process, two
    runs each, metrics off and on); prints one JSON line. Run in turns,
    for example parent, change, change, parent:

        python3 chip_smoke.py --kv-leg parent _proof/parent
        python3 chip_smoke.py --kv-leg change
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if tree:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import madraft_tpu_torch
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import kv as K9

    root = pathlib.Path(tree).resolve() if tree else ROOT
    check(pathlib.Path(madraft_tpu_torch.__file__).is_relative_to(root),
          f"kv_leg measures {madraft_tpu_torch.__file__}, not {root}")
    for k, (fn, a) in counters().items():  # an older tree's lack some
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    k6kv = hasattr(K9, "kv_chunk")
    _build.build_all(_build.SOURCES + (
        "tick_metrics", "tick_coverage", _build.KV, "kv_metrics") + (
        ("tick_kv", "tick_metrics_kv") if k6kv else ()))
    dev = torch.device("cuda")
    out = {"leg": label, "card": _smi(), "k6": k6_timing(dev),
           "k9": {k: v[:3] for k, v in _kv_timing(dev)[0].items()},
           "k6kv": ({k: v[:3] for k, v in _k6kv_timing(dev).items()}
                    if k6kv else None), "flagships": {}}
    ticks = _flag(KV_FLAGSHIP, "--ticks")
    run_cli(KV_FLAGSHIP[:2] + ["--clusters", "1024", "--ticks", "16"])
    for name, argv in (("kv", KV_FLAGSHIP[:-1]),
                       ("kv_metrics", KV_FLAGSHIP[:-1] + ["--metrics"])):
        rows = []
        for _ in range(2):
            rc, rep = run_cli(argv)
            check(rc == 0 and rep["violating"] == 0,
                  f"{name} flagship rc {rc}")
            tele = rep["telemetry"]
            rows.append({"wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
                         "steps_per_sec": tele["steps_per_sec"]})
        out["flagships"][name] = rows
    emit(out)
    return 0


def ctrler_leg(label: str, tree: str = "") -> int:
    """One leg of an A/B of the ctrler path between two trees in one call:
    the madraft_tpu_torch package of ``tree`` (a ``git archive`` of another
    commit; this checkout's when empty), its kernels built into its own
    build directory, measured by ``k6_timing`` (K6, K6-metrics,
    K6-coverage), by ``_k6kv_timing`` (K6-kv a chunk, without its plain
    version), by ``_ctrler_timing`` (K10 and K10-metrics a tick), by
    ``_k6ctrler_timing`` where the tree has K6-ctrler (without its plain
    version), and by the ctrler flagships' wall a tick and
    cluster-steps/s (1024 x 512 from a warm process, two runs each,
    metrics off and on); prints one JSON line. Run in turns, for example
    parent, change, change, parent:

        python3 chip_smoke.py --ctrler-leg parent _proof/parent
        python3 chip_smoke.py --ctrler-leg change
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if tree:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import madraft_tpu_torch
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import ctrler as K10

    root = pathlib.Path(tree).resolve() if tree else ROOT
    check(pathlib.Path(madraft_tpu_torch.__file__).is_relative_to(root),
          f"ctrler_leg measures {madraft_tpu_torch.__file__}, not {root}")
    for k, (fn, a) in counters().items():  # an older tree's lack some
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    k6ctrler = hasattr(K10, "ctrler_chunk")
    _build.build_all(_build.SOURCES + (
        "tick_metrics", "tick_coverage", "tick_kv", "tick_metrics_kv",
        _build.CTRLER, "ctrler_metrics") + (
        ("tick_ctrler", "tick_metrics_ctrler") if k6ctrler else ()))
    dev = torch.device("cuda")
    out = {"leg": label, "card": _smi(), "k6": k6_timing(dev),
           "k6kv": {k: v[:2] for k, v in _k6kv_timing(
               dev, plain=False).items()},
           "k10": {k: v[:3] for k, v in _ctrler_timing(dev)[0].items()},
           "k6ctrler": ({k: v[:2] for k, v in _k6ctrler_timing(
               dev, plain=False).items()} if k6ctrler else None),
           "flagships": {}}
    ticks = _flag(CTRLER_FLAGSHIP, "--ticks")
    run_cli(CTRLER_FLAGSHIP[:2] + ["--clusters", "1024", "--ticks", "16"])
    for name, argv in (("ctrler", CTRLER_FLAGSHIP[:-1]),
                       ("ctrler_metrics",
                        CTRLER_FLAGSHIP[:-1] + ["--metrics"])):
        rows = []
        for _ in range(2):
            rc, rep = run_cli(argv)
            check(rc == 0 and rep["violating"] == 0,
                  f"{name} flagship rc {rc}")
            tele = rep["telemetry"]
            rows.append({"wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
                         "steps_per_sec": tele["steps_per_sec"]})
        out["flagships"][name] = rows
    emit(out)
    return 0


def shardkv_leg(label: str, tree: str = "") -> int:
    """One leg of an A/B of the shardkv path between two trees in one call:
    the madraft_tpu_torch package of ``tree`` (a ``git archive`` of another
    commit; this checkout's when empty), its kernels built into its own
    build directory, measured by ``k6_timing`` (K6, K6-metrics,
    K6-coverage), by ``_k6kv_timing`` and ``_k6ctrler_timing`` (K6-kv and
    K6-ctrler a chunk, without their plain versions), by
    ``_shardkv_timing`` (K11 and K11-metrics a tick in each mode), by
    ``_k6shardkv_timing`` where the tree has K6-shardkv (without its plain
    version), and by the three shardkv flagships' wall a tick and
    deployment-steps/s (1024 x 512 from a warm process, two runs each);
    prints one JSON line. Run in turns, for example parent, change,
    change, parent:

        python3 chip_smoke.py --shardkv-leg parent _proof/parent
        python3 chip_smoke.py --shardkv-leg change
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if tree:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import madraft_tpu_torch
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import shardkv as K11

    root = pathlib.Path(tree).resolve() if tree else ROOT
    check(pathlib.Path(madraft_tpu_torch.__file__).is_relative_to(root),
          f"shardkv_leg measures {madraft_tpu_torch.__file__}, not {root}")
    for k, (fn, a) in counters().items():  # an older tree's lack some
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    k6s = hasattr(K11, "shardkv_chunk")
    _build.build_all(_build.SOURCES + (
        "tick_metrics", "tick_coverage", "tick_kv", "tick_metrics_kv",
        "tick_ctrler", "tick_metrics_ctrler", _build.SHARDKV,
        "shardkv_metrics") + (
        ("tick_shardkv", "tick_metrics_shardkv") if k6s else ()))
    dev = torch.device("cuda")
    out = {"leg": label, "card": _smi(), "k6": k6_timing(dev),
           "k6kv": {k: v[:2] for k, v in _k6kv_timing(
               dev, plain=False).items()},
           "k6ctrler": {k: v[:2] for k, v in _k6ctrler_timing(
               dev, plain=False).items()},
           "k11": {k: v[:3] for k, v in _shardkv_timing(dev)[0].items()},
           "k6shardkv": ({k: v[:2] for k, v in _k6shardkv_timing(
               dev, plain=False).items()} if k6s else None),
           "flagships": {}}
    ticks = _flag(SHARDKV_FLAGSHIP, "--ticks")
    run_cli(SHARDKV_FLAGSHIP[:2] + ["--clusters", "1024", "--ticks", "16"])
    for mode in ("schedule", *SHARDKV_CTRL_FLAG):
        argv = [x for x in _shardkv_flagship(mode)[0]
                if x != "--check-deterministic"]
        rows = []
        for _ in range(2):
            rc, rep = run_cli(argv)
            check(rc == 0 and rep["violating"] == 0,
                  f"shardkv {mode} flagship rc {rc}")
            tele = rep["telemetry"]
            rows.append({"wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
                         "steps_per_sec": tele["steps_per_sec"]})
        out["flagships"][mode] = rows
    emit(out)
    return 0


# K6's builds (_build.VARIANTS): the kernel, its metrics, coverage and
# metrics-coverage variants, the profile instances of K6, K6-metrics and
# K6-coverage, K6-kv and K6-metrics-kv, and K6-ctrler and
# K6-metrics-ctrler
K6_BUILDS = ("tick", "tick_metrics", "tick_coverage", "tick_metrics_coverage",
             "tick_profile", "tick_metrics_profile", "tick_coverage_profile",
             "tick_kv", "tick_metrics_kv", "tick_ctrler",
             "tick_metrics_ctrler")
# SASS opcode classes for _k6_sass: the 32-bit integer pipe's, the FMA
# pipe's (IMAD and the float ops), memory, warp collectives, control
SASS_CLASSES = {
    "alu": ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "IMNMX", "LEA", "PRMT",
            "POPC", "FLO", "BREV", "VIADD", "VIMNMX", "IABS", "PLOP3", "P2R",
            "R2P", "LOP", "ISCADD", "BMSK", "SGXT", "VIADDMNMX", "IADD"),
    "fma": ("IMAD", "FFMA", "FADD", "FMUL", "FSETP", "FMNMX", "I2F", "F2I",
            "FSEL", "IDP", "FRND"),
    "memory": ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "ATOM",
               "ATOMS", "ATOMG", "RED", "LDC", "LDSM"),
    "collective": ("SHFL", "VOTE", "MATCH", "REDUX", "BAR", "WARPSYNC"),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BREAK",
                "JMP", "NOP", "YIELD"),
}


def _sass(path) -> dict:
    """{mangled kernel name: [instruction text, ...]} of a library's
    sm_90a code, from cuobjdump -sass."""
    import re

    tool = "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=600).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+([^;]*);", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return funcs


def _opcode(ins: str) -> str:
    return (ins.split()[1] if ins.startswith("@") else ins.split()[0]
            ).split(".")[0]


def _sass_class(ins: str) -> str:
    op = _opcode(ins)
    return next((k for k, ops in SASS_CLASSES.items() if op in ops), "other")


def _k6_sass(card: dict, m: int, b: int, k6_ms: float, k6_bytes: int,
             build: str = "tick") -> dict:
    """K6's instructions at the flagship's shape (those of its build
    ``build``: K6-metrics, K6-coverage), read off the SASS
    (cuobjdump) of the n = 5, cap = 64, ae 4 template instance: their
    static count by opcode class in the kernel, and in the profile build
    the instructions between its clock64() reads, a phase group each (the
    tick's regions in PHASES order), by class. A warp instruction serves
    two clusters (16 lanes each), so a cluster-tick costs half of its
    tick's warp instructions in issue slots (4 an SM a clock) and 16
    lanes of the integer ALU pipe (64 an SM a clock) for each ALU-class
    instruction. The bound from these counts is the larger of the bytes,
    the ALU lanes and the issue slots; the counts are static (an unrolled
    loop counts each pass, a loop that is not counts once, both arms of a
    branch count, the profile build adds its clock reads), so they
    estimate the work rather than bound it from below. The coverage
    build's profile marks once more a tick, after the fingerprint's
    stamp, whose instructions count with compact."""
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import tick as K6

    inst = "ILi5ELi64ELi4ELb{}EE"
    out = {"phase": "k6_sass" + build[len("tick"):], "build": build,
           "instance": "n=5 cap=64 ae=4"}
    funcs = _sass(_build._target(build))
    name = next((f for f in funcs if "tick_chunk_kernel" in f
                 and inst.format(0) in f), None)
    check(name is not None, f"no K6 n5 cap64 instance in {list(funcs)[:8]}")
    classes = {k: 0 for k in (*SASS_CLASSES, "other")}
    for ins in funcs[name]:
        classes[_sass_class(ins)] += 1
    out["static_instructions"] = len(funcs[name])
    out["by_class"] = classes
    funcs_p = _sass(_build._target(build + "_profile"))
    name_p = next((f for f in funcs_p if "tick_chunk_kernel" in f
                   and inst.format(1) in f), None)
    check(name_p is not None, f"no {build} n5 cap64 profile instance")
    code = funcs_p[name_p]
    reads = [i for i, ins in enumerate(code) if "SR_CLOCKLO" in ins]
    out["profile_clock_reads"] = len(reads)
    # start, stage, the 12 tick phases (and the stamp's mark), stage: 15
    # reads (16), 14 regions (15); the loop's between the stage marks
    phases = list(K6.PHASES[1:]) + ["compact"] * ("coverage" in build)
    check(len(reads) == len(phases) + 3,
          f"{len(reads)} clock reads in {build}'s profile instance")
    regions = {}
    for phase, lo, hi in zip(phases, reads[1:-2], reads[2:-1]):
        count = regions.setdefault(phase, {k: 0 for k in classes})
        for ins in code[lo:hi]:
            count[_sass_class(ins)] += 1
    out["by_phase"] = {p: sum(c.values()) for p, c in regions.items()}
    out["alu_by_phase"] = {p: c["alu"] for p, c in regions.items()}
    tick_ins = sum(out["by_phase"].values())
    alu_ins = sum(out["alu_by_phase"].values())
    hz = card["clocks_max_sm_mhz"] * 1e6
    t_alu = b * m * 16 * alu_ins / card["int32_ops_per_s"] * 1e3
    t_issue = b * m * tick_ins / 2 / (4 * card["sms"] * hz) * 1e3
    t_bytes = k6_bytes / PEAK_BYTES_S * 1e3
    bound = max(t_alu, t_issue, t_bytes)
    out.update({
        "tick_instructions": tick_ins, "tick_alu_instructions": alu_ins,
        "alu_lane_ops_per_cluster_tick": 16 * alu_ins,
        "issue_slots_per_cluster_tick": tick_ins / 2,
        "bound_ms_alu": t_alu, "bound_ms_issue": t_issue,
        "bound_ms_bytes": t_bytes, "bound_ms_256_ticks": bound,
        "bound_by": ("alu" if bound == t_alu else "issue" if bound == t_issue
                     else "bytes"),
        "k6_ms_256_ticks": k6_ms, "share": bound / k6_ms})
    return out


def _k6_grid(cfg, build: str = "tick") -> dict:
    """How a build of K6 (``_build.VARIANTS``) lays cfg's clusters out on
    the card (``tick_grid``): clusters a warp, warps a block, clusters a
    block, shared bytes a block and a cluster, the blocks and clusters an
    SM holds (the occupancy API), and the waves 4096 clusters take."""
    import ctypes

    import torch

    from madraft_tpu_torch.kernels import tick as K6

    lib = K6._lib(build)
    lib.tick_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tick_grid.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(lib.tick_grid(cfg.n_nodes, cfg.log_cap, cfg.ae_max, out) == 0,
          f"tick_grid of {build} refused the shape")
    per_block = out[0] * out[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"build": build, "clusters_a_warp": out[0], "warps_a_block": out[1],
            "clusters_a_block": per_block, "shared_bytes": out[2],
            "cluster_bytes": out[2] // per_block, "blocks_an_sm": out[3],
            "clusters_an_sm": out[3] * per_block,
            "waves_at_4096": -(-4096 // (out[3] * per_block * sms))}


def _k6_load(grid: dict, b: int, sms: int) -> dict:
    """What B clusters put on the card: blocks, the SMs that get one,
    and the warps on each of those (a mean, the blocks spread
    breadth-first)."""
    blocks = -(-b // grid["clusters_a_block"])
    busy = min(blocks, sms)
    warps = -(-b // grid["clusters_a_warp"])
    return {"clusters": b, "blocks": blocks, "busy_sms": busy,
            "warps_per_busy_sm": warps / busy}


def _k6_phases(cfg, s, keys, kn, m: int, phase: str = "k6_phases") -> dict:
    """Where one K6 chunk's time goes (K6-metrics' with ``cfg.metrics``):
    the profile instance's clock64() cycles per phase group, a tick of a
    cluster (mean over the clusters), at the whole batch and at one block
    an SM (a warp a scheduler, so each warp's own chain with little issue
    contention), each run's state held against the kernel's own."""
    import torch

    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import state

    counts = read_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = _k6_grid(cfg, K6.variant(cfg.metrics, False))
    out = {"phase": phase, "ticks": m, "instance": K6.instance(cfg),
           "grid": grid}
    for label, b in (("batch", int(s.tick.shape[0])),
                     ("one_block_an_sm", sms * grid["clusters_a_block"])):
        sb = state.ClusterState(*(x[:b].contiguous() for x in s))
        kb = keys[:b].contiguous()
        got, prof = K6.tick_chunk_profiled(cfg, sb, kb, kn, m)
        want = K6.tick_chunk(cfg, sb, kb, kn, m)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"{phase}: the profile instance differs from the kernel")
        cyc = prof.to(torch.float64).sum(0) / b / m
        per = {k: float(cyc[i]) for i, k in enumerate(K6.PHASES)}
        tick_total = sum(v for k, v in per.items() if k != "stage")
        out[label] = {**_k6_load(grid, b, sms),
                      "cycles_per_cluster_tick": per,
                      "tick_cycles": tick_total,
                      "share_of_tick": {k: v / tick_total
                                        for k, v in per.items()
                                        if k != "stage"}}
    set_counts(counts)
    return out


def _k6_metrics_phases(fcfg, fs, mcfg, ms, keys, kn, m: int) -> dict:
    """Where K6-metrics' time goes at the metrics flagship's state
    (``ms``, metrics on, beside the fuzz flagship's ``fs``): its profile
    instance's cycles by phase group (``_k6_phases``), its grid and the
    waves 4096 clusters take, ptxas's report of every build of K6, and
    the device ms of one KERNEL_CHUNK-tick launch of K6-metrics and of K6
    at the whole batch and at the clusters one wave of K6-metrics holds
    (what a second wave costs, apart from the metrics plane's own code)."""
    import torch

    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import engine, state

    out = _k6_phases(mcfg, ms, keys, kn, m, "k6_metrics_phases")
    counts = read_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    whole = int(ms.tick.shape[0])
    one_wave = min(out["grid"]["clusters_an_sm"] * sms, whole)
    launch = {}
    for label, cfg, s in (("tick_chunk_metrics", mcfg, ms),
                          ("tick_chunk", fcfg, fs)):
        for b in sorted({whole, one_wave}):
            sb = state.ClusterState(*(x[:b].contiguous() for x in s))
            kb = keys[:b].contiguous()
            table = K6.knob_table(kn, b)
            launch.setdefault(label, {})[str(b)] = device_ms(
                lambda i: K6.tick_chunk(cfg, sb, kb, kn, engine.KERNEL_CHUNK,
                                        table),
                "tick_chunk_kernel", iters=5, warmup=1)
    set_counts(counts)
    out["ms_a_launch"] = {"ticks": engine.KERNEL_CHUNK,
                          "one_wave_clusters": one_wave, **launch}
    out["ptxas"] = {name: _build.ptxas(name) for name in K6_BUILDS}
    spills = {name: r["spills"] for name, r in out["ptxas"].items()
              if r["spills"]}
    check(not spills, f"K6's builds spill: {spills}")
    out["card"] = _smi()
    return out


def _k6_scaling(cfg, s, keys, kn, m: int) -> dict:
    """K6's device ms a chunk from the flagship's state as the load on
    each SM grows: one warp on one SM, then one, two and three blocks on
    every SM, then the whole batch. Flat in the warps an SM means each
    warp's dependent chain sets the time (latency-bound), linear means
    the issue slots do."""
    import torch

    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import state

    counts = read_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = _k6_grid(cfg)
    whole = int(s.tick.shape[0])
    points = []
    for b in (grid["clusters_a_warp"],
              *(min(sms * grid["clusters_a_block"] * k, whole)
                for k in (1, 2, 3)), whole):
        sb = state.ClusterState(*(x[:b].contiguous() for x in s))
        kb = keys[:b].contiguous()
        table = K6.knob_table(kn, b)
        ms = device_ms(lambda i: K6.tick_chunk(cfg, sb, kb, kn, m, table),
                       "tick_chunk_kernel", iters=20, warmup=2)
        points.append({**_k6_load(grid, b, sms), "ms": ms,
                       "us_per_tick": ms * 1e3 / m})
    set_counts(counts)
    return {"phase": "k6_scaling", "sms": sms, "ticks": m, "grid": grid,
            "points": points,
            "ms_ratio_batch_over_one_block_an_sm":
                points[-1]["ms"] / points[1]["ms"]}


def _card() -> dict:
    """The card's name, power limit and top SM clock (nvidia-smi), and the
    32-bit integer rate the bounds use: 64 lanes an SM a clock."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    name, limit, mhz = (x.strip() for x in smi.stdout.strip().split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"phase": "card", "name": name, "power_limit_w": float(limit),
            "clocks_max_sm_mhz": float(mhz), "sms": sms,
            "int32_ops_per_s": INT_LANES_PER_SM * sms * float(mhz) * 1e6}


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or "nvidia-smi: not available"


def _knob_rows(b: int, dev):
    """[B] knob rows: four storm profiles in turn, the quorum and the
    compaction rule varied across lanes."""
    import torch

    from madraft_tpu_torch.tpusim import config

    profiles = ("storm", "gray_storm", "limp", "fsync_stall")
    kns = [config.storm_profiles()[profiles[i % 4]][0].knobs()
           for i in range(b)]
    kn = config.Knobs(*(torch.stack(xs) for xs in zip(*kns)))
    lane = torch.arange(b)
    kn = kn._replace(
        majority=torch.tensor([3, 2, 3, 4], dtype=torch.int32)[lane % 4],
        compact_at_commit=lane % 2 == 0)
    return kn.to(dev)


def kv_knob_rows(kcfg, b: int):
    """[B] kv knob rows (on the CPU) that mix every planted bug, the
    Get/Put split, hint following with ``retry_wait``, the open loop and
    the Zipf key across the batch; lanes 0, 5, 10, ... plant no bug. For
    holding K9 against its plain version (phase ``kv_k9`` and the K9 host
    build's tests)."""
    import torch

    kk = kcfg.knobs().broadcast(b)
    i = torch.arange(b)
    return kk._replace(
        bug_skip_dedup=i % 5 == 1, bug_apply_uncommitted=i % 5 == 2,
        bug_stale_read=i % 5 == 3, bug_stale_hint=i % 5 == 4,
        p_get=torch.where(i % 2 == 0, 0.5, 0.2).float(),
        p_put=torch.where(i % 3 == 0, 0.3, 0.1).float(),
        p_follow_hint=torch.where(i % 4 == 0, 0.9, 0.0).float(),
        retry_wait=(i % 3).int(),
        open_queue_cap=torch.where(i % 6 == 5, 8, 0).int(),
        open_rate=torch.where(i % 6 == 5, 0.25, 0.0).float(),
        zipf_a=torch.where(i % 4 == 1, 3.0, 1.0).float())


def _k6_vs_plain(cfg, s, keys, kn, ticks: int, chunk: int, errs: dict,
                 label: str):
    """K6 against its plain version from state ``s`` over ``ticks`` ticks
    in chunks of ``chunk``, under the current threefry layout: every leaf
    bit-equal after every chunk. Returns the final state."""
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import state

    done = 0
    while done < ticks:
        m = min(chunk, ticks - done)
        got = K6.tick_chunk(cfg, s, keys, kn, m)
        want = K6.tick_chunk_plain(cfg, s, keys, kn, m)
        done += m
        for a, b in zip(got, want):
            check(a.dtype == b.dtype, f"K6 leaf dtype {a.dtype} at {label}")
            errs["tick_chunk"] = max(errs["tick_chunk"], max_abs_err(a, b))
        check(errs["tick_chunk"] == 0,
              f"K6 differs from its plain version at {label}: "
              f"{state.first_divergence(done, state.state_to_numpy(want), state.state_to_numpy(got))}")
        s = want
    return s


def _trace_rows_plain(cfg, seed: int, cluster: int, ticks: int, dev):
    """The traced replay's rows by the plain version on ``dev``: the eager
    tick on the chunk's words (``threefry.tick_blocks_plain``) and
    ``record_plain`` after each tick, with K8 writing the same tick's row
    beside it. Returns (rows, K8's rows, both [ticks, 1, W], the final
    state)."""
    import torch

    from madraft_tpu_torch.kernels import threefry
    from madraft_tpu_torch.kernels import trace as K8
    from madraft_tpu_torch.tpusim import engine, prng, state, step

    keys = engine.cluster_keys(seed, 1, dev, id0=cluster)
    kn = cfg.knobs(dev)
    s = state.init_cluster(cfg, keys, kn)
    words = threefry.tick_blocks_plain(keys, s.tick + 1, ticks,
                                       step._block_total(cfg.n_nodes),
                                       prng.partitionable())
    w = K8.record_width(cfg)
    rows = torch.empty((ticks, 1, w), dtype=torch.int32, device=dev)
    k8_rows = torch.empty_like(rows)
    for i in range(ticks):
        nxt = state.ClusterState(*(x.contiguous() for x in step.step_cluster(
            cfg, s, keys, kn, words=words[i])))  # K8 takes contiguous leaves
        rows[i] = K8.record_plain(s, nxt)
        K8.record(cfg, s, nxt, k8_rows[i])
        s = nxt
    return rows, k8_rows, s


def _k6_standin(tick_chunk):
    """kernels.tick as the engine sees it, with ``tick_chunk`` in place of
    the wrapper (a hook that keeps what a call gives or returns)."""
    from madraft_tpu_torch.kernels import tick as K6

    return types.SimpleNamespace(tick_chunk=tick_chunk,
                                 knob_table=K6.knob_table,
                                 check_shape=K6.check_shape,
                                 variant=K6.variant, Seen=K6.Seen)


def _plant_metric_leaves(s):
    """A copy of a metrics-on state with its metric leaves planted at their
    edges: stale submit stamps 1..5 in every ring slot (a no-op clears its
    slot's, an install-snapshot keeps them), sums a few counts below the
    int32 wrap, and lanes in turn with an empty worst-op register holding a
    large latency, a held one every op beats, and one above every op."""
    import torch

    g = torch.Generator(device=s.tick.device).manual_seed(5)
    dev, b = s.tick.device, s.tick.shape[0]

    def near(x):
        return (2**31 - 1 - torch.randint(0, 4, x.shape, generator=g,
                                          device=dev)).to(torch.int32)

    kind = torch.arange(b, device=dev) % 3
    return s._replace(
        log_tick=torch.randint(1, 6, s.log_tick.shape, generator=g,
                               device=dev, dtype=torch.int32),
        lat_hist=near(s.lat_hist), ev_counts=near(s.ev_counts),
        phase_hist=near(s.phase_hist), phase_ticks=near(s.phase_ticks),
        lat_ticks=near(s.lat_ticks),
        worst_lat=torch.where(kind == 2, 2**30, torch.where(
            kind == 0, 10**6, 0)).to(torch.int32)[:, None],
        worst_sub=torch.where(kind == 0, 0, 5).to(torch.int32)[:, None])


def _k6_variant_vs_plain(cfg, s, keys, kn, ticks: int, chunk: int,
                         errs: dict, label: str, cov=None):
    """K6's metrics / coverage variant (cfg.metrics, ``cov``) against its
    plain version from state ``s`` over ``ticks`` ticks in chunks of
    ``chunk``: every leaf, and with ``cov`` (a K6.Seen from run-wide tick
    cov.t) the seen-set stamps and the credits, bit-equal after every
    chunk. Returns the final state, and with ``cov`` the plain side's
    seen-set after it."""
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import state

    key = "tick_chunk_coverage" if cov is not None else "tick_chunk_metrics"
    cov_p = None if cov is None else cov._replace(
        seen=cov.seen.clone(), new_fps=cov.new_fps.clone())
    done = 0
    while done < ticks:
        m = min(chunk, ticks - done)
        t = None if cov is None else cov.t + done
        got = K6.tick_chunk(cfg, s, keys, kn, m,
                            cov=None if cov is None else cov._replace(t=t))
        want = K6.tick_chunk_plain(
            cfg, s, keys, kn, m, cov=None if cov is None else cov_p._replace(
                t=t))
        done += m
        for a, b in zip(got, want):
            check(a.dtype == b.dtype, f"{key} leaf dtype {a.dtype} at {label}")
            errs[key] = max(errs[key], max_abs_err(a, b))
        if cov is not None:
            errs[key] = max(errs[key], max_abs_err(cov.seen, cov_p.seen))
            errs["credit_pass"] = max(errs["credit_pass"],
                                      max_abs_err(cov.new_fps, cov_p.new_fps))
        check(errs[key] == 0 and errs["credit_pass"] == 0,
              f"{key} differs from its plain version at {label}, tick {done}: "
              f"{state.first_divergence(done, state.state_to_numpy(want), state.state_to_numpy(got))}")
        s = want
    return s if cov is None else (s, cov_p)


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


def _to(args, dev):
    """The latency fold's argument tuple (its last item a tuple) on dev."""
    return tuple(_to(x, dev) if isinstance(x, tuple) else x.to(dev)
                 for x in args)


def _clone(args):
    return tuple(_clone(x) if isinstance(x, tuple) else x.clone()
                 for x in args)


def _flat(args) -> list:
    return [y for x in args
            for y in (_flat(x) if isinstance(x, tuple) else [x])]


def _k4_vs_plain(cpu_args, dev, errs: dict, label: str) -> None:
    """K4 on the card against its plain version on the CPU, same inputs:
    every output register bit-equal, dtypes included."""
    from madraft_tpu_torch.kernels import metrics as K4
    from madraft_tpu_torch.tpusim import metrics

    got = _flat(K4.latency_fold(*_to(cpu_args, dev)))
    want = _flat(metrics.latency_fold_plain(*cpu_args))
    check(len(got) == len(want) == 9, "latency_fold returns 9 registers")
    for a, b in zip(got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"K4 output {a.dtype}{tuple(a.shape)} vs plain "
              f"{b.dtype}{tuple(b.shape)} at {label}")
        errs["latency_fold"] = max(errs["latency_fold"],
                                   max_abs_err(a.cpu(), b))
    check(errs["latency_fold"] == 0,
          f"K4 differs from its plain version at {label}")


def _k2m_vs_plain(st, errs: dict, label: str) -> None:
    """K2's metrics instance against its plain version on a metrics-on
    state (on the card): the ten outputs, shadow_sub last, bit-equal."""
    from madraft_tpu_torch.kernels import oracle as K2

    args = oracle_args(st)
    got = K2.oracle(*args, log_tick=st.log_tick)
    want = K2.oracle_plain(*args, log_tick=st.log_tick)
    check(len(got) == len(want) == 10, "the metrics oracle returns 10 outputs")
    for a, b in zip(got, want):
        errs["oracle_metrics"] = max(errs["oracle_metrics"], max_abs_err(a, b))
    check(errs["oracle_metrics"] == 0,
          f"K2's metrics instance differs from its plain version at {label}")


def _check_latency_mass(lat: dict, label: str) -> None:
    """The metrics plane's invariants on a report's latency block: every
    phase row holds the acked ops, and the phases' tick totals add up to
    the end-to-end total."""
    check(lat["ops"] > 0, f"{label}: no op was acked")
    check(all(d["ops"] == lat["ops"] for d in lat["phases"].values()),
          f"{label}: phase rows' mass differs from {lat['ops']} ops")
    check(sum(d["ticks_total"] for d in lat["phases"].values())
          == lat["ticks_total"],
          f"{label}: phase ticks do not add up to {lat['ticks_total']}")


def _non_metric_leaves(final) -> dict:
    """A final state's leaves on the host, the metric ones aside."""
    from madraft_tpu_torch.tpusim import state

    h = state.state_to_numpy(final)
    return {f: h[f] for f in state.ClusterState._fields[:state.METRIC_LEAF0]}


def _metrics_fixture_legs(dev) -> None:
    """The JAX package's metrics legs (tests/torch_fixtures/
    metrics_legs.json) on the card: the storm fuzz report's per-cluster
    arrays, metric rows included, and the durability + ack_before_fsync
    pool's rows and deterministic summary, all bit-equal."""
    from madraft_tpu_torch.tpusim import config, engine, prng

    fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                     "metrics_legs.json").read_text())
    with prng.layout(fx["partitionable"]):
        rec = fx["fuzz"]
        cfg = config.storm_profiles()[rec["profile"]][0].replace(
            bug=rec["bug"], metrics=True)
        rep = engine.fuzz(cfg, rec["seed"], rec["n_clusters"], rec["n_ticks"],
                          device=dev)
        for f, want in rec["report"].items():
            check(getattr(rep, f).tolist() == want,
                  f"metrics fixture fuzz leg: field {f} differs")
        emit({"phase": "fixture_metrics_fuzz", "match": True,
              "ops": int(rep.lat_hist.sum())})
        rec = fx["pool"]
        cfg = config.storm_profiles()[rec["profile"]][0].replace(
            bug=rec["bug"], metrics=True)
        rows = []
        out = engine.run_pool(cfg, rec["seed"], rec["lanes"], rec["horizon"],
                              chunk_ticks=rec["chunk_ticks"],
                              budget_ticks=rec["budget_ticks"],
                              on_retired=rows.append, device=dev)
        got = [deterministic(r) for r in rows]
        check(got == rec["rows"], "metrics fixture pool leg: rows differ")
        bad = {k: (out.get(k), v) for k, v in rec["summary"].items()
               if out.get(k) != v}
        check(not bad, f"metrics fixture pool leg: summary differs: {bad}")
        emit({"phase": "fixture_metrics_pool", "match": True,
              "retired": out["retired"],
              "violating": out["retired_violating"],
              "ops": out["latency"]["ops"]})


def _k3_vs_plain(cfg, h: dict, dev, errs: dict, label: str) -> None:
    """K3's pack and unpack on the card against their plain versions on
    the CPU, same inputs (a wide host state ``h``): every leaf bit-equal,
    dtypes included, and unpack(pack(h)) == h. Raises on a difference;
    ``errs`` keeps the largest absolute error per direction."""
    from madraft_tpu_torch.kernels import pack as K3
    from madraft_tpu_torch.tpusim import state

    p = K3.pack_state(cfg, state.state_from_numpy(h, dev))
    w = K3.unpack_state(cfg, p)
    want_p = state.pack_state(cfg, state.state_from_numpy(h))
    want_w = state.unpack_state(cfg, want_p)
    for key, got, want in (("pack_state", p, want_p),
                           ("unpack_state", w, want_w)):
        for f, a, b in zip(type(got)._fields, got, want):
            check(a.dtype == b.dtype, f"K3 {key} {f} dtype {a.dtype} at {label}")
            errs[key] = max(errs[key], max_abs_err(a.cpu(), b))
    check(errs["pack_state"] == 0 and errs["unpack_state"] == 0,
          f"K3 differs from its plain version at {label}: {errs}")
    check(state.first_divergence(0, h, state.state_to_numpy(w)) is None,
          f"K3 round trip differs at {label}")


def _profiled(run, arm=None, cpu: bool = True, attempts: int = 5,
              expect: tuple = ()) -> tuple:
    """(run()'s result, the kernel averages that have device time, wall
    ms, all averages, attempts) of run() under torch.profiler (CUDA
    activities, and CPU ones with ``cpu``), synchronized on both sides.
    After a long profiled window of the eager tick CUPTI now and then
    hands a short one no device record at all, or drops some of them
    (after the script's earlier windows it dropped a harvest's first
    kernel in ten windows of ten), so each window opens with a warm-up
    step (``arm()``, which sets run()'s inputs up; nothing it launches is
    kept) and spin kernels before and after run() (``_spins``: all left
    out of the result, with the step's own annotation), and an attempt
    that saw nothing, or
    missed one of the device operations named in ``expect`` (a tuple of
    names, or a mapping of a name to the exact count of its records the
    window must hold), is made again; after the last one a missing name,
    or a record count other than its mapping's, fails the check. Each
    window starts with ``_cupti_room``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    want = expect if isinstance(expect, dict) else dict.fromkeys(expect)
    names = {k: re.compile(rf"(^|::|\s){re.escape(k)}(\(|<|\s|$)")
             for k in want}

    def seen(k, kernels) -> bool:
        got = sum(e.count for e in kernels if names[k].search(e.key))
        return got > 0 if want[k] is None else got == want[k]

    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            time.sleep(0.5)  # CUPTI's buffers come back asynchronously
        room = _cupti_room()
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            if arm is not None:
                arm()
            torch.cuda.synchronize()
            prof.step()
            _spins()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            _spins()  # outside the wall, as the first ones (device_ms)
            torch.cuda.synchronize()
            prof.step()
        avgs = [e for e in prof.key_averages() if "spin_kernel" not in e.key
                and not e.key.startswith("ProfilerStep")]
        kernels = [e for e in avgs if "CUDA" in str(getattr(
            e, "device_type", "")) and _dev_us(e) > 0]
        missing = [k for k in want if not seen(k, kernels)]
        if kernels and not missing:
            break
    check(not missing, f"the profiler missed {missing} (want {want}) in "
          f"{attempts} windows: {[(e.key[:80], e.count) for e in kernels]}; "
          f"{room} before the last")
    return out, kernels, wall_ms, avgs, attempt


def _profile_harvest(s, keys, kn, ccfg=None) -> dict:
    """Device operations and time of one pool harvest at the flagship
    shape (K7: retire mask, ids, snapshot, fresh lanes; then the K3 pack
    and the host fetch; with ``ccfg`` the coverage harvest, its knob rows
    refilled by the guided rule, half the lanes productive), from
    torch.profiler, beside the same harvest through its plain version
    (``tick="eager"``, None where the profiler recorded nothing); a copy
    from the host among K7's fails the check. The kernels' counters get
    their saved values back afterwards."""
    import torch

    from madraft_tpu_torch.tpusim import coverage, engine, state

    counts = read_counts()
    cfg = _storm_cfg()
    b = int(s.tick.shape[0])
    dev = s.tick.device
    ids = torch.arange(b, dtype=torch.int32, device=dev)
    # horizon 200: every lane of the tick-200 state retires and refills
    c = engine._Carry(None, keys, ids, torch.tensor(b, dtype=torch.int32,
                                                    device=dev))

    def arm():
        # K7 writes the refilled lanes in place: a copy of the state
        c.wide = state.ClusterState(*(x.contiguous().clone() for x in s))
        if ccfg is not None:
            c.kn_lanes = kn.broadcast(b)
            c.kinds = torch.zeros(b, dtype=torch.int32, device=dev)
            c.new_fps = ids % 2
            c.seen = torch.full((1, ccfg.bitmap_bits), coverage.UNSEEN,
                                dtype=torch.int32, device=dev)

    def harvest(tick):
        return engine._harvest(cfg, kn, c, 12345, 200, False, True, ccfg,
                               tick)

    arm()
    harvest("kernel")  # warm
    h, kernels, wall_ms, avgs, attempts = _profiled(
        lambda: harvest("kernel"), arm, cpu=False, attempts=10,
        expect=HARVEST_OPS)
    _, plain, plain_wall_ms, _, _ = _profiled(lambda: harvest("eager"), arm,
                                              cpu=False)
    set_counts(counts)
    if ccfg is not None:
        h = h.pool
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:5]
    htod = [e.key for e in avgs if "HtoD" in e.key]
    check(kernels, "the profiler saw no device record of a harvest")
    check(not htod, f"a harvest copies from the host: {htod}")
    check(int(h.retired.sum()) == b, f"{int(h.retired.sum())} lanes retired")
    return {
        "phase": "profile_harvest" if ccfg is None
                 else "profile_coverage_harvest", "clusters": b,
        "retired": int(h.retired.sum()), "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_ops": sum(e.count for e in kernels),
        "memcpy_htod": len(htod), "profiler_attempts": attempts,
        "top_device_ms": {e.key[:60]: _dev_us(e) / 1e3 for e in top},
        "plain": {"wall_ms": plain_wall_ms,
                  "device_ops": sum(e.count for e in plain) if plain
                  else None,
                  "device_busy_ms": sum(_dev_us(e) for e in plain) / 1e3
                  if plain else None},
    }


def _harvest_routes(s, keys, kn, errs: dict) -> dict:
    """engine._harvest at the flagship shape (the tick-200 state, horizon
    200: every lane retires) through K7 and through its plain version
    (tick="eager"), packed and wide, plain and with the guided and the
    unguided coverage refill, both id schemes: the carries (the K3-packed
    state, keys, ids, book, knob rows, kinds, credits) and the fetched
    snapshot equal."""
    import numpy as np
    import torch

    from madraft_tpu_torch.tpusim import config, coverage, engine, state

    counts = read_counts()
    cfg = _storm_cfg()
    b = int(s.tick.shape[0])
    dev = s.tick.device
    cases = []
    for ccfg in (None, config.CoverageConfig(),
                 config.CoverageConfig(guided=False)):
        for packed in (True, False):
            for lane_ids in (False, True):
                out = []
                for tick in ("kernel", "eager"):
                    ids = torch.arange(b, dtype=torch.int32, device=dev)
                    book = (torch.zeros(b, dtype=torch.int32, device=dev)
                            if lane_ids else torch.tensor(
                                b, dtype=torch.int32, device=dev))
                    c = engine._Carry(None, keys, ids, book)
                    c.wide = state.ClusterState(
                        *(x.contiguous().clone() for x in s))
                    if ccfg is not None:
                        c.kn_lanes = kn.broadcast(b)
                        c.kinds = torch.zeros(b, dtype=torch.int32,
                                              device=dev)
                        c.new_fps = ids % 2
                        c.seen = torch.full((1, ccfg.bitmap_bits),
                                            coverage.UNSEEN,
                                            dtype=torch.int32, device=dev)
                        c.seen[0, ::5] = 7
                    h = engine._harvest(cfg, kn, c, 12345, 200, lane_ids,
                                        packed, ccfg, tick)
                    carry = [c.keys, c.ids, c.book, *c.states]
                    if ccfg is not None:
                        carry += [c.kinds, c.new_fps, *c.kn_lanes]
                    out.append((h, [x.cpu() for x in carry]))
                (hk, ck), (he, ce) = out
                for a, bb in zip(ck, ce):
                    check(a.dtype == bb.dtype and torch.equal(a, bb),
                          f"K7 route differs from the plain one (coverage "
                          f"{ccfg}, packed {packed}, lane ids {lane_ids})")
                    errs["harvest"] = max(errs["harvest"], max_abs_err(a, bb))
                hk_ = hk.pool if ccfg is not None else hk
                he_ = he.pool if ccfg is not None else he
                check(all(np.array_equal(x, y) for x, y in zip(hk_, he_)),
                      "K7 route's snapshot differs from the plain one's")
                if ccfg is not None:
                    check(hk.seen_bits == he.seen_bits
                          and np.array_equal(hk.new_fps, he.new_fps)
                          and all(np.array_equal(hk.knobs[k], he.knobs[k])
                                  for k in hk.knobs),
                          "K7 route's coverage columns differ")
                cases.append(f"{'cov' if ccfg else 'plain'}"
                             f"{'' if ccfg is None or ccfg.guided else '_random'}"
                             f":{'packed' if packed else 'wide'}"
                             f":{'lane' if lane_ids else 'monotone'}")
    set_counts(counts)
    return {"phase": "k7_routes_flagship_shape", "clusters": b,
            "cases": cases, "max_abs_err": errs["harvest"]}


def _profile_ticks(cfg, s, keys, kn, n_ticks: int, phase: str,
                   tick: str = "eager", cov=None) -> dict:
    """Wall time per tick of ``cfg`` from state ``s``, the card's busy
    share over it, the kernels launched per tick, and the five kernels with
    the most device time, from torch.profiler, over one chunk of n_ticks
    ticks through ``engine._advance`` on route ``tick``: the eager tick
    (the words drawn a chunk at a time, K5 after each tick with ``cov``)
    or K6's launch (its variant for cfg.metrics and ``cov``, the kernel
    drawing the words). Kernel launches here go to the counters' saved
    values afterwards, like the timing phase's."""
    from madraft_tpu_torch.tpusim import engine

    counts = read_counts()
    runs = [cov]

    def arm():  # the caller's seen-set stays as it was
        if cov is not None:
            runs[0] = cov._replace(seen=cov.seen.clone(),
                                   new_fps=cov.new_fps.clone())

    s, kernels, wall_ms, _, attempts = _profiled(
        lambda: engine._advance(cfg, s, keys, kn, n_ticks, runs[0],
                                tick=tick), arm)
    set_counts(counts)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:5]
    return {
        "phase": phase, "ticks": n_ticks, "clusters": int(s.tick.shape[0]),
        "profiler_attempts": attempts, "wall_ms_per_tick": wall_ms / n_ticks,
        "device_busy_ms_per_tick": busy_ms / n_ticks if kernels else None,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "device_ops_per_tick": sum(e.count for e in kernels) / n_ticks,
        "top_device_ms_per_tick": {
            e.key[:60]: _dev_us(e) / 1e3 / n_ticks for e in top},
    }


def _cov_deterministic(summary: dict) -> dict:
    """A coverage pool summary without its run-to-run fields."""
    out = deterministic(summary)
    out["coverage"] = {k: v for k, v in summary["coverage"].items()
                       if k != "new_fingerprints_per_s"}
    return out


def _k5_vs_plain(ccfg, cpu_in, shards, dev, errs: dict, label: str) -> None:
    """K5 on the card against its plain version on the CPU, same planted
    inputs, over three ticks (half the lanes' terms move on between them):
    the stamps and the credits bit-equal after each."""
    import torch

    from madraft_tpu_torch.kernels import coverage as K5
    from madraft_tpu_torch.tpusim import coverage

    b = cpu_in[0].shape[0]
    rows_c = None if shards is None else coverage.lane_shards(b, shards)
    rows_g = None if rows_c is None else rows_c.to(dev)
    seen_c = torch.full((shards or 1, ccfg.bitmap_bits), coverage.UNSEEN,
                        dtype=torch.int32)
    nf_c = torch.zeros(b, dtype=torch.int32)
    seen_g, nf_g = seen_c.to(dev), nf_c.to(dev)
    cpu_in = list(cpu_in)
    for t in range(3):
        K5.seen_update(ccfg, *(x.to(dev) for x in cpu_in), rows_g, seen_g,
                       nf_g, t)
        coverage.seen_update_plain(ccfg, *cpu_in, rows_c, seen_c, nf_c, t)
        errs["seen_update"] = max(errs["seen_update"],
                                  max_abs_err(seen_g.cpu(), seen_c),
                                  max_abs_err(nf_g.cpu(), nf_c))
        check(errs["seen_update"] == 0,
              f"K5 differs from its plain version at {label}, tick {t}")
        cpu_in[2] = torch.where(torch.arange(b)[:, None] % 2 == 1,
                                cpu_in[2] + 1, cpu_in[2])
    check(int(nf_c[8:16].min()) >= 1 and int(nf_c[16:24].max()) == 0,
          f"K5 planted credits at {label}: {nf_c[:32].tolist()}")


def _coverage_fixture_legs(dev, fx: dict) -> None:
    """The JAX package's coverage legs (tests/torch_fixtures/
    coverage_legs.json) on the card: the coverage pools' rows and
    summaries (guided, random, lane ids; metrics off and on), the
    ground-truth guided and random seen counts, and the sweep legs' CLI
    output and per-cluster reports, all bit-equal; each pool harvest a K7
    launch."""
    from madraft_tpu_torch.kernels import harvest as K7
    from madraft_tpu_torch.tpusim import config, engine, prng

    shape = fx["pool_shape"]
    with prng.layout(fx["partitionable"]):
        for name, leg in fx["legs"].items():
            cfg = config.storm_profiles()[fx["profile"]][0].replace(
                metrics=leg["metrics"])
            if leg["majority_override"]:
                cfg = cfg.replace(majority_override=leg["majority_override"])
            rows = []
            before = K7.harvest.launches
            out = engine.run_pool(
                cfg, fx["seed"], leg["lanes"], shape["horizon"],
                chunk_ticks=shape["chunk_ticks"],
                budget_ticks=shape["budget_ticks"], devices=leg["devices"],
                on_retired=rows.append,
                coverage=config.CoverageConfig(guided=leg["guided"]),
                device=dev)
            check(K7.harvest.launches - before == -(-shape["budget_ticks"]
                  // shape["chunk_ticks"]), f"coverage fixture leg {name}: "
                  f"{K7.harvest.launches - before} K7 launches")
            check([deterministic(r) for r in rows] == leg["rows"],
                  f"coverage fixture leg {name}: rows differ")
            got = _cov_deterministic(out)
            bad = {k: (got.get(k), v) for k, v in leg["summary"].items()
                   if got.get(k) != v}
            check(not bad, f"coverage fixture leg {name}: summary differs: "
                  f"{bad}")
            emit({"phase": f"fixture_coverage_{name}", "match": True,
                  "retired": out["retired"],
                  "violating": out["retired_violating"],
                  "seen_fingerprints": out["coverage"]["seen_fingerprints"],
                  "refills_mutated": out["coverage"]["refills_mutated"]})
        gt = fx["ground_truth"]
        cfg, ccfg, horizon = config.coverage_ground_truth()
        seen = {}
        for name, guided in (("guided", True), ("random", False)):
            out = engine.run_pool(cfg, gt["seed"], gt["lanes"], horizon,
                                  budget_ticks=gt["budget_ticks"],
                                  coverage=ccfg.replace(guided=guided),
                                  device=dev)
            check(_cov_deterministic(out)["coverage"] == gt[name],
                  f"ground-truth {name} pool differs")
            seen[name] = out["coverage"]["seen_fingerprints"]
        check(0 < seen["random"] < seen["guided"] <= gt["enumerated"],
              f"ground truth: {seen}, {gt['enumerated']} enumerated")
        emit({"phase": "fixture_coverage_ground_truth", "match": True,
              "seen": seen, "enumerated": gt["enumerated"]})
        for name, leg in fx["sweeps"].items():
            kept = KeepFirst(engine.report, lambda f: f)
            engine.report = kept
            try:
                rc, out = run_cli(leg["argv"])
            finally:
                engine.report = kept.fn
            out.pop("telemetry")
            rep = engine.report(kept.kept[0])
            check(rc == leg["rc"] and out == leg["output"],
                  f"sweep fixture leg {name}: output differs")
            for f, want in leg["report"].items():
                check(getattr(rep, f).tolist() == want,
                      f"sweep fixture leg {name}: field {f} differs")
            emit({"phase": f"fixture_sweep_{name}", "match": True,
                  "dispatch": out["dispatch"], "cells": len(out["cells"])})


def ctrler_knob_rows(kcfg, b: int):
    """[B] ctrler knob rows (on the CPU) that mix the three planted bugs,
    alone and together, the op mix and the retry rate across the batch;
    lanes 0, 5, 10, ... plant no bug. For holding K10 against its plain
    version (phase ``ctrler_k10`` and the K10 host build's tests)."""
    import torch

    kk = kcfg.knobs().broadcast(b)
    i = torch.arange(b)
    return kk._replace(
        bug_rotate_tiebreak=(i % 5 == 1) | (i % 5 == 4),
        bug_greedy_rebalance=i % 5 == 2,
        bug_full_reshuffle=(i % 5 == 3) | (i % 5 == 4),
        p_query=torch.where(i % 2 == 0, 0.3, 0.1).float(),
        p_move=torch.where(i % 3 == 0, 0.3, 0.1).float(),
        p_op=torch.where(i % 4 == 3, 0.6, 0.3).float(),
        p_retry=torch.where(i % 3 == 1, 0.9, 0.5).float())


# ------------------------------------------------------------ the kv path
def _kv_leaves(ks) -> list:
    """Every leaf of a kv state: the raft leaves, then the service ones."""
    return list(ks.raft) + list(ks[1:])


def _kv_err(a, b) -> float:
    return max(max_abs_err(x, y) for x, y in zip(_kv_leaves(a),
                                                   _kv_leaves(b)))


def _kv_cli_cfg(metrics: bool = False):
    """kv-fuzz --storm's configs: the raft config with the service's
    changes and KvConfig(p_get=0.3, p_put=0.2) (the CLI's defaults)."""
    from madraft_tpu_torch.tpusim import kv

    cfg = _storm_cfg().replace(p_client_cmd=0.0, compact_at_commit=False,
                               compact_every=16, metrics=metrics)
    return cfg, kv.KvConfig(p_get=0.3, p_put=0.2)


def _kv_k9(dev, errs: dict) -> dict:
    """Phase kv_k9: K9 and K9-metrics against the plain service tick on
    the card, every leaf after every one of KV_K9_TICKS ticks (the raft
    tick by K6) from a state KV_K9_WARM ticks in, KV_K9_CLUSTERS clusters
    (past a whole number of blocks), in the cases of KV_K9_CASES, each
    acking ops in the compared ticks; the zipf map on the card against
    the CPU's over the Zipf grid. Launches here are not main-path
    launches."""
    import torch

    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import config, engine, kv, prng

    counts = read_counts()
    b = KV_K9_CLUSTERS
    hot = dict(config.profile_gates()["hot_key_openloop"]["workload"],
               p_get=0.3, p_put=0.2)
    done = []
    for name, n, kw, metrics_on, flag in KV_K9_CASES:
        kw = hot if kw == "hot_key" else kw
        cfg, _ = _kv_cli_cfg(metrics_on)
        cfg = cfg.replace(n_nodes=n)
        if name.startswith("hot_key"):
            cfg = config.storm_profiles()["hot_key_openloop"][0].replace(
                p_client_cmd=0.0, compact_at_commit=False,
                metrics=metrics_on)
        kcfg = kv.KvConfig(**({} if kw == "rows" else kw))
        with prng.layout(flag):
            keys = engine.cluster_keys(11, b, dev)
            kn = cfg.knobs(dev)
            kkn = (kv_knob_rows(kcfg, b).to(dev) if kw == "rows"
                   else kcfg.knobs(dev))
            ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
            if name != "storm_mixed_ticks":
                ks = kv._advance_kv(cfg, kcfg, ks, keys, kn, kkn,
                                    KV_K9_WARM)
            else:
                # two halves run to different ticks (a pool's lanes)
                h = b // 2
                ks = kv._advance_kv(cfg, kcfg, ks, keys, kn, kkn, 31)
                tail = kv._advance_kv(
                    cfg, kcfg, kv.init_kv_cluster(cfg, kcfg, keys[h:], kn),
                    keys[h:], kn, kkn, 97)
                ks = kv.KvState(*(
                    type(x)(*(torch.cat([p[:h], q]) for p, q in zip(x, y)))
                    if isinstance(x, tuple) else torch.cat([x[:h], y])
                    for x, y in zip(ks, tail)))
            table = K9.knob_table(kn, kkn, b)
            err, acked0 = 0.0, int(ks.clerk_acked.sum())
            for _ in range(KV_K9_TICKS):
                pre = ks.raft
                s = K6.tick_chunk(cfg, pre, keys, kn, 1)
                want = kv._kv_service_tick(cfg, kcfg, ks, pre.alive,
                                           pre.base, pre.shadow_len, s, keys,
                                           kn, kkn)
                got = K9.kv_tick(cfg, kcfg, ks, pre.alive, pre.base,
                                 pre.shadow_len, s, keys, kn, kkn, table)
                err = max(err, _kv_err(got, want))
                ks = want
        key = "kv_tick_metrics" if metrics_on else "kv_tick"
        errs[key] = max(errs[key], err)
        check(err == 0, f"K9 differs from its plain version: case {name}")
        acked = int(ks.clerk_acked.sum()) - acked0
        check(acked > 0, f"kv_k9 case {name}: no op acked in its ticks")
        done.append({"case": name, "n_nodes": n, "metrics": metrics_on,
                     "partitionable": flag,
                     "violating": int((ks.raft.violations != 0).sum()),
                     "acked_in_compared_ticks": acked})
    # config.zipf_map on the card against the CPU, every draw of the grid
    zipf = []
    for nk in (4, 8, 16):
        d = torch.arange(nk, dtype=torch.int32)
        for a in (1.0, 1.5, 2.0, 3.0):
            at = torch.tensor(a, dtype=torch.float32)
            got = config.zipf_map(d.to(dev), nk, at.to(dev)).cpu()
            zipf.append([nk, a, int((got != config.zipf_map(d, nk, at)).sum())])
    check(all(x[2] == 0 for x in zipf), f"zipf_map card vs CPU: {zipf}")
    set_counts(counts)
    return {"phase": "kv_k9", "clusters": b, "ticks": KV_K9_TICKS,
            "cases": done, "zipf_grid_cells_differing": zipf,
            "max_abs_err": max(errs["kv_tick"], errs["kv_tick_metrics"])}


def _kv_k6kv(dev, errs: dict) -> dict:
    """Phase kv_k6kv: K6-kv and K6-metrics-kv against the plain route
    (``step_cluster``, then the plain service tick) on the card, every
    leaf after every launch of KV_K6KV_LAUNCHES ticks (the last a short
    one): the kv flagship's batch at tick 200 in both builds, then K9's
    cases (KV_K9_CASES, KV_K6KV_CLUSTERS clusters, a tile past the
    batch's end) from KV_K9_WARM ticks in on K6-kv, each acking ops in
    the compared ticks; and ptxas's report of both builds. Launches here
    are not main-path launches."""
    import torch

    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.tpusim import config, engine, kv, prng

    counts = read_counts()

    def compare(cfg, kcfg, ks, keys, kn, kkn):
        err, acked0 = 0.0, int(ks.clerk_acked.sum())
        for m in KV_K6KV_LAUNCHES:
            got = K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn, m)
            want = K9.kv_chunk_plain(cfg, kcfg, ks, keys, kn, kkn, m)
            err = max(err, _kv_err(got, want))
            ks = want
        return err, int(ks.clerk_acked.sum()) - acked0, ks

    done = []
    prng.set_partitionable(True)
    for metrics_on in (False, True):
        cfg, kcfg, ks, keys, kn, kkn = _kv_state(dev, metrics_on)
        err, acked, ks = compare(cfg, kcfg, ks, keys, kn, kkn)
        key = "kv_chunk_metrics" if metrics_on else "kv_chunk"
        errs[key] = max(errs[key], err)
        check(err == 0 and acked > 0,
              f"K6-kv (metrics {metrics_on}) at the flagship's batch: err "
              f"{err}, {acked} ops acked")
        done.append({"case": "flagship_tick_200", "clusters": int(
            keys.shape[0]), "metrics": metrics_on, "acked": acked})
    b = KV_K6KV_CLUSTERS
    hot = dict(config.profile_gates()["hot_key_openloop"]["workload"],
               p_get=0.3, p_put=0.2)
    for name, n, kw, metrics_on, flag in KV_K9_CASES:
        kw = hot if kw == "hot_key" else kw
        cfg, _ = _kv_cli_cfg(metrics_on)
        cfg = cfg.replace(n_nodes=n)
        if name.startswith("hot_key"):
            cfg = config.storm_profiles()["hot_key_openloop"][0].replace(
                p_client_cmd=0.0, compact_at_commit=False,
                metrics=metrics_on)
        kcfg = kv.KvConfig(**({} if kw == "rows" else kw))
        with prng.layout(flag):
            keys = engine.cluster_keys(11, b, dev)
            kn = cfg.knobs(dev)
            kkn = (kv_knob_rows(kcfg, b).to(dev) if kw == "rows"
                   else kcfg.knobs(dev))
            ks = kv.init_kv_cluster(cfg, kcfg, keys, kn)
            if name != "storm_mixed_ticks":
                ks = kv._advance_kv(cfg, kcfg, ks, keys, kn, kkn,
                                    KV_K9_WARM)
            else:
                # two halves run to different ticks (a pool's lanes)
                h = b // 2
                ks = kv._advance_kv(cfg, kcfg, ks, keys, kn, kkn, 31)
                tail = kv._advance_kv(
                    cfg, kcfg, kv.init_kv_cluster(cfg, kcfg, keys[h:], kn),
                    keys[h:], kn, kkn, 97)
                ks = kv.KvState(*(
                    type(x)(*(torch.cat([p[:h], q]) for p, q in zip(x, y)))
                    if isinstance(x, tuple) else torch.cat([x[:h], y])
                    for x, y in zip(ks, tail)))
            err, acked, ks = compare(cfg, kcfg, ks, keys, kn, kkn)
        key = "kv_chunk_metrics" if metrics_on else "kv_chunk"
        errs[key] = max(errs[key], err)
        check(err == 0, f"K6-kv differs from the plain route: case {name}")
        check(acked > 0, f"kv_k6kv case {name}: no op acked in its ticks")
        done.append({"case": name, "n_nodes": n, "metrics": metrics_on,
                     "partitionable": flag,
                     "violating": int((ks.raft.violations != 0).sum()),
                     "acked_in_compared_ticks": acked})
    prng.set_partitionable(True)
    ptxas = {name: _build.ptxas(name) for name in ("tick_kv",
                                                   "tick_metrics_kv")}
    spills = {k: r["spills"] for k, r in ptxas.items() if r["spills"]}
    check(not spills, f"K6-kv's builds spill: {spills}")
    set_counts(counts)
    return {"phase": "kv_k6kv", "launches": list(KV_K6KV_LAUNCHES),
            "cases": done, "ptxas": ptxas,
            "max_abs_err": max(errs["kv_chunk"], errs["kv_chunk_metrics"])}


def _report_fields(out: dict) -> dict:
    """A CLI report's deterministic fields: all but the telemetry and the
    determinism check."""
    return {k: v for k, v in out.items()
            if k not in ("telemetry", "deterministic")}


def _kv_path(dev) -> tuple:
    """The kv main path through the CLI: the kv flagship twice
    (--check-deterministic), then with --metrics, each on K6-kv alone
    (launches of up to KERNEL_CHUNK ticks, no K6 or K9 launch) and with
    the report of the eager route on the card at the same depth (the
    plain service tick after the eager raft tick); the CPU route's report
    at the flagship's batch over KV_CPU_TICKS ticks beside the card's;
    the eager-vs-kernel A/B at KV_AB_TICKS ticks. Returns (the flagship's
    launches, the metrics flagship's)."""
    from madraft_tpu_torch.tpusim import engine, kv, prng

    prng.set_partitionable(True)
    ticks, b = _flag(KV_FLAGSHIP, "--ticks"), _flag(KV_FLAGSHIP, "--clusters")
    eager_off = ("threefry_tick_blocks", "oracle", "oracle_metrics",
                 "latency_fold", "seen_update")
    advance = kv._advance_kv  # every kv run's ticks go through it
    runs = {}
    for label, argv in (("kv_flagship", KV_FLAGSHIP),
                        ("kv_metrics_flagship", KV_METRICS_FLAGSHIP)):
        metrics_on = "--metrics" in argv
        set_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        wall = time.perf_counter() - t0
        ran = read_counts()
        want = -(-ticks // engine.KERNEL_CHUNK) * FLAGSHIP_RUNS
        check(rc == 0 and out["violating"] == 0
              and out.get("deterministic") is True
              and out["acked_ops_mean"] > 0,
              f"{label} rc {rc}: {out}")
        check(ran["kv_chunk"] == want
              and ran["kv_chunk_metrics"] == want * metrics_on
              and ran["tick_chunk"] == ran["kv_tick"] == 0
              and all(ran[k] == 0 for k in eager_off)
              and ran["harvest"] == ran["record"] == 0,
              f"{label} launches {ran}: want K6-kv once a "
              f"{engine.KERNEL_CHUNK}-tick chunk ({want}), no K6, K9, draw "
              "chunk, K2, K4 or K5 launch")
        # the eager route on the card at the flagship's depth: the same
        # report
        kv._advance_kv = functools.partial(advance, tick="eager")
        try:
            rc_e, out_e = run_cli([x for x in argv
                                   if x != "--check-deterministic"])
        finally:
            kv._advance_kv = advance
        check(rc_e == 0 and _report_fields(out_e) == _report_fields(out),
              f"{label}: the eager route's report differs from K6-kv's")
        tele = out["telemetry"]
        row = {"phase": label, "argv": argv, "rc": rc,
               "cluster_steps_per_s": tele["steps_per_sec"],
               "execute_s": tele["execute_s"],
               "wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
               "wall_s_both_runs": round(wall, 3),
               "compile_s": tele["compile_s"],
               "bytes_per_lane": tele["bytes_per_lane"],
               "acked_ops_mean": out["acked_ops_mean"],
               "eager_route_report_equal": True,
               "eager_route_wall_ms_per_tick": out_e["telemetry"][
                   "execute_s"] / ticks * 1e3,
               "launches": {k: v for k, v in ran.items() if v}}
        if metrics_on:
            lat = out["latency"]
            check(all(k in out for k in METRIC_KEYS)
                  and all(k in lat for k in ("phases", "by_key",
                                             "by_client"))
                  and all("retries" in d for d in lat["by_client"].values()),
                  f"kv metrics report lacks a block: {sorted(out)} "
                  f"{sorted(lat)}")
            # the latency mass is the acked ops, on each axis too
            ops = lat["ops"]
            check(round(ops / b, 2) == out["acked_ops_mean"]
                  and sum(d["ops"] for d in lat["by_key"].values()) == ops
                  and sum(d["ops"] for d in lat["by_client"].values()) == ops
                  and all(d["ops"] == ops for d in lat["phases"].values()),
                  f"kv latency mass {ops} vs acked {out['acked_ops_mean']}")
            row.update(p50_ticks=lat["p50_ticks"], p99_ticks=lat["p99_ticks"],
                       ops=ops)
        emit(row)
        runs[label] = ran

    # the CPU route at the flagship's batch, KV_CPU_TICKS ticks, beside the
    # card's K6-kv
    cpu = {}
    for metrics_on in (False, True):
        argv = KV_FLAGSHIP[:2] + ["--clusters", str(b), "--ticks",
                                  str(KV_CPU_TICKS), "--seed", "12345"] + [
            "--metrics"] * metrics_on
        set_counts()
        rc_k, out_k = run_cli(argv)
        ran = read_counts()
        t0 = time.perf_counter()
        rc_c, out_c = run_cli(argv + ["--platform", "cpu"])
        cpu_s = time.perf_counter() - t0
        check(rc_k == rc_c == 0 and ran["kv_chunk"] == 1
              and _report_fields(out_k) == _report_fields(out_c),
              f"kv at {b} x {KV_CPU_TICKS} (metrics {metrics_on}): the CPU "
              f"route's report differs from K6-kv's ({ran})")
        cpu["metrics" if metrics_on else "plain"] = {
            "report_equal": True, "cpu_route_s": round(cpu_s, 3),
            "acked_ops_mean": out_c["acked_ops_mean"]}
    emit({"phase": "kv_cpu_route", "clusters": b, "ticks": KV_CPU_TICKS,
          **cpu})

    # the A/B: the flagship's shape at KV_AB_TICKS ticks, eager (the
    # eager tick, the plain service tick) and kernel (K6-kv) in turns
    cfg, kcfg = _kv_cli_cfg()
    ab, reps = [], []
    for route in ("eager", "kernel", "kernel", "eager"):
        set_counts()
        kv._advance_kv = functools.partial(advance, tick=route)
        try:
            fn = kv.make_kv_fuzz_fn(cfg, kcfg, b, KV_AB_TICKS, dev)
            rep, tele = engine.run_telemetry(fn, kv.kv_report, 12345,
                                             b * KV_AB_TICKS, n_lanes=b)
        finally:
            kv._advance_kv = advance
        ran = read_counts()
        kernel = route == "kernel"
        check(ran["kv_chunk"] == int(kernel)
              and ran["tick_chunk"] == ran["kv_tick"] == 0
              and (ran["oracle"] == KV_AB_TICKS * (not kernel)),
              f"kv A/B {route} launches {ran}")
        reps.append(rep)
        ab.append({"route": route, "ticks": KV_AB_TICKS,
                   "cluster_steps_per_s": tele["steps_per_sec"],
                   "wall_ms_per_tick": tele["execute_s"] / KV_AB_TICKS
                   * 1e3,
                   "launches": {k: v for k, v in ran.items() if v}})
    from madraft_tpu_torch.__main__ import _reports_equal

    check(all(_reports_equal(reps[0], r) for r in reps[1:]),
          "kv A/B: the eager and the kernel route's reports differ")
    rate = {r: sum(x["cluster_steps_per_s"] for x in ab
                   if x["route"] == r) / 2 for r in ("eager", "kernel")}
    emit({"phase": "kv_ab", "card": _smi(), "clusters": b, "runs": ab,
          "reports_equal": True,
          "kernel_over_eager": rate["kernel"] / rate["eager"]})

    return runs["kv_flagship"], runs["kv_metrics_flagship"]


def _kv_state(dev, metrics_on: bool, ticks: int = 200):
    """The kv flagship's batch after ``ticks`` ticks on K6-kv, and its
    configs, keys and knobs."""
    from madraft_tpu_torch.tpusim import engine, kv

    cfg, kcfg = _kv_cli_cfg(metrics_on)
    b = _flag(KV_FLAGSHIP, "--clusters")
    keys = engine.cluster_keys(12345, b, dev)
    kn, kkn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = kv._advance_kv(cfg, kcfg, kv.init_kv_cluster(cfg, kcfg, keys, kn),
                        keys, kn, kkn, ticks)
    return cfg, kcfg, ks, keys, kn, kkn


def _kv_bytes(cfg, kcfg, ks, s, keys, table, written) -> dict:
    """The bytes one service tick must move (``_kv_timing``): every
    service leaf and every raft leaf it writes read once and written once,
    the stepped raft leaves it reads, the pre-tick views, keys and knob
    rows read once, except the two [n, cap] log rows, of which the tick
    reads only the log_val slots its apply rounds reach (this run's
    count) and writes only the appended entries (a term and a value
    each)."""
    import torch

    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.tpusim import kv

    pre = ks.raft
    logs = ("log_term", "log_val")
    state = ([getattr(ks, f) for f in kv.SERVICE]
             + [getattr(s, f) for f in K9.RAFT_WRITES if f not in logs])
    reads = ([getattr(s, f) for f in K9.RAFT_READS]
             + [pre.alive, pre.base, pre.shadow_len, keys, *table])
    # the apply rounds that ran: each advanced a cursor from its start
    # (the snapshot's base after a crash or an install)
    reset = (~pre.alive | ~s.alive | (s.snap_installed_src >= 0))
    start = torch.where(reset, s.base, ks.applied)
    rounds = int((written.applied - start).sum())
    appends = int((written.raft.log_len - s.log_len).sum())
    out = {"state_read_and_written": 2 * nbytes(*state),
           "reads": nbytes(*reads), "log_val_slots_read": rounds,
           "log_entries_appended": appends}
    out["total"] = (out["state_read_and_written"] + out["reads"]
                    + 4 * rounds + 8 * appends)
    return out


def _kv_timing(dev) -> tuple:
    """K9's and K9-metrics' times at the kv flagship's shape (tick 200 to
    201): (name -> (device ms, call ms, plain ms, bytes, operations), the
    timing phase's tuple; name -> ``_kv_bytes``' count). Each launch reads
    its inputs from device memory (copies in rotation); the operations are
    the tick's 57 threefry hashes a cluster, the shadow and log scans (8 a
    lane) and the apply rounds (30 a node a round)."""
    import torch

    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import kv

    counts = read_counts()
    out, counted = {}, {}
    for name, metrics_on in (("kv_tick", False), ("kv_tick_metrics", True)):
        cfg, kcfg, ks, keys, kn, kkn = _kv_state(dev, metrics_on)
        b, n, cap = keys.shape[0], cfg.n_nodes, cfg.log_cap
        pre = ks.raft
        s = K6.tick_chunk(cfg, pre, keys, kn, 1)
        table = K9.knob_table(kn, kkn, b)
        inputs = (_kv_leaves(ks)[len(pre):] + [
            getattr(s, f) for f in K9.RAFT_READS + K9.RAFT_WRITES] + [
            pre.alive, pre.base, pre.shadow_len, keys, *table])
        written = K9.kv_tick(cfg, kcfg, ks, pre.alive, pre.base,
                             pre.shadow_len, s, keys, kn, kkn, table)
        counted[name] = _kv_bytes(cfg, kcfg, ks, s, keys, table, written)
        n_in = nbytes(*inputs)
        rot = [(ks, s)] + [
            (kv.KvState(*(type(x)(*(y.clone() for y in x))
                          if isinstance(x, tuple) else x.clone()
                          for x in ks)),
             type(s)(*(x.clone() for x in s)))
            for _ in range(rotations(n_in) - 1)]

        def call(i, plain=False):
            k, st = rot[i % len(rot)]
            return K9.kv_tick(cfg, kcfg, k, pre.alive, pre.base,
                              pre.shadow_len, st, keys, kn, kkn, table,
                              plain=plain)

        ops = b * (57 * OPS_PER_HASH + 8 * cap
                   + kcfg.n_clients * cap * 2 + 30 * n * kcfg.apply_max)
        out[name] = (device_ms(call, "kv_kernel"), cuda_ms(call),
                     cuda_ms(lambda i: call(i, True), iters=20),
                     counted[name]["total"], ops)
        del rot
    set_counts(counts)
    return out, counted


def _k6kv_timing(dev, plain: bool = True) -> dict:
    """K6-kv's and K6-metrics-kv's times at the kv flagship's shape, one
    KERNEL_CHUNK-tick launch from tick 200: name -> (device ms, call ms,
    plain ms (None without ``plain``), bytes, operations). The bytes: K6's state (the metric leaves
    with metrics) and the kv state's service leaves read and written once,
    the keys and both knob tables read once, and the log_val slots the
    apply rounds read (this run's count, from the plain version's ticks,
    though those reads hit the block K6-kv staged). The operations: per
    cluster-tick K6's draws (2 + total hashes and a word each) and the
    service tick's (57 hashes, the shadow and log scans, the apply
    rounds), as K6's and K9's rows count them."""
    import torch

    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import engine, kv, step
    from madraft_tpu_torch.tpusim.state import METRIC_LEAF0

    counts = read_counts()
    out = {}
    m = engine.KERNEL_CHUNK
    for name, metrics_on in (("kv_chunk", False), ("kv_chunk_metrics", True)):
        cfg, kcfg, ks, keys, kn, kkn = _kv_state(dev, metrics_on)
        b, n, cap = int(keys.shape[0]), cfg.n_nodes, cfg.log_cap
        table, ktable = K6.knob_table(kn, b), K9.knob_table(kn, kkn, b)

        def call(i):
            return K9.kv_chunk(cfg, kcfg, ks, keys, kn, kkn, m, table,
                               ktable)

        # the plain version, its apply rounds counted on the device
        rounds = torch.zeros((), dtype=torch.int64, device=dev)

        def run_plain(i):
            k = ks
            for _ in range(m):
                pre = k.raft
                s = step.step_cluster(cfg, pre, keys, kn)
                k2 = kv._kv_service_tick(cfg, kcfg, k, pre.alive, pre.base,
                                         pre.shadow_len, s, keys, kn, kkn)
                reset = ~pre.alive | ~s.alive | (s.snap_installed_src >= 0)
                rounds.add_((k2.applied - torch.where(
                    reset, s.base, k.applied)).sum())
                k = k2
            return k

        raft = ks.raft[:METRIC_LEAF0] if not metrics_on else ks.raft
        total = step._block_total(n)
        ops = b * m * ((2 + total) * OPS_PER_HASH + total
                       + 57 * OPS_PER_HASH + 8 * cap
                       + kcfg.n_clients * cap * 2
                       + 30 * n * kcfg.apply_max)
        plain_ms = (cuda_ms(run_plain, iters=1, warmup=0) if plain
                    else None)
        nb = (2 * nbytes(*raft, *ks[1:]) + nbytes(keys, *table, *ktable)
              + 4 * int(rounds))
        out[name] = (device_ms(call, "tick_chunk_kernel", iters=10, warmup=1),
                     cuda_ms(call, iters=5, warmup=1), plain_ms, nb, ops)
    set_counts(counts)
    return out


def _kv_phases(dev) -> dict:
    """Where a K9 launch's time goes at the kv flagship's shape (tick 200
    to 201): the profile build's clock64() cycles a phase from each warp's
    start (kernels/kv.py PHASES), median and max over the clusters; the
    profile build's state held against K9's."""
    import ctypes

    import numpy as np
    import torch

    from madraft_tpu_torch.kernels import kv as K9
    from madraft_tpu_torch.kernels import tick as K6

    counts = read_counts()
    cfg, kcfg, ks, keys, kn, kkn = _kv_state(dev, False)
    b, pre = int(keys.shape[0]), ks.raft
    s = K6.tick_chunk(cfg, pre, keys, kn, 1)
    table = K9.knob_table(kn, kkn, b)
    lib = K9._lib("kv_profile")
    lib.kv_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kv_phase_cycles.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(3):  # the last launch's cycles, past the first's misses
        got = K9._launch(cfg, kcfg, ks, pre.alive, pre.base, pre.shadow_len,
                         s, keys, table, lib, stream)
    torch.cuda.synchronize()
    want = K9.kv_tick(cfg, kcfg, ks, pre.alive, pre.base, pre.shadow_len, s,
                      keys, kn, kkn, table)
    check(_kv_err(got, want) == 0, "K9's profile build differs from K9")
    ends = np.zeros((b, len(K9.PHASES)), dtype=np.int64)
    check(lib.kv_phase_cycles(ends.ctypes.data, b) == 0, "kv_phase_cycles")
    per = np.diff(ends, axis=1, prepend=0)
    set_counts(counts)
    return {"phase": "kv_phases", "clusters": b,
            "median_cycles": dict(zip(K9.PHASES,
                                      np.median(per, 0).tolist())),
            "max_cycles": dict(zip(K9.PHASES, per.max(0).tolist())),
            "median_total_cycles": float(np.median(ends[:, -1]))}


def _profile_kv_tick(dev, metrics_on: bool, n_ticks: int = 512) -> dict:
    """Where a kv flagship tick's wall goes (torch.profiler, the window
    retry of ``_profiled``): the device operations a tick, the card's busy
    share of the wall, and K6-kv's share, over n_ticks ticks from tick 200
    (the flagship's depth: two K6-kv launches)."""
    from madraft_tpu_torch.tpusim import engine, kv

    cfg, kcfg, ks, keys, kn, kkn = _kv_state(dev, metrics_on)
    counts = read_counts()
    # every K6-kv launch of the window, or the shares would be of a part
    _, kernels, wall_ms, _, attempts = _profiled(
        lambda: kv._advance_kv(cfg, kcfg, ks, keys, kn, kkn, n_ticks),
        expect={"tick_chunk_kernel": -(-n_ticks // engine.KERNEL_CHUNK)})
    set_counts(counts)

    def share(name):
        us = sum(_dev_us(e) for e in kernels if name in e.key)
        return us / 1e3 / wall_ms

    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    return {"phase": "profile_kv_tick" + "_metrics" * metrics_on,
            "ticks": n_ticks, "clusters": int(keys.shape[0]),
            "profiler_attempts": attempts,
            "wall_ms_per_tick": wall_ms / n_ticks,
            "device_busy_ms_per_tick": busy_ms / n_ticks,
            "device_busy_share": busy_ms / wall_ms,
            "k6kv_share": share("tick_chunk_kernel"),
            "host_share": 1 - busy_ms / wall_ms,
            "device_ops_per_tick": sum(e.count for e in kernels) / n_ticks,
            "top_device_ms_per_tick": {
                e.key[:60]: _dev_us(e) / 1e3 / n_ticks for e in sorted(
                    kernels, key=_dev_us, reverse=True)[:5]}}


# -------------------------------------------------------- the ctrler path
def _ctrler_cli_cfg(metrics: bool = False):
    """ctrler-fuzz --storm's configs: the raft config with the service's
    changes (log_cap 32, compact_every 8) and CtrlerConfig(p_query=0.3,
    p_move=0.1) (the CLI's defaults)."""
    from madraft_tpu_torch.tpusim import ctrler

    cfg = _storm_cfg().replace(p_client_cmd=0.0, compact_at_commit=False,
                               log_cap=32, compact_every=8, metrics=metrics)
    return cfg, ctrler.CtrlerConfig(p_query=0.3, p_move=0.1)


def _ctrler_case(dev, b: int, name: str, n: int, kw, metrics_on: bool):
    """One of CTRLER_K10_CASES set up on the card, under the caller's
    threefry layout: (cfg, kcfg, keys, kn, ckn, the state CTRLER_K10_WARM
    ticks in; for ``storm_mixed_ticks`` two halves at ticks 31 and 97, a
    pool's lanes)."""
    import torch

    from madraft_tpu_torch.tpusim import ctrler, engine

    cfg, _ = _ctrler_cli_cfg(metrics_on)
    cfg = cfg.replace(n_nodes=n)
    kcfg = ctrler.CtrlerConfig(**({} if kw == "rows" else kw))
    keys = engine.cluster_keys(11, b, dev)
    kn = cfg.knobs(dev)
    ckn = (ctrler_knob_rows(kcfg, b).to(dev) if kw == "rows"
           else kcfg.knobs(dev))
    ks = ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn)
    if name != "storm_mixed_ticks":
        ks = ctrler._advance_ctrler(cfg, kcfg, ks, keys, kn, ckn,
                                    CTRLER_K10_WARM)
        return cfg, kcfg, keys, kn, ckn, ks
    h = b // 2
    ks = ctrler._advance_ctrler(cfg, kcfg, ks, keys, kn, ckn, 31)
    tail = ctrler._advance_ctrler(
        cfg, kcfg, ctrler.init_ctrler_cluster(cfg, kcfg, keys[h:], kn),
        keys[h:], kn, ckn, 97)
    ks = ctrler.CtrlerState(*(
        type(x)(*(torch.cat([p[:h], q]) for p, q in zip(x, y)))
        if isinstance(x, tuple) else torch.cat([x[:h], y])
        for x, y in zip(ks, tail)))
    return cfg, kcfg, keys, kn, ckn, ks


def _ctrler_k10(dev, errs: dict) -> dict:
    """Phase ctrler_k10: K10 and K10-metrics against the plain service
    tick on the card, every leaf after every one of CTRLER_K10_TICKS ticks
    (the raft tick by K6) from a state CTRLER_K10_WARM ticks in,
    CTRLER_K10_CLUSTERS clusters (past a whole number of blocks), in the
    cases of CTRLER_K10_CASES, each creating configs and completing
    Queries in the compared ticks. Launches here are not main-path
    launches."""
    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import ctrler, prng

    counts = read_counts()
    b = CTRLER_K10_CLUSTERS
    done = []
    for name, n, kw, metrics_on, flag in CTRLER_K10_CASES:
        with prng.layout(flag):
            cfg, kcfg, keys, kn, ckn, ks = _ctrler_case(dev, b, name, n, kw,
                                                        metrics_on)
            table = K10.knob_table(kn, ckn, b)
            err = 0.0
            start = [int(x.sum()) for x in (ks.clerk_acked, ks.w_cfg_num,
                                            ks.queries_done)]
            for _ in range(CTRLER_K10_TICKS):
                pre = ks.raft
                s = K6.tick_chunk(cfg, pre, keys, kn, 1)
                want = ctrler._ctrler_service_tick(cfg, kcfg, ks, pre.alive,
                                                   pre.base, s, keys, kn, ckn)
                got = K10.ctrler_tick(cfg, kcfg, ks, pre.alive, pre.base, s,
                                      keys, kn, ckn, table)
                err = max(err, _kv_err(got, want))
                ks = want
        key = "ctrler_tick_metrics" if metrics_on else "ctrler_tick"
        errs[key] = max(errs[key], err)
        check(err == 0, f"K10 differs from its plain version: case {name}")
        acked, configs, queries = (
            int(x.sum()) - s0 for x, s0 in zip(
                (ks.clerk_acked, ks.w_cfg_num, ks.queries_done), start))
        check(acked > 0 and configs > 0 and queries > 0,
              f"ctrler_k10 case {name}: in its compared ticks {acked} acks, "
              f"{configs} configs, {queries} Queries")
        done.append({"case": name, "n_nodes": n, "metrics": metrics_on,
                     "partitionable": flag,
                     "violating": int((ks.raft.violations != 0).sum()),
                     "configs_in_compared_ticks": configs,
                     "queries_in_compared_ticks": queries,
                     "history_full": int((ks.w_cfg_num
                                          == kcfg.n_configs - 1).sum())})
    set_counts(counts)
    return {"phase": "ctrler_k10", "clusters": b, "ticks": CTRLER_K10_TICKS,
            "cases": done,
            "max_abs_err": max(errs["ctrler_tick"],
                               errs["ctrler_tick_metrics"])}


def _ctrler_k6ctrler(dev, errs: dict) -> dict:
    """Phase ctrler_k6ctrler: K6-ctrler and K6-metrics-ctrler against the
    plain route (``step_cluster``, then the plain service tick) on the
    card, every leaf after every launch of CTRLER_K6C_LAUNCHES ticks (the
    last a short one): the ctrler flagship's batch at tick 200 in both
    builds, then K10's cases (CTRLER_K10_CASES, CTRLER_K6C_CLUSTERS
    clusters, a tile past the batch's end) from CTRLER_K10_WARM ticks in
    on K6-ctrler, each acking ops, creating configs and completing Queries
    in the compared ticks; then ptxas's report of both builds, and a
    256-tick launch of the flagship's batch on the builds' (5, 32)
    instance beside one on the runtime instance (``ae_max`` one past
    ``K6.SHAPE_AE``) and, on the (5, 32) instance, one with no walker step
    (``walk_max`` 0) and one with no apply round (``apply_max`` 0): an
    ablation estimate of the truth walker's and the apply rounds' shares
    of a launch (not the same run: without the walker no Query acks,
    without the rounds no config is made). Launches here are not main-path
    launches."""
    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import engine, prng

    counts = read_counts()

    def totals(ks):
        return [int(x.sum()) for x in (ks.clerk_acked, ks.w_cfg_num,
                                       ks.queries_done)]

    def compare(cfg, kcfg, ks, keys, kn, ckn):
        err, start = 0.0, totals(ks)
        for m in CTRLER_K6C_LAUNCHES:
            got = K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, m)
            want = K10.ctrler_chunk_plain(cfg, kcfg, ks, keys, kn, ckn, m)
            err = max(err, _kv_err(got, want))
            ks = want
        return err, [x - x0 for x, x0 in zip(totals(ks), start)], ks

    done = []
    prng.set_partitionable(True)
    for metrics_on in (False, True):
        cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, metrics_on)
        err, (acked, configs, queries), ks = compare(cfg, kcfg, ks, keys, kn,
                                                      ckn)
        key = "ctrler_chunk_metrics" if metrics_on else "ctrler_chunk"
        errs[key] = max(errs[key], err)
        check(err == 0 and acked > 0,
              f"K6-ctrler (metrics {metrics_on}) at the flagship's batch: "
              f"err {err}, {acked} ops acked")
        done.append({"case": "flagship_tick_200", "clusters": int(
            keys.shape[0]), "metrics": metrics_on, "acked": acked,
            "configs": configs, "queries": queries})
    b = CTRLER_K6C_CLUSTERS
    for name, n, kw, metrics_on, flag in CTRLER_K10_CASES:
        with prng.layout(flag):
            cfg, kcfg, keys, kn, ckn, ks = _ctrler_case(dev, b, name, n, kw,
                                                        metrics_on)
            err, (acked, configs, queries), ks = compare(cfg, kcfg, ks, keys,
                                                          kn, ckn)
        key = "ctrler_chunk_metrics" if metrics_on else "ctrler_chunk"
        errs[key] = max(errs[key], err)
        check(err == 0, f"K6-ctrler differs from the plain route: case {name}")
        check(acked > 0 and configs > 0 and queries > 0,
              f"ctrler_k6ctrler case {name}: in its compared ticks {acked} "
              f"acks, {configs} configs, {queries} Queries")
        done.append({"case": name, "n_nodes": n, "metrics": metrics_on,
                     "partitionable": flag,
                     "instance": K6.instance(cfg, ctrler=True),
                     "violating": int((ks.raft.violations != 0).sum()),
                     "configs_in_compared_ticks": configs,
                     "queries_in_compared_ticks": queries,
                     "installs": int(ks.raft.snap_install_count.sum())})
    prng.set_partitionable(True)
    ptxas = {name: _build.ptxas(name) for name in ("tick_ctrler",
                                                   "tick_metrics_ctrler")}
    # the flagship's batch from tick 200: a 256-tick launch on the (5, 32)
    # instance and on the runtime one
    cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, False)
    table = K6.knob_table(kn, int(keys.shape[0]))
    ctable = K10.knob_table(kn, ckn, int(keys.shape[0]))
    m = engine.KERNEL_CHUNK
    rcfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)
    instances = {}
    for label, c, kc in (("instance_5x32", cfg, kcfg),
                         ("runtime", rcfg, kcfg),
                         ("walk_max_0", cfg, kcfg.replace(walk_max=0)),
                         ("apply_max_0", cfg, kcfg.replace(apply_max=0))):
        instances[label] = {
            "instance": K6.instance(c, ctrler=True),
            "ms": device_ms(lambda i, c=c, kc=kc: K10.ctrler_chunk(
                c, kc, ks, keys, kn, ckn, m, table, ctable),
                "tick_chunk_kernel", iters=5, warmup=1)}
    full = instances["instance_5x32"]["ms"]
    for label in ("walk_max_0", "apply_max_0"):
        instances[label]["share_estimate"] = 1 - instances[label]["ms"] / full
    set_counts(counts)
    return {"phase": "ctrler_k6ctrler", "card": _smi(),
            "launches": list(CTRLER_K6C_LAUNCHES), "clusters": b,
            "cases": done, "ptxas": ptxas,
            "spills": {k: r["spills"] for k, r in ptxas.items()
                       if r["spills"]},
            "flagship_launch_256_ticks": instances,
            "max_abs_err": max(errs["ctrler_chunk"],
                               errs["ctrler_chunk_metrics"])}


def _ctrler_path(dev) -> tuple:
    """The ctrler main path through the CLI: the ctrler flagship twice
    (--check-deterministic), then with --metrics, each on K6-ctrler alone
    (launches of up to KERNEL_CHUNK ticks, no K6 or K10 launch); the
    flagship's report beside the eager route's on the card at the same
    depth (the plain service tick after the eager raft tick: about a
    minute, so the metrics flagship's is held to the CPU route's below and
    K6-metrics-ctrler to its plain version in ctrler_k6ctrler); the CPU
    route's report
    at the flagship's batch over CTRLER_CPU_TICKS ticks beside the
    card's; the sweep's [B] knob rows and ``ctrler_replay_cluster`` on
    K6-ctrler; the eager-vs-kernel A/B at CTRLER_AB_TICKS ticks. Returns
    (the flagship's launches, the metrics flagship's)."""
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import ctrler, engine, prng

    prng.set_partitionable(True)
    ticks = _flag(CTRLER_FLAGSHIP, "--ticks")
    b = _flag(CTRLER_FLAGSHIP, "--clusters")
    eager_off = ("threefry_tick_blocks", "oracle", "oracle_metrics",
                 "latency_fold", "seen_update", "kv_tick", "kv_chunk",
                 "harvest", "record", "tick_chunk", "ctrler_tick")
    advance = ctrler._advance_ctrler  # every ctrler run's ticks go through it
    runs = {}
    for label, argv in (("ctrler_flagship", CTRLER_FLAGSHIP),
                        ("ctrler_metrics_flagship", CTRLER_METRICS_FLAGSHIP)):
        metrics_on = "--metrics" in argv
        set_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        wall = time.perf_counter() - t0
        ran = read_counts()
        want = -(-ticks // engine.KERNEL_CHUNK) * FLAGSHIP_RUNS
        check(rc == 0 and out["violating"] == 0
              and out.get("deterministic") is True
              and out["acked_ops_mean"] > 0
              and out["configs_created_mean"] > 0
              and out["queries_done_mean"] > 0
              and out["walker_stalled_mean"] == 0,
              f"{label} rc {rc}: {out}")
        check(ran["ctrler_chunk"] == want
              and ran["ctrler_chunk_metrics"] == want * metrics_on
              and all(ran[k] == 0 for k in eager_off),
              f"{label} launches {ran}: want K6-ctrler once a "
              f"{engine.KERNEL_CHUNK}-tick chunk ({want}), no K6, K10, draw "
              "chunk, K2, K4, K5 or K9 launch")
        eager = {}
        if not metrics_on:
            # the eager route on the card at the flagship's depth: the same
            # report
            ctrler._advance_ctrler = functools.partial(advance, tick="eager")
            try:
                rc_e, out_e = run_cli([x for x in argv
                                       if x != "--check-deterministic"])
            finally:
                ctrler._advance_ctrler = advance
            check(rc_e == 0 and _report_fields(out_e) == _report_fields(out),
                  f"{label}: the eager route's report differs from "
                  "K6-ctrler's")
            eager = {"eager_route_report_equal": True,
                     "eager_route_wall_ms_per_tick": out_e["telemetry"][
                         "execute_s"] / ticks * 1e3}
        tele = out["telemetry"]
        row = {"phase": label, "argv": argv, "rc": rc,
               "cluster_steps_per_s": tele["steps_per_sec"],
               "execute_s": tele["execute_s"],
               "wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
               "wall_s_both_runs": round(wall, 3),
               "compile_s": tele["compile_s"],
               "bytes_per_lane": tele["bytes_per_lane"],
               "tick_instance": K6.instance(_ctrler_cli_cfg()[0],
                                            ctrler=True),
               "acked_ops_mean": out["acked_ops_mean"],
               "configs_created_mean": out["configs_created_mean"],
               "queries_done_mean": out["queries_done_mean"], **eager,
               "launches": {k: v for k, v in ran.items() if v}}
        if metrics_on:
            lat = out["latency"]
            check(all(k in out for k in METRIC_KEYS) and "phases" in lat,
                  f"ctrler metrics report lacks a block: {sorted(out)}")
            # the latency mass is the acked ops, on every phase row too
            ops = lat["ops"]
            check(round(ops / b, 2) == out["acked_ops_mean"]
                  and all(d["ops"] == ops for d in lat["phases"].values())
                  and out["worst_op"]["key"] == -1,
                  f"ctrler latency mass {ops} vs acked "
                  f"{out['acked_ops_mean']}, worst op {out['worst_op']}")
            row.update(p50_ticks=lat["p50_ticks"], p99_ticks=lat["p99_ticks"],
                       ops=ops)
        emit(row)
        runs[label] = ran

    # the CPU route at the flagship's batch, CTRLER_CPU_TICKS ticks, beside
    # the card's K6-ctrler
    cpu = {}
    for metrics_on in (False, True):
        argv = CTRLER_FLAGSHIP[:2] + ["--clusters", str(b), "--ticks",
                                      str(CTRLER_CPU_TICKS), "--seed",
                                      "12345"] + ["--metrics"] * metrics_on
        set_counts()
        rc_k, out_k = run_cli(argv)
        ran = read_counts()
        t0 = time.perf_counter()
        rc_c, out_c = run_cli(argv + ["--platform", "cpu"])
        cpu_s = time.perf_counter() - t0
        check(rc_k == rc_c == 0 and ran["ctrler_chunk"] == 1
              and _report_fields(out_k) == _report_fields(out_c),
              f"ctrler at {b} x {CTRLER_CPU_TICKS} (metrics {metrics_on}): "
              f"the CPU route's report differs from K6-ctrler's ({ran})")
        cpu["metrics" if metrics_on else "plain"] = {
            "report_equal": True, "cpu_route_s": round(cpu_s, 3),
            "acked_ops_mean": out_c["acked_ops_mean"]}
    emit({"phase": "ctrler_cpu_route", "clusters": b,
          "ticks": CTRLER_CPU_TICKS, **cpu})

    # the sweep's [B] knob rows (the three bugs mixed) on K6-ctrler beside
    # the eager route, and a cluster's replay beside its row of the batch
    cfg, kcfg = _ctrler_cli_cfg()
    rows = ctrler_knob_rows(kcfg, b)
    sweep = {}
    for route in ("kernel", "eager"):
        set_counts()
        ctrler._advance_ctrler = functools.partial(advance, tick=route)
        try:
            fn = ctrler.make_ctrler_sweep_fn(cfg, cfg.knobs(), rows, kcfg, b,
                                             CTRLER_SWEEP_TICKS, dev)
            sweep[route] = (ctrler.ctrler_report(fn(12345)), read_counts())
        finally:
            ctrler._advance_ctrler = advance
    from madraft_tpu_torch.__main__ import _reports_equal

    ran = sweep["kernel"][1]
    check(ran["ctrler_chunk"] == 1
          and all(ran[k] == 0 for k in eager_off)
          and _reports_equal(sweep["kernel"][0], sweep["eager"][0])
          and sweep["kernel"][0].n_violating > 0,
          f"ctrler sweep rows: launches {ran}, the eager route's report "
          "differs, or no planted bug fired")
    replay_ticks, cid = 300, 7
    set_counts()
    batch = ctrler.make_ctrler_fuzz_fn(cfg, kcfg, b, replay_ticks, dev)(12345)
    one = ctrler.ctrler_replay_cluster(cfg, kcfg, 12345, cid, replay_ticks,
                                       device=dev)
    ran = read_counts()
    want = 2 * -(-replay_ticks // engine.KERNEL_CHUNK)
    err = max(max_abs_err(x[cid:cid + 1], y)
              for x, y in zip(_kv_leaves(batch), _kv_leaves(one)))
    check(ran["ctrler_chunk"] == want and all(ran[k] == 0 for k in eager_off)
          and err == 0,
          f"ctrler replay of cluster {cid}: launches {ran} (want {want} "
          f"K6-ctrler), err {err} against the batch's row")
    emit({"phase": "ctrler_sweep_replay", "clusters": b,
          "sweep_ticks": CTRLER_SWEEP_TICKS,
          "sweep_violating": sweep["kernel"][0].n_violating,
          "sweep_eager_report_equal": True,
          "sweep_launches": {k: v for k, v in sweep["kernel"][1].items()
                             if v},
          "replay_cluster": cid, "replay_ticks": replay_ticks,
          "replay_launches": {k: v for k, v in ran.items() if v},
          "replay_max_abs_err": err})

    # the A/B: the flagship's shape at CTRLER_AB_TICKS ticks, eager (the
    # eager tick, the plain service tick) and kernel (K6-ctrler) in turns
    ab, reps = [], []
    for route in ("eager", "kernel", "kernel", "eager"):
        set_counts()
        ctrler._advance_ctrler = functools.partial(advance, tick=route)
        try:
            fn = ctrler.make_ctrler_fuzz_fn(cfg, kcfg, b, CTRLER_AB_TICKS, dev)
            rep, tele = engine.run_telemetry(fn, ctrler.ctrler_report, 12345,
                                             b * CTRLER_AB_TICKS, n_lanes=b)
        finally:
            ctrler._advance_ctrler = advance
        ran = read_counts()
        kernel = route == "kernel"
        check(ran["ctrler_chunk"] == int(kernel)
              and ran["tick_chunk"] == ran["ctrler_tick"] == 0
              and (ran["oracle"] == CTRLER_AB_TICKS * (not kernel)),
              f"ctrler A/B {route} launches {ran}")
        reps.append(rep)
        ab.append({"route": route, "ticks": CTRLER_AB_TICKS,
                   "cluster_steps_per_s": tele["steps_per_sec"],
                   "wall_ms_per_tick": tele["execute_s"] / CTRLER_AB_TICKS
                   * 1e3,
                   "launches": {k: v for k, v in ran.items() if v}})
    check(all(_reports_equal(reps[0], r) for r in reps[1:]),
          "ctrler A/B: the eager and the kernel route's reports differ")
    rate = {r: sum(x["cluster_steps_per_s"] for x in ab
                   if x["route"] == r) / 2 for r in ("eager", "kernel")}
    emit({"phase": "ctrler_ab", "card": _smi(), "clusters": b, "runs": ab,
          "reports_equal": True,
          "kernel_over_eager": rate["kernel"] / rate["eager"]})
    return runs["ctrler_flagship"], runs["ctrler_metrics_flagship"]


def _ctrler_state(dev, metrics_on: bool, ticks: int = 200):
    """The ctrler flagship's batch after ``ticks`` ticks on K6 and K10,
    and its configs, keys and knobs."""
    from madraft_tpu_torch.tpusim import ctrler, engine

    cfg, kcfg = _ctrler_cli_cfg(metrics_on)
    b = _flag(CTRLER_FLAGSHIP, "--clusters")
    keys = engine.cluster_keys(12345, b, dev)
    kn, ckn = cfg.knobs(dev), kcfg.knobs(dev)
    ks = ctrler._advance_ctrler(
        cfg, kcfg, ctrler.init_ctrler_cluster(cfg, kcfg, keys, kn), keys, kn,
        ckn, ticks)
    return cfg, kcfg, ks, keys, kn, ckn


def _ctrler_bytes(cfg, kcfg, ks, s, keys, table, written) -> dict:
    """The bytes one ctrler service tick must move (``_ctrler_timing``),
    counted as ``_kv_bytes`` counts K9's: every service leaf and every
    raft leaf it writes read once and written once, the stepped raft
    leaves it reads, the pre-tick views, keys and knob rows read once,
    except the two [n, cap] log rows, of which the tick reads only the
    log_val slots its apply rounds reach (this run's count) and writes
    only the appended entries (a term and a value each)."""
    import torch

    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.tpusim import ctrler

    pre = ks.raft
    logs = ("log_term", "log_val")
    state = ([getattr(ks, f) for f in ctrler.SERVICE]
             + [getattr(s, f) for f in K10.RAFT_WRITES if f not in logs])
    reads = ([getattr(s, f) for f in K10.RAFT_READS]
             + [pre.alive, pre.base, keys, *table])
    reset = (~pre.alive | ~s.alive | (s.snap_installed_src >= 0))
    start = torch.where(reset, s.base, ks.applied)
    rounds = int((written.applied - start).sum())
    appends = int((written.raft.log_len - s.log_len).sum())
    out = {"state_read_and_written": 2 * nbytes(*state),
           "reads": nbytes(*reads), "log_val_slots_read": rounds,
           "log_entries_appended": appends}
    out["total"] = (out["state_read_and_written"] + out["reads"]
                    + 4 * rounds + 8 * appends)
    return out


def _ctrler_ops(cfg, kcfg, ks, written, rounds: int) -> int:
    """The 32-bit operations one ctrler service tick does on this run's
    data (``_ctrler_timing``): the threefry hashes (the eight draw keys a
    cluster, two fold-ins and a split each; a clerk's start word; a
    started op's kind word, its arg draw (4 hashes a randint) and its
    Query num or gid set; an outstanding clerk's retry word and target),
    the clerks' shadow search (2 a (clerk, slot) pair), the node tables'
    restore (4 a cell), and the apply rounds and walker steps (a
    rebalance and its oracles each: 12 operations a (shard, gid) pair, 40
    for the rest)."""
    return _ctrler_ops_of(cfg, kcfg, ks.clerk_seq.shape[0], 1,
                          *(int(x) for x in _ctrler_counts(ks, written)),
                          rounds)


def _ctrler_counts(ks, written) -> tuple:
    """The data-dependent counts of one ctrler service tick from ``ks`` to
    ``written``, as device tensors: (clerks that started an op, clerks
    outstanding after it, walker steps)."""
    return ((written.clerk_seq != ks.clerk_seq).sum(),
            written.clerk_out.sum(),
            (written.w_frontier - ks.w_frontier).sum())


def _ctrler_ops_of(cfg, kcfg, b: int, ticks: int, started: int,
                   outstanding: int, steps: int, rounds: int) -> int:
    """``_ctrler_ops`` over ``ticks`` ticks of b clusters from the ticks'
    summed counts (``_ctrler_counts``) and apply rounds."""
    n, cap, nc = cfg.n_nodes, cfg.log_cap, kcfg.n_clients
    ng, jm = kcfg.n_gids, kcfg.join_max
    hashes = (b * ticks * (8 * 3 + nc) + started * (1 + 4 + 4 + 4 * jm)
              + outstanding * (1 + 4))
    cells = n * (2 * nc + 2 * ng + 2 * 10 + 2 + 2 * kcfg.n_configs)
    return (hashes * OPS_PER_HASH + b * ticks * (2 * nc * cap + 4 * cells)
            + (rounds + steps) * (12 * 10 * ng + 40))


def _ctrler_timing(dev) -> tuple:
    """K10's and K10-metrics' times at the ctrler flagship's shape (tick
    200 to 201): (name -> (device ms, call ms, plain ms, bytes,
    operations), the timing phase's tuple; name -> ``_ctrler_bytes``'
    count). Each launch reads its inputs from device memory (copies in
    rotation)."""
    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import ctrler

    counts = read_counts()
    out, counted = {}, {}
    for name, metrics_on in (("ctrler_tick", False),
                             ("ctrler_tick_metrics", True)):
        cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, metrics_on)
        b = keys.shape[0]
        pre = ks.raft
        s = K6.tick_chunk(cfg, pre, keys, kn, 1)
        table = K10.knob_table(kn, ckn, b)
        inputs = (_kv_leaves(ks)[len(pre):] + [
            getattr(s, f) for f in K10.RAFT_READS + K10.RAFT_WRITES] + [
            pre.alive, pre.base, keys, *table])
        written = K10.ctrler_tick(cfg, kcfg, ks, pre.alive, pre.base, s,
                                  keys, kn, ckn, table)
        counted[name] = _ctrler_bytes(cfg, kcfg, ks, s, keys, table, written)
        ops = _ctrler_ops(cfg, kcfg, ks, written,
                          counted[name]["log_val_slots_read"])
        counted[name]["operations"] = ops
        n_in = nbytes(*inputs)
        rot = [(ks, s)] + [
            (ctrler.CtrlerState(*(type(x)(*(y.clone() for y in x))
                                  if isinstance(x, tuple) else x.clone()
                                  for x in ks)),
             type(s)(*(x.clone() for x in s)))
            for _ in range(rotations(n_in) - 1)]

        def call(i, plain=False):
            k, st = rot[i % len(rot)]
            return K10.ctrler_tick(cfg, kcfg, k, pre.alive, pre.base, st,
                                   keys, kn, ckn, table, plain=plain)

        out[name] = (device_ms(call, "ctrler_kernel"), cuda_ms(call),
                     cuda_ms(lambda i: call(i, True), iters=20),
                     counted[name]["total"], ops)
        del rot
    set_counts(counts)
    return out, counted


def _k6ctrler_timing(dev, plain: bool = True) -> dict:
    """K6-ctrler's and K6-metrics-ctrler's times at the ctrler flagship's
    shape, one KERNEL_CHUNK-tick launch from tick 200: name -> (device ms,
    call ms, plain ms (None without ``plain``), bytes, operations). The
    bytes: K6's state (the metric leaves with metrics) and the ctrler
    state's service leaves read and written once, the keys and both knob
    tables read once, and the log_val slots the apply rounds read (this
    run's count, from the plain version's ticks, though those reads hit the
    block K6-ctrler staged). The operations: per cluster-tick K6's draws (2
    + total hashes and a word each), and per tick the service tick's on
    this run's data as ``_ctrler_ops`` counts K10's (the plain version's
    ticks, so counted only with ``plain``; else the bound is the bytes')."""
    import torch

    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import ctrler, engine, step
    from madraft_tpu_torch.tpusim.state import METRIC_LEAF0

    counts = read_counts()
    out = {}
    m = engine.KERNEL_CHUNK
    for name, metrics_on in (("ctrler_chunk", False),
                             ("ctrler_chunk_metrics", True)):
        cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, metrics_on)
        b, n = int(keys.shape[0]), cfg.n_nodes
        table, ctable = K6.knob_table(kn, b), K10.knob_table(kn, ckn, b)

        def call(i):
            return K10.ctrler_chunk(cfg, kcfg, ks, keys, kn, ckn, m, table,
                                    ctable)

        # the plain version, its apply rounds and the service's counts
        # summed on the device tick by tick (no sync inside the timing)
        count = torch.zeros(4, dtype=torch.int64, device=dev)

        def run_plain(i):
            k = ks
            for _ in range(m):
                pre = k.raft
                s = step.step_cluster(cfg, pre, keys, kn)
                k2 = ctrler._ctrler_service_tick(cfg, kcfg, k, pre.alive,
                                                 pre.base, s, keys, kn, ckn)
                reset = ~pre.alive | ~s.alive | (s.snap_installed_src >= 0)
                rounds = (k2.applied - torch.where(
                    reset, s.base, k.applied)).sum()
                count.add_(torch.stack([*_ctrler_counts(k, k2), rounds]))
                k = k2
            return k

        raft = ks.raft[:METRIC_LEAF0] if not metrics_on else ks.raft
        total = step._block_total(n)
        plain_ms = cuda_ms(run_plain, iters=1, warmup=0) if plain else None
        started, outstanding, steps, rounds = count.tolist()
        ops = (b * m * ((2 + total) * OPS_PER_HASH + total)
               + _ctrler_ops_of(cfg, kcfg, b, m, started, outstanding, steps,
                                rounds))
        nb = (2 * nbytes(*raft, *ks[1:]) + nbytes(keys, *table, *ctable)
              + 4 * rounds)
        out[name] = (device_ms(call, "tick_chunk_kernel", iters=10, warmup=1),
                     cuda_ms(call, iters=5, warmup=1), plain_ms, nb, ops)
    set_counts(counts)
    return out


def _profile_ctrler_tick(dev, metrics_on: bool, n_ticks: int = 512) -> dict:
    """Where a ctrler flagship tick's wall goes (torch.profiler, the window
    retry of ``_profiled``): the device operations a tick, the card's busy
    share of the wall and the host's, K6-ctrler's share and device ms a
    tick, over n_ticks ticks from tick 200 (the flagship's depth: two
    K6-ctrler launches)."""
    from madraft_tpu_torch.tpusim import ctrler, engine

    cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, metrics_on)
    counts = read_counts()
    # every K6-ctrler launch of the window, or the shares would be of a part
    _, kernels, wall_ms, _, attempts = _profiled(
        lambda: ctrler._advance_ctrler(cfg, kcfg, ks, keys, kn, ckn,
                                       n_ticks),
        expect={"tick_chunk_kernel": -(-n_ticks // engine.KERNEL_CHUNK)})
    set_counts(counts)

    def dev_ms(name):
        return sum(_dev_us(e) for e in kernels if name in e.key) / 1e3

    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    return {"phase": "profile_ctrler_tick" + "_metrics" * metrics_on,
            "card": _smi(), "ticks": n_ticks,
            "clusters": int(keys.shape[0]),
            "profiler_attempts": attempts,
            "wall_ms_per_tick": wall_ms / n_ticks,
            "device_busy_ms_per_tick": busy_ms / n_ticks,
            "device_busy_share": busy_ms / wall_ms,
            "host_share": 1 - busy_ms / wall_ms,
            "k6ctrler_ms_per_tick": dev_ms("tick_chunk_kernel") / n_ticks,
            "k6ctrler_share": dev_ms("tick_chunk_kernel") / wall_ms,
            "k10_ms_per_tick": dev_ms("ctrler_kernel") / n_ticks,
            "device_ops_per_tick": sum(e.count for e in kernels) / n_ticks,
            "top_device_ms_per_tick": {
                e.key[:60]: _dev_us(e) / 1e3 / n_ticks for e in sorted(
                    kernels, key=_dev_us, reverse=True)[:5]}}


def _phase_cycles(lib, entry: str, b: int, phases) -> dict:
    """The profile build's clock64() cycles of the last launch (csrc
    ``<entry>``: each phase's end from the block's start, then the truth
    walker's own cycles in the apply phase): median and max a phase over
    the b clusters or deployments, the walker's, and the total's."""
    import ctypes

    import numpy as np

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    ends = np.zeros((b, len(phases) + 1), dtype=np.int64)
    check(fn(ends.ctypes.data, b) == 0, entry)
    per = np.diff(ends[:, :-1], axis=1, prepend=0)
    return {"median_cycles": dict(zip(phases, np.median(per, 0).tolist())),
            "max_cycles": dict(zip(phases, per.max(0).tolist())),
            "walker_median_cycles": float(np.median(ends[:, -1])),
            "walker_max_cycles": int(ends[:, -1].max()),
            "median_total_cycles": float(np.median(ends[:, -2])),
            "max_total_cycles": int(ends[:, -2].max())}


def _resident(grid: dict, units: int, per_block: int) -> dict:
    """The warps an SM holds at a launch of ``units`` clusters or
    deployments: the occupancy limit and what the batch puts there."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-units // per_block)
    warps = grid["threads_a_block"] // 32
    return {**grid, "blocks": blocks,
            "resident_warps_an_sm": min(grid["blocks_an_sm"],
                                        -(-blocks // sms)) * warps,
            "waves": -(-blocks // (grid["blocks_an_sm"] * sms))}


def _ctrler_phases(dev) -> dict:
    """Where a K10 launch's time goes at the ctrler flagship's shape (tick
    200 to 201): the profile build's clock64() cycles a phase from each
    block's start (kernels/ctrler.py PHASES) and the truth walker's own,
    median and max over the clusters, the profile build's state held
    against K10's; then each build's ptxas report (registers, stack,
    spills) and its layout at that batch (threads a block, the blocks
    and warps an SM holds)."""
    import torch

    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import ctrler as K10
    from madraft_tpu_torch.kernels import tick as K6

    counts = read_counts()
    out = {"phase": "ctrler_phases", "card": _smi(), "builds": {}}
    for build, metrics_on in (("ctrler", False), ("ctrler_metrics", True)):
        cfg, kcfg, ks, keys, kn, ckn = _ctrler_state(dev, metrics_on)
        b, pre = int(keys.shape[0]), ks.raft
        s = K6.tick_chunk(cfg, pre, keys, kn, 1)
        table = K10.knob_table(kn, ckn, b)
        grid = K10.grid(cfg, kcfg, ks, pre.alive, pre.base, s, keys, table,
                        K10._lib(build))
        out["builds"][build] = {
            "ptxas": _build.ptxas(build),
            "grid": _resident(grid, b, grid["clusters_a_block"])}
        if metrics_on:
            continue
        lib = K10._lib("ctrler_profile")
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(3):  # the last launch's cycles, past the first's misses
            got = K10._launch(cfg, kcfg, ks, pre.alive, pre.base, s, keys,
                              table, lib, stream)
        torch.cuda.synchronize()
        want = K10.ctrler_tick(cfg, kcfg, ks, pre.alive, pre.base, s, keys,
                               kn, ckn, table)
        check(_kv_err(got, want) == 0, "K10's profile build differs from K10")
        out.update(clusters=b, **_phase_cycles(lib, "ctrler_phase_cycles", b,
                                                K10.PHASES))
    out["builds"]["ctrler_profile"] = {"ptxas": _build.ptxas("ctrler_profile")}
    set_counts(counts)
    return out


# ------------------------------------------------------- the shardkv path
def shardkv_row_cases(kcfg) -> tuple:
    """The row cases of ``shardkv_knob_rows`` for kcfg's mode: the
    schedule mode's SHARDKV_ROW_CASES, and in a controller mode the
    mode's planted bug as an eighth case ("ctrl_bug":
    ``bug_stale_ctrler_read`` live, ``bug_rotate_tiebreak`` computed)."""
    if kcfg.live_ctrler or kcfg.computed_ctrler:
        return SHARDKV_ROW_CASES + ("ctrl_bug",)
    return SHARDKV_ROW_CASES


def shardkv_knob_rows(kcfg, b: int):
    """[B] shardkv knob rows (on the CPU) that put deployment d in case
    ``shardkv_row_cases(kcfg)[d % 7]`` (d % 8 in a controller mode):
    clean, each planted bug, Puts, open-loop arrivals with the Zipf shard
    draw, the WrongGroup re-query, the controller mode's bug. For holding
    K11 against its plain version (phases ``shardkv_k11`` and
    ``shardkv_ctrl_k11``) and the port against the reference
    (``tests/test_torch_shardkv*.py``)."""
    import torch

    kk = kcfg.knobs().broadcast(b)
    c = torch.arange(b) % len(shardkv_row_cases(kcfg))
    rows = kk._replace(
        bug_skip_freeze=c == 1, bug_drop_dup_table=c == 2,
        bug_serve_frozen=c == 3,
        p_put=torch.where((c == 4) | (c == 5), 0.3, 0.0).float(),
        open_rate=torch.where(c == 5, 0.3, 0.0).float(),
        open_queue_cap=torch.where(c == 5, 4, 0).int(),
        zipf_a=torch.where(c == 5, 1.6, 1.0).float(),
        requery_wrong_group=c == 6)
    if kcfg.live_ctrler:
        rows = rows._replace(bug_stale_ctrler_read=c == 7)
    elif kcfg.computed_ctrler:
        rows = rows._replace(bug_rotate_tiebreak=c == 7)
    return rows


def _shardkv_cli_cfg(metrics: bool = False, mode: str = "schedule"):
    """shardkv-fuzz --storm's configs: the raft config the verb builds
    (n = 5, cap 64, compact_every 16, loss 0.1, crash 0.01, one dead at
    most) and ShardKvConfig(p_get=0.3, p_put=0.2) (the CLI's defaults),
    in ``mode`` ("schedule", "live": --live-ctrler, "computed":
    --computed-ctrler)."""
    from madraft_tpu_torch.tpusim import shardkv
    from madraft_tpu_torch.tpusim.config import SimConfig

    cfg = SimConfig(n_nodes=5, p_client_cmd=0.0, compact_at_commit=False,
                    log_cap=64, compact_every=16, loss_prob=0.1, p_crash=0.01,
                    p_restart=0.2, max_dead=1, metrics=metrics)
    return cfg, shardkv.ShardKvConfig(p_get=0.3, p_put=0.2,
                                      live_ctrler=mode == "live",
                                      computed_ctrler=mode == "computed")


def _shardkv_err(a, b) -> float:
    import torch

    from madraft_tpu_torch.tpusim import shardkv

    x, y = shardkv.shardkv_state_to_numpy(a), shardkv.shardkv_state_to_numpy(b)
    return max(max_abs_err(torch.from_numpy(x[f]), torch.from_numpy(y[f]))
               for f in shardkv.SHARDKV_FIELDS)


def _shardkv_k11(dev, errs: dict) -> dict:
    """Phase shardkv_k11: K11 and K11-metrics against the plain service
    tick on the card, every leaf after every one of SHARDKV_K11_TICKS
    ticks (the raft tick by K6 over the groups): the flagship's batch
    from tick SHARDKV_K11_WARM with the cases of SHARDKV_ROW_CASES as
    [B] knob rows, metrics off (partitionable) and on (legacy), then the
    edge batch SHARDKV_K11_EDGE; and config.zipf_map on the card against
    the CPU over every shard draw. Reports, for each case, the migrations
    (installs) and GCs (deletes) the compared ticks walked. Launches here
    are not main-path launches."""
    import torch

    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import config, engine, prng, shardkv

    counts = read_counts()
    b_flag = _flag(SHARDKV_FLAGSHIP, "--clusters")
    eb, en, ekw, ewarm = SHARDKV_K11_EDGE
    runs = (("flagship_rows", b_flag, 5, "rows", False, True,
             SHARDKV_K11_WARM),
            ("flagship_rows_metrics_legacy", b_flag, 5, "rows", True, False,
             SHARDKV_K11_WARM),
            ("edge_g5_n7_clients32", eb, en, ekw, True, True, ewarm))
    done = []
    for name, b, n, kw, metrics_on, flag, warm in runs:
        cfg, kcfg = _shardkv_cli_cfg(metrics_on)
        cfg = cfg.replace(n_nodes=n)
        if kw != "rows":
            kcfg = kcfg.replace(**kw)
        g = kcfg.n_groups
        with prng.layout(flag):
            keys = engine.cluster_keys(12345, b, dev)
            kn = cfg.knobs(dev)
            skn = (shardkv_knob_rows(kcfg, b).to(dev) if kw == "rows"
                   else kcfg.knobs(dev))
            st = shardkv._advance_shardkv(
                cfg, kcfg, shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn,
                                                        skn),
                keys, kn, skn, warm)
            start = st
            gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
            gkn = shardkv._group_knobs(kn, g)
            table = K11.knob_table(kn, skn, b)
            err = 0.0
            for _ in range(SHARDKV_K11_TICKS):
                pre = st.rafts
                s = shardkv._unflat(K6.tick_chunk(cfg, shardkv._flat(pre),
                                                  gkeys, gkn, 1), b)
                want = shardkv._shardkv_service_tick(
                    cfg, kcfg, st, pre.alive, pre.base, s, keys, kn, skn)
                got = K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base, s,
                                       keys, kn, skn, table)
                err = max(err, _shardkv_err(got, want))
                st = want
        key = "shardkv_tick_metrics" if metrics_on else "shardkv_tick"
        errs[key] = max(errs[key], err)
        check(err == 0, f"K11 differs from its plain version: {name}")
        case = (torch.arange(b, device=dev) % len(SHARDKV_ROW_CASES)
                if kw == "rows" else torch.zeros(b, dtype=torch.int64,
                                                 device=dev))
        names = SHARDKV_ROW_CASES if kw == "rows" else ("edge",)
        per_case = {}
        for i, cname in enumerate(names):
            m = case == i
            per_case[cname] = {
                "deployments": int(m.sum()),
                "violating": int(((st.violations != 0) & m).sum()),
                "installs_in_compared_ticks": int(
                    ((st.installs_done - start.installs_done) * m).sum()),
                "deletes_in_compared_ticks": int(
                    ((st.deletes_done - start.deletes_done) * m).sum()),
                "acks_in_compared_ticks": int(
                    ((st.clerk_acked - start.clerk_acked).sum(-1) * m).sum())}
        walked = {k: sum(d[f"{k}_in_compared_ticks"]
                         for d in per_case.values())
                  for k in ("installs", "deletes", "acks")}
        # the flagship's rows migrate and GC in their compared ticks; the
        # small edge batch need only ack
        check(walked["acks"] > 0 and (kw != "rows" or (
            walked["installs"] > 0 and walked["deletes"] > 0)),
              f"shardkv_k11 {name}: the compared ticks walked {per_case}")
        done.append({"run": name, "deployments": b, "n_nodes": n,
                     "groups": g, "metrics": metrics_on,
                     "partitionable": flag, "from_tick": warm,
                     "cases": per_case})
    # config.zipf_map on the card against the CPU, every shard draw
    zipf = []
    d = torch.arange(10, dtype=torch.int32)
    for a in (1.0, 1.5, 1.6, 2.0, 3.0):
        at = torch.tensor(a, dtype=torch.float32)
        got = config.zipf_map(d.to(dev), 10, at.to(dev)).cpu()
        zipf.append([10, a, int((got != config.zipf_map(d, 10, at)).sum())])
    check(all(x[2] == 0 for x in zipf), f"zipf_map card vs CPU: {zipf}")
    set_counts(counts)
    return {"phase": "shardkv_k11", "ticks": SHARDKV_K11_TICKS, "runs": done,
            "zipf_grid_cells_differing": zipf,
            "max_abs_err": max(errs["shardkv_tick"],
                               errs["shardkv_tick_metrics"])}


def _shardkv_k6shardkv(dev, errs: dict, mode: str) -> dict:
    """Phase shardkv_k6shardkv (once a mode): K6-shardkv and
    K6-metrics-shardkv against ``shardkv_chunk_plain`` on the card, every
    leaf after every launch of SHARDKV_K6S_LAUNCHES ticks (the last a
    short one): the mode's flagship batch from tick SHARDKV_K11_WARM with
    the mode's row cases as [B] knob rows (shardkv_row_cases), metrics off
    under the partitionable layout and on under the legacy one, then the
    mode's edge batch (SHARDKV_K11_EDGE: five groups of seven, 32 clerks;
    in a controller mode SHARDKV_CTRL_EDGE with the planted walker stall);
    then ptxas's report of both builds, their layout at the flagship's
    batch, and the ms of a 256-tick launch there (CUDA events). Launches
    here are not main-path launches."""
    import torch

    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.tpusim import engine, prng, shardkv

    counts = read_counts()
    ctrl = mode != "schedule"
    b_flag = _flag(SHARDKV_FLAGSHIP, "--clusters")
    edge = SHARDKV_CTRL_EDGE if ctrl else SHARDKV_K11_EDGE
    runs = (("flagship_rows", b_flag, False, True, "rows"),
            ("flagship_rows_metrics_legacy", b_flag, True, False, "rows"),
            ("edge", edge[0], True, True, "edge"))
    done = []
    for name, b, metrics_on, flag, kind in runs:
        cfg, kcfg = _shardkv_cli_cfg(metrics_on, mode)
        warm, rows = SHARDKV_K11_WARM, kind == "rows" or ctrl
        if kind == "edge" and ctrl:
            _, en, eraft, ekw, warm = SHARDKV_CTRL_EDGE
            cfg, kcfg = cfg.replace(n_nodes=en, **eraft), kcfg.replace(**ekw)
        elif kind == "edge":
            _, en, ekw, warm = SHARDKV_K11_EDGE
            cfg, kcfg = cfg.replace(n_nodes=en), kcfg.replace(**ekw)
        with prng.layout(flag):
            keys = engine.cluster_keys(12345, b, dev)
            kn = cfg.knobs(dev)
            skn = (shardkv_knob_rows(kcfg, b).to(dev) if rows
                   else kcfg.knobs(dev))
            st = shardkv._advance_shardkv(
                cfg, kcfg, shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn,
                                                        skn),
                keys, kn, skn, warm)
            if kind == "edge" and ctrl:
                # every other controller's shadow slid past the walker's
                # next entry
                c, odd = st.ctrl, torch.arange(b, device=dev) % 2 == 0
                base = torch.where(odd, torch.maximum(
                    c.shadow_base, st.ctrl_w_frontier + 1), c.shadow_base)
                st = st._replace(ctrl=c._replace(
                    shadow_base=base,
                    shadow_len=torch.where(odd, torch.maximum(
                        c.shadow_len, base + 5), c.shadow_len)))
            start, err = st, 0.0
            for m in SHARDKV_K6S_LAUNCHES:
                got = K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, m)
                want = K11.shardkv_chunk_plain(cfg, kcfg, st, keys, kn, skn,
                                               m)
                err = max(err, _shardkv_err(got, want))
                st = want
        key = _k6s_name(metrics_on, mode)
        errs[key] = max(errs[key], err)
        check(err == 0, f"K6-shardkv differs from the plain route: {mode} "
              f"{name}")
        names = shardkv_row_cases(kcfg) if rows else ("edge",)
        case = torch.arange(b, device=dev) % len(names)
        per_case = _ctrl_case_report(st, start, case, names)
        walked = {k: sum(d[f"{k}_in_compared_ticks"]
                         for d in per_case.values())
                  for k in ("installs", "acks")}
        # the flagship's rows migrate in their compared ticks; an edge
        # batch need only ack
        check(walked["acks"] > 0 and (kind != "rows"
                                      or walked["installs"] > 0),
              f"shardkv_k6shardkv {mode} {name}: the compared ticks walked "
              f"{per_case}")
        if kind == "edge" and ctrl:
            check(bool(st.ctrl_w_stalled[::2].all()),
                  f"{mode} {name}: the planted walker stall did not stick")
        done.append({"run": name, "deployments": b, "n_nodes": cfg.n_nodes,
                     "groups": kcfg.n_groups, "log_cap": cfg.log_cap,
                     "metrics": metrics_on, "partitionable": flag,
                     "from_tick": warm,
                     "instance": K11.chunk_instance(cfg), "cases": per_case})
    prng.set_partitionable(True)
    builds = {}
    for metrics_on in (False, True):
        build = K11.chunk_variant(metrics_on)
        cfg, kcfg, st, keys, kn, skn = _shardkv_state(dev, metrics_on,
                                                      mode=mode)
        tables = K11.chunk_tables(cfg, kcfg, kn, skn, int(keys.shape[0]))
        m = engine.KERNEL_CHUNK
        grid = K11.chunk_grid(cfg, kcfg, st, keys, m, tables,
                              K11.chunk_lib(build))
        builds[build] = {
            "ptxas": _build.ptxas(build),
            "grid": _resident(grid, int(keys.shape[0]), 1),
            # CUDA events, not a profiler window (the kernels line has the
            # profiler's ms)
            "call_ms_256_ticks": cuda_ms(
                lambda i: K11.shardkv_chunk(cfg, kcfg, st, keys, kn, skn, m,
                                            tables), iters=3, warmup=1)}
    set_counts(counts)
    return {"phase": "shardkv_k6shardkv", "mode": mode, "card": _smi(),
            "launches": list(SHARDKV_K6S_LAUNCHES), "runs": done,
            "builds": builds,
            "spills": {k: r["ptxas"]["spills"] for k, r in builds.items()
                       if r["ptxas"]["spills"]},
            "max_abs_err": max(errs[_k6s_name(x, mode)]
                               for x in (False, True))}


def shardkv_section(t0: float = 0.0) -> int:
    """The smoke's shardkv section (``--shardkv-section``): K11's phases
    ``shardkv_k11`` and ``shardkv_ctrl_k11``, then in each mode
    ``shardkv_k6shardkv`` and ``_shardkv_path``, in a child (``_child``),
    its profiler windows first; prints the phase lines (stamped ``t0``
    seconds into the script), then one line
    ``{"shardkv_section": {"launches": mode -> [the flagship's, the metrics
    flagship's], "errs": name -> max_abs_err}}``."""
    import torch

    global T0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch.tpusim import prng

    T0 = time.perf_counter() - t0
    prng.set_partitionable(True)
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in counters()}
    # the profiler's windows first: K6-shardkv's device ms a launch, then
    # where a flagship tick's wall goes in each mode
    timing = _k6shardkv_timing(dev, between=lambda: [
        emit(_profile_shardkv_tick(dev, False, mode=mode))
        for mode in ("schedule", *SHARDKV_CTRL_FLAG)])
    emit({"phase": "k6shardkv_timing", "card": _smi(),
          "ticks": SHARDKV_K6S_TIMED_TICKS,
          **{k: dict(zip(("ms", "call_ms", "plain_ms", "bytes",
                          "operations"), v)) for k, v in timing.items()}})
    emit(_shardkv_k11(dev, errs))
    emit(_shardkv_ctrl_k11(dev, errs))
    launches = {}
    for mode in ("schedule", *SHARDKV_CTRL_FLAG):
        emit(_shardkv_k6shardkv(dev, errs, mode))
        launches[mode] = _shardkv_path(dev, mode)
    print(json.dumps({"shardkv_section": {"launches": launches,
                                          "errs": errs, "timing": timing}}),
          flush=True)
    return 0


def _child(flag: str, key: str) -> dict:
    """Runs ``python3 chip_smoke.py <flag> <seconds so far>`` in a child
    process of its own, relays its phase lines, and returns the dict its
    last line carries under ``key``. Late in this script's process
    torch.profiler recorded no kernel at all in five windows of
    ``profile_kv_tick`` (whole smokes on the card, 750-875 s in), where a
    fresh process records them: the shardkv section and the late profile
    phases run in children."""
    import torch

    torch.cuda.empty_cache()  # the child's room on the card
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag,
         str(time.perf_counter() - T0)], stdout=subprocess.PIPE, text=True)
    result = None
    for line in proc.stdout:
        if line.startswith('{"' + key + '"'):
            result = json.loads(line)[key]
        else:
            print(line, end="", flush=True)
    check(proc.wait() == 0 and result is not None,
          f"{flag}'s process failed (rc {proc.returncode})")
    return result


def _shardkv_section(errs: dict) -> tuple:
    """``shardkv_section`` in a child (``_child``), its profiler windows
    first: (mode -> (the flagship's launches, the metrics flagship's),
    K6-shardkv's kernels-line timing); folds its errors into ``errs``."""
    result = _child("--shardkv-section", "shardkv_section")
    for k, v in result["errs"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    return ({mode: tuple(r) for mode, r in result["launches"].items()},
            {k: tuple(v) for k, v in result["timing"].items()})


def late_profiles(t0: float = 0.0) -> int:
    """The smoke's late profiler phases (``--late-profiles``, in a child:
    ``_child``): ``profile_kv_tick`` and ``profile_ctrler_tick`` metrics
    off and on, then K11's timing (``_shardkv_timing``); prints the phase
    lines, then ``{"late_profiles": {"shardkv_timing": ...,
    "shardkv_bytes": ...}}``."""
    import torch

    global T0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from madraft_tpu_torch.tpusim import prng

    T0 = time.perf_counter() - t0
    prng.set_partitionable(True)
    dev = torch.device("cuda")
    emit(_profile_kv_tick(dev, False))
    emit(_profile_kv_tick(dev, True))
    emit(_profile_ctrler_tick(dev, False))
    emit(_profile_ctrler_tick(dev, True))
    timing, counted = _shardkv_timing(dev)
    print(json.dumps({"late_profiles": {"shardkv_timing": timing,
                                        "shardkv_bytes": counted}}),
          flush=True)
    return 0


def _k6s_name(metrics_on: bool, mode: str) -> str:
    """The kernels line's name of K6-shardkv's build in a mode."""
    return ("shardkv_chunk" + "_metrics" * metrics_on
            + ("" if mode == "schedule" else f"_{mode}"))


def _shardkv_flagship(mode: str) -> tuple:
    """(the shardkv flagship in ``mode``, its metrics run)."""
    flag = [SHARDKV_CTRL_FLAG[mode]] if mode != "schedule" else []
    return SHARDKV_FLAGSHIP + flag, SHARDKV_METRICS_FLAGSHIP + flag


def _shardkv_path(dev, mode: str) -> tuple:
    """The shardkv main path in ``mode`` through the CLI: the flagship
    twice (--check-deterministic), then once with --metrics, each on
    K6-shardkv alone (launches of up to KERNEL_CHUNK ticks, no K6 or K11
    launch); the flagship's report beside the eager route's on the card
    (the eager raft ticks and the plain service tick) at
    SHARDKV_EAGER_TICKS; the CPU route's report at
    SHARDKV_CPU_DEPLOYMENTS x SHARDKV_CPU_TICKS
    beside the card's, metrics off and on; the eager-vs-kernel A/B at
    SHARDKV_AB_TICKS ticks. Returns (the flagship's launches, the metrics
    flagship's)."""
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.tpusim import engine, prng, shardkv

    prng.set_partitionable(True)
    ticks = _flag(SHARDKV_FLAGSHIP, "--ticks")
    b = _flag(SHARDKV_FLAGSHIP, "--clusters")
    ctrl = mode != "schedule"
    pre = "shardkv" if not ctrl else f"shardkv_{mode}"
    eager_off = ("threefry_tick_blocks", "oracle", "oracle_metrics",
                 "latency_fold", "seen_update", "kv_tick", "kv_chunk",
                 "ctrler_tick", "ctrler_chunk", "harvest", "record",
                 "tick_chunk", "shardkv_tick")
    advance = shardkv._advance_shardkv  # every shardkv run's ticks
    runs = {}
    for label, argv, n_runs in (
            (f"{pre}_flagship", _shardkv_flagship(mode)[0], FLAGSHIP_RUNS),
            (f"{pre}_metrics_flagship", _shardkv_flagship(mode)[1], 1)):
        metrics_on = "--metrics" in argv
        set_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        wall = time.perf_counter() - t0
        ran = read_counts()
        want = -(-ticks // engine.KERNEL_CHUNK) * n_runs
        check(rc == 0 and out["violating"] == 0
              and out.get("deterministic", n_runs == 1) is True
              and out["acked_ops_mean"] > 0 and out["installs_mean"] > 0
              and out["final_cfg_mean"] > 0
              and (out["deletes_mean"] > 0 if not ctrl
                   else out["ann_resolved_mean"] > 0),
              f"{label} rc {rc}: {out}")
        check(ran["shardkv_chunk"] == want
              and ran["shardkv_chunk_metrics"] == want * metrics_on
              and all(ran[f"shardkv_chunk_{x}"] == want * (x == mode)
                      for x in SHARDKV_CTRL_FLAG)
              and all(ran[f"shardkv_chunk_metrics_{x}"]
                      == want * (x == mode) * metrics_on
                      for x in SHARDKV_CTRL_FLAG)
              and all(ran[k] == 0 for k in eager_off),
              f"{label} launches {ran}: want K6-shardkv once a "
              f"{engine.KERNEL_CHUNK}-tick chunk ({want}), no K6, K11, draw "
              "chunk, K2, K4, K5, K9 or K10 launch")
        eager = {}
        if not metrics_on:
            # the eager route on the card at SHARDKV_EAGER_TICKS: the same
            # report as K6-shardkv's at that depth
            depth = SHARDKV_EAGER_TICKS[mode]
            one = [x for x in argv if x != "--check-deterministic"]
            one[one.index("--ticks") + 1] = str(depth)
            want_rep = out if depth == ticks else run_cli(one)[1]
            shardkv._advance_shardkv = functools.partial(advance,
                                                         tick="eager")
            try:
                rc_e, out_e = run_cli(one)
            finally:
                shardkv._advance_shardkv = advance
            check(rc_e == 0
                  and _report_fields(out_e) == _report_fields(want_rep),
                  f"{label}: the eager route's report at {depth} ticks "
                  "differs from K6-shardkv's")
            eager = {"eager_route_ticks": depth,
                     "eager_route_report_equal": True,
                     "eager_route_wall_ms_per_tick": out_e["telemetry"][
                         "execute_s"] / depth * 1e3}
        tele = out["telemetry"]
        row = {"phase": label, "argv": argv, "rc": rc, "mode": mode,
               "deployment_steps_per_s": tele["steps_per_sec"],
               "execute_s": tele["execute_s"],
               "wall_ms_per_tick": tele["execute_s"] / ticks * 1e3,
               "wall_s_all_runs": round(wall, 3),
               "compile_s": tele["compile_s"],
               "bytes_per_deployment": tele["bytes_per_lane"],
               "k6shardkv_instance": K11.chunk_instance(
                   _shardkv_cli_cfg()[0]),
               "acked_ops_mean": out["acked_ops_mean"],
               "installs_mean": out["installs_mean"],
               "deletes_mean": out["deletes_mean"],
               "final_cfg_mean": out["final_cfg_mean"],
               "frozen_left_mean": out["frozen_left_mean"], **eager,
               "launches": {k: v for k, v in ran.items() if v}}
        if ctrl:
            row.update(ann_resolved_mean=out["ann_resolved_mean"],
                       ctrl_walker_stalled_mean=out[
                           "ctrl_walker_stalled_mean"],
                       max_cfg_lag_mean=out["max_cfg_lag_mean"])
        if metrics_on:
            lat = out["latency"]
            check(all(k in out for k in METRIC_KEYS) and "phases" in lat,
                  f"shardkv metrics report lacks a block: {sorted(out)}")
            # the latency mass is the acked ops, on every phase row too
            ops = lat["ops"]
            check(round(ops / b, 2) == out["acked_ops_mean"]
                  and all(d["ops"] == ops for d in lat["phases"].values())
                  and "migration" in lat["phases"]
                  and sum(d["ops"] for d in lat["by_key"].values()) == ops,
                  f"shardkv latency mass {ops} vs acked "
                  f"{out['acked_ops_mean']}, phases {list(lat['phases'])}")
            row.update(p50_ticks=lat["p50_ticks"], p99_ticks=lat["p99_ticks"],
                       ops=ops, migration_ticks=lat["phases"]["migration"][
                           "ticks_total"])
        emit(row)
        runs[label] = ran

    # the CPU route at a small batch and depth beside the card's K6-shardkv
    cpu = {}
    for metrics_on in (False, True):
        argv = (_shardkv_flagship(mode)[0][:2]
                + ["--clusters", str(SHARDKV_CPU_DEPLOYMENTS), "--ticks",
                   str(SHARDKV_CPU_TICKS), "--seed", "12345"]
                + ([SHARDKV_CTRL_FLAG[mode]] if ctrl else [])
                + ["--metrics"] * metrics_on)
        set_counts()
        rc_k, out_k = run_cli(argv)
        ran = read_counts()
        t0 = time.perf_counter()
        rc_c, out_c = run_cli(argv + ["--platform", "cpu"])
        cpu_s = time.perf_counter() - t0
        check(rc_k == rc_c == 0 and ran["shardkv_chunk"] == 1
              and _report_fields(out_k) == _report_fields(out_c),
              f"{pre} at {SHARDKV_CPU_DEPLOYMENTS} x {SHARDKV_CPU_TICKS} "
              f"(metrics {metrics_on}): the CPU route's report differs from "
              f"K6-shardkv's ({ran})")
        cpu["metrics" if metrics_on else "plain"] = {
            "report_equal": True, "cpu_route_s": round(cpu_s, 3),
            "acked_ops_mean": out_c["acked_ops_mean"]}
    emit({"phase": f"{pre}_cpu_route", "deployments":
          SHARDKV_CPU_DEPLOYMENTS, "ticks": SHARDKV_CPU_TICKS, **cpu})

    # the A/B: the flagship's shape at SHARDKV_AB_TICKS ticks, eager (the
    # eager raft ticks, the plain service tick) and kernel (K6-shardkv) in
    # turns
    cfg, kcfg = _shardkv_cli_cfg(False, mode)
    ab, reps = [], []
    for route in ("eager", "kernel", "kernel", "eager"):
        set_counts()
        shardkv._advance_shardkv = functools.partial(advance, tick=route)
        try:
            fn = shardkv.make_shardkv_fuzz_fn(cfg, kcfg, b, SHARDKV_AB_TICKS,
                                              dev)
            rep, tele = engine.run_telemetry(fn, shardkv.shardkv_report,
                                             12345, b * SHARDKV_AB_TICKS,
                                             n_lanes=b)
        finally:
            shardkv._advance_shardkv = advance
        ran = read_counts()
        kernel = route == "kernel"
        check(ran["shardkv_chunk"] == int(kernel)
              and ran["tick_chunk"] == ran["shardkv_tick"] == 0
              and (ran["oracle"]
                   == (1 + ctrl) * SHARDKV_AB_TICKS * (not kernel)),
              f"shardkv {mode} A/B {route} launches {ran}")
        reps.append(rep)
        ab.append({"route": route, "ticks": SHARDKV_AB_TICKS,
                   "deployment_steps_per_s": tele["steps_per_sec"],
                   "wall_ms_per_tick": tele["execute_s"] / SHARDKV_AB_TICKS
                   * 1e3,
                   "launches": {k: v for k, v in ran.items() if v}})
    from madraft_tpu_torch.__main__ import _reports_equal

    check(all(_reports_equal(reps[0], r) for r in reps[1:]),
          f"shardkv {mode} A/B: the eager and the kernel route's reports "
          "differ")
    rate = {r: sum(x["deployment_steps_per_s"] for x in ab
                   if x["route"] == r) / 2 for r in ("eager", "kernel")}
    emit({"phase": f"{pre}_ab", "card": _smi(), "deployments": b,
          "runs": ab, "reports_equal": True,
          "kernel_over_eager": rate["kernel"] / rate["eager"]})
    return runs[f"{pre}_flagship"], runs[f"{pre}_metrics_flagship"]


def _ctrl_case_report(st, start, case, names) -> dict:
    """Per row case of a compared run: deployments, how many violate and
    the union of their bits, how many raise CTRL_STALE, the controller's
    mean resolved frontier, and the migrations, GCs and acks the compared
    ticks walked."""
    import torch

    from madraft_tpu_torch.tpusim import shardkv

    resolved = torch.cumprod((st.win_var >= 0).int(), -1).sum(-1) - 1
    out = {}
    for i, cname in enumerate(names):
        m = case == i
        v = torch.where(m, st.violations, 0)
        bits = 0
        for x in v.unique().tolist():
            bits |= int(x)
        out[cname] = {
            "deployments": int(m.sum()),
            "violating": int(((st.violations != 0) & m).sum()),
            "violation_bits": bits,
            "ctrl_stale": int(((st.violations
                                & shardkv.VIOLATION_SHARD_CTRL_STALE) != 0)
                              [m].sum()),
            "walker_stalled": int(st.ctrl_w_stalled[m].sum()),
            "resolved_mean": float(resolved[m].float().mean()),
            "installs_in_compared_ticks": int(
                ((st.installs_done - start.installs_done) * m).sum()),
            "deletes_in_compared_ticks": int(
                ((st.deletes_done - start.deletes_done) * m).sum()),
            "acks_in_compared_ticks": int(
                ((st.clerk_acked - start.clerk_acked).sum(-1) * m).sum())}
    return out


def _shardkv_ctrl_k11(dev, errs: dict) -> dict:
    """Phase shardkv_ctrl_k11: K11's controller branches (both modes, K11
    and K11-metrics) against the plain service tick on the card, every
    leaf after every one of SHARDKV_K11_TICKS ticks (the raft ticks by K6
    over the groups and over the controller clusters): each controller
    flagship's batch from tick SHARDKV_K11_WARM with the mode's cases as
    [B] knob rows (shardkv_row_cases: clean, the schedule mode's bugs,
    Puts, open-loop Zipf traffic, the re-query, the mode's bug), then the
    mode's edge batch SHARDKV_CTRL_EDGE with the planted walker stall.
    Reports, for each case, how many deployments violate and with which
    bits. Launches here are not main-path launches."""
    import torch

    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import engine, prng, shardkv

    counts = read_counts()
    b_flag = _flag(SHARDKV_FLAGSHIP, "--clusters")
    eb, en, eraft, ekw, ewarm = SHARDKV_CTRL_EDGE
    done = []
    for mode in ("live", "computed"):
        runs = ((f"{mode}_flagship_rows", b_flag, False, True, "rows"),
                (f"{mode}_flagship_rows_metrics_legacy", b_flag, True,
                 False, "rows"),
                (f"{mode}_edge_stall", eb, True, True, "edge"))
        for name, b, metrics_on, flag, kind in runs:
            cfg, kcfg = _shardkv_cli_cfg(metrics_on, mode)
            warm = SHARDKV_K11_WARM
            if kind == "edge":
                cfg = cfg.replace(n_nodes=en, **eraft)
                kcfg = kcfg.replace(**ekw)
                warm = ewarm
            g = kcfg.n_groups
            with prng.layout(flag):
                keys = engine.cluster_keys(12345, b, dev)
                kn = cfg.knobs(dev)
                skn = shardkv_knob_rows(kcfg, b).to(dev)
                st = shardkv._advance_shardkv(
                    cfg, kcfg, shardkv.init_shardkv_cluster(cfg, kcfg, keys,
                                                            kn, skn),
                    keys, kn, skn, warm)
                if kind == "edge":
                    # every other controller's shadow slid past the
                    # walker's next entry
                    c, odd = st.ctrl, torch.arange(b, device=dev) % 2 == 0
                    base = torch.where(odd, torch.maximum(
                        c.shadow_base, st.ctrl_w_frontier + 1), c.shadow_base)
                    st = st._replace(ctrl=c._replace(
                        shadow_base=base,
                        shadow_len=torch.where(odd, torch.maximum(
                            c.shadow_len, base + 5), c.shadow_len)))
                start = st
                gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
                ckeys = shardkv.ctrl_keys(keys)
                gkn = shardkv._group_knobs(kn, g)
                table = K11.knob_table(kn, skn, b)
                err = 0.0
                for _ in range(SHARDKV_K11_TICKS):
                    pre = st.rafts
                    s = shardkv._unflat(K6.tick_chunk(
                        cfg, shardkv._flat(pre), gkeys, gkn, 1), b)
                    ctrl = K6.tick_chunk(cfg, st.ctrl, ckeys, kn, 1)
                    want = shardkv._shardkv_service_tick(
                        cfg, kcfg, st, pre.alive, pre.base, s, keys, kn, skn,
                        ctrl)
                    got = K11.shardkv_tick(cfg, kcfg, st, pre.alive,
                                           pre.base, s, keys, kn, skn, table,
                                           ctrl=ctrl)
                    err = max(err, _shardkv_err(got, want))
                    st = want
            key = (f"shardkv_tick_metrics_{mode}" if metrics_on
                   else f"shardkv_tick_{mode}")
            errs[key] = max(errs[key], err)
            check(err == 0, f"K11 differs from its plain version: {name}")
            names = shardkv_row_cases(kcfg)
            case = torch.arange(b, device=dev) % len(names)
            per_case = _ctrl_case_report(st, start, case, names)
            walked = {k: sum(d[f"{k}_in_compared_ticks"]
                             for d in per_case.values())
                      for k in ("installs", "acks")}
            check(walked["acks"] > 0 and (kind != "rows"
                                          or walked["installs"] > 0),
                  f"shardkv_ctrl_k11 {name}: the compared ticks walked "
                  f"{per_case}")
            if kind == "edge":
                check(bool(st.ctrl_w_stalled[::2].all()),
                      f"{name}: the planted walker stall did not stick")
            done.append({"run": name, "mode": mode, "deployments": b,
                         "n_nodes": cfg.n_nodes, "log_cap": cfg.log_cap,
                         "walk_max": kcfg.walk_max, "metrics": metrics_on,
                         "partitionable": flag, "from_tick": warm,
                         "cases": per_case})
    set_counts(counts)
    return {"phase": "shardkv_ctrl_k11", "ticks": SHARDKV_K11_TICKS,
            "runs": done,
            "max_abs_err": max(errs[f"shardkv_tick{m}_{mode}"]
                               for m in ("", "_metrics")
                               for mode in ("live", "computed"))}


def _shardkv_state(dev, metrics_on: bool, ticks: int = 200,
                   mode: str = "schedule"):
    """The shardkv flagship's batch (in ``mode``, _shardkv_cli_cfg) after
    ``ticks`` ticks on the card's route, and its configs, keys and
    knobs."""
    from madraft_tpu_torch.tpusim import engine, shardkv

    cfg, kcfg = _shardkv_cli_cfg(metrics_on, mode)
    b = _flag(SHARDKV_FLAGSHIP, "--clusters")
    keys = engine.cluster_keys(12345, b, dev)
    kn, skn = cfg.knobs(dev), kcfg.knobs(dev)
    st = shardkv._advance_shardkv(
        cfg, kcfg, shardkv.init_shardkv_cluster(cfg, kcfg, keys, kn, skn),
        keys, kn, skn, ticks)
    return cfg, kcfg, st, keys, kn, skn


def _shardkv_bytes(cfg, kcfg, st, s, keys, table, written,
                   ctrl=None) -> dict:
    """The bytes one shardkv service tick must move (``_shardkv_timing``),
    counted as ``_kv_bytes`` counts K9's: every service leaf and every
    raft leaf it writes in kcfg's mode (``K11.writes``) read once and
    written once, the stepped raft rows it reads, the pre-tick views, the
    schedule, keys and knob rows read once, except the [G, n, cap] log
    rows and the [G, cap] shadow rows, of which the tick reads only the
    log_val slots its apply rounds reach and the shadow slots its walker
    steps over (this run's counts) and writes only the appended entries
    (a term and a value each). In a controller mode (``ctrl`` the stepped
    controller cluster) likewise the controller's rows, its log rows and
    its shadow row, of which the tick reads the slots its walker steps
    over and, for each Query arriving at a controller node, the node's
    shadow row (its uncovered announces) and, under the stale-read bug,
    its log row."""
    import torch

    from madraft_tpu_torch.kernels import shardkv as K11

    pre = st.rafts
    logs = ("log_term", "log_val")
    src = {"st": st, "s": s, "ctrl": ctrl}
    state = [getattr(src[w], f) for w, f in K11.writes(kcfg)
             if w == "st" or f not in logs]
    reads = ([getattr(s, f) for f in K11.RAFT_READS if f != "shadow_val"]
             + [pre.alive, pre.base, st.cfg_tick, keys, *table])
    if not kcfg.computed_ctrler:
        reads.append(st.cfg_owner)
    reset = (~pre.alive | ~s.alive | (s.snap_installed_src >= 0))
    start = torch.where(reset, s.base, st.applied)
    rounds = int((written.applied - start).sum())
    steps = int((written.w_frontier - st.w_frontier).sum())
    appends = int((written.rafts.log_len - s.log_len).sum())
    out = {"log_val_slots_read": rounds, "shadow_slots_read": steps,
           "log_entries_appended": appends}
    extra = 0
    if ctrl is not None:
        reads += [getattr(ctrl, f) for f in K11.CTRL_READS
                  if f != "shadow_val"]
        if kcfg.computed_ctrler:
            reads += [st.flip_a, st.flip_b]
        t = s.tick[:, :1]
        arrive = ((st.cq_req_t == t) & (st.cq_req_node >= 0)
                  & (st.cq_req_node < cfg.n_nodes))
        stale = arrive & (table[1][:, K11.KNOB_I32.index(
            "bug_stale_ctrler_read")] != 0)[:, None]
        out.update(
            ctrl_shadow_slots_read=int(
                (written.ctrl_w_frontier - st.ctrl_w_frontier).sum())
            + cfg.log_cap * int(arrive.sum()),
            ctrl_log_slots_read=cfg.log_cap * int(stale.sum()),
            ctrl_entries_appended=int(
                (written.ctrl.log_len - ctrl.log_len).sum()))
        extra = (4 * (out["ctrl_shadow_slots_read"]
                      + out["ctrl_log_slots_read"])
                 + 8 * out["ctrl_entries_appended"])
    out.update(state_read_and_written=2 * nbytes(*state),
               reads=nbytes(*reads))
    out["total"] = (out["state_read_and_written"] + out["reads"]
                    + 4 * (rounds + steps) + 8 * appends + extra)
    return out


# 32-bit operations of one computed-controller rebalance on a lane
# (csrc/ctrler.cuh rebalance at 3 groups, 10 shards: the retained loads
# and targets, the keep set and the deficit slots, some 30 operations a
# shard and group pair)
REBALANCE_OPS = 30 * 10 * 3


def _shardkv_ops(cfg, kcfg, st, written, rounds: int, steps: int,
                 ctrl_count=None) -> int:
    """The 32-bit operations one shardkv service tick does on this run's
    data (``_shardkv_timing``): the threefry hashes (the 14 draw keys a
    deployment, two fold-ins and a split each; a group's poll word; a
    clerk's learn and start words; a started op's shard draw (4 hashes a
    randint) and kind word; an outstanding clerk's retry word and target;
    a (group, shard) pair's pull and GC poll words where its leader pulls
    or holds a frozen copy), the restore (4 a table cell), the apply
    rounds and walker steps (an entry's decode and update, 20, and a
    CONFIG's pass over the shards, 6 a shard), and the leader views,
    mailbox scans and oracles (4 a (group, node, shard) cell and a
    (dst, src, shard) box). In a controller mode (``ctrl_count`` the
    bytes count of ``_shardkv_bytes``) also the 8 controller draw keys,
    the announcers' draws (2 words, 2 randints), a group's Query hop
    words (1, and 5 where it asks), the controller walker's steps (20
    each), the Query scans (6 a slot) and a resolving slot's rebalance on
    each replica (REBALANCE_OPS)."""
    from madraft_tpu_torch.tpusim.shardkv import FROZEN, PULLING

    b, g, n = st.clerk_seq.shape[0], kcfg.n_groups, cfg.n_nodes
    ns, nc = kcfg.n_shards, kcfg.n_clients
    started = int((written.clerk_seq != st.clerk_seq).sum())
    outstanding = int(written.clerk_out.sum())
    # the pairs whose leader pulls or holds a frozen copy, by the walker's
    # view of the groups
    moving = int(((written.w_phase == PULLING)
                  | (written.w_phase == FROZEN)).sum())
    hashes = (b * (14 * 3 + g + 2 * nc) + started * (4 + 1)
              + outstanding * (1 + 4) + 2 * moving)
    cells = g * n * (3 * ns + ns * nc + 2)
    boxes = g * g * ns * (6 + nc)
    ops = b * 4 * (2 * cells + boxes) + (rounds + steps) * (20 + 6 * ns)
    if ctrl_count is not None:
        asks = int(((written.cq_req_t != 0)
                    & (written.cq_req_t != st.cq_req_t)).sum())
        hashes += b * (8 * 3 + 2 + 2 * 4 + g) + 5 * asks
        resolved = 0
        if kcfg.computed_ctrler:
            resolved = int((written.slot_tick != st.slot_tick).any(-1).sum())
        ops += (20 * ctrl_count["ctrl_shadow_slots_read"]
                + 6 * ctrl_count["ctrl_log_slots_read"]
                + resolved * n * REBALANCE_OPS)
    return hashes * OPS_PER_HASH + ops


# the modes of _shardkv_timing's rows: name -> (metrics, mode)
SHARDKV_TIMED = {"shardkv_tick": (False, "schedule"),
                 "shardkv_tick_metrics": (True, "schedule"),
                 "shardkv_tick_live": (False, "live"),
                 "shardkv_tick_computed": (False, "computed"),
                 "shardkv_tick_metrics_live": (True, "live"),
                 "shardkv_tick_metrics_computed": (True, "computed")}


def _shardkv_timing(dev) -> tuple:
    """K11's times at the shardkv flagship's shape (tick 200 to 201) in
    each row of SHARDKV_TIMED: K11 and K11-metrics in each of the three
    modes: (name -> (device ms,
    call ms, plain ms, bytes, operations), the timing phase's tuple; name
    -> ``_shardkv_bytes``' count). Each launch reads its inputs from
    device memory (copies in rotation)."""
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import shardkv

    counts = read_counts()
    out, counted = {}, {}
    for name, (metrics_on, mode) in SHARDKV_TIMED.items():
        cfg, kcfg, st, keys, kn, skn = _shardkv_state(dev, metrics_on,
                                                      mode=mode)
        b, g = keys.shape[0], kcfg.n_groups
        pre = st.rafts
        s = shardkv._unflat(K6.tick_chunk(
            cfg, shardkv._flat(pre), shardkv.group_keys(keys, g).reshape(
                -1, 2), shardkv._group_knobs(kn, g), 1), b)
        ctrl = (K6.tick_chunk(cfg, st.ctrl, shardkv.ctrl_keys(keys), kn, 1)
                if mode != "schedule" else None)
        table = K11.knob_table(kn, skn, b)
        written = K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base, s,
                                   keys, kn, skn, table, ctrl=ctrl)
        counted[name] = _shardkv_bytes(cfg, kcfg, st, s, keys, table,
                                       written, ctrl)
        ops = _shardkv_ops(cfg, kcfg, st, written,
                           counted[name]["log_val_slots_read"],
                           counted[name]["shadow_slots_read"],
                           counted[name] if ctrl is not None else None)
        counted[name]["operations"] = ops
        inputs = ([getattr(st, f) for f in K11.SERVICE_WRITES
                   + K11.CTRL_WRITES]
                  + [getattr(s, f) for f in K11.RAFT_READS + K11.RAFT_WRITES]
                  + [pre.alive, pre.base, st.cfg_tick, st.cfg_owner, keys,
                     *table])
        if ctrl is not None:
            inputs += [getattr(ctrl, f) for f in set(
                K11.CTRL_READS + K11.CTRL_RAFT_WRITES)]
        n_in = nbytes(*inputs)

        def clone(x):
            return (type(x)(*(clone(y) for y in x)) if isinstance(x, tuple)
                    else x.clone())

        rot = [(st, s, ctrl)] + [
            (clone(st), clone(s), None if ctrl is None else clone(ctrl))
            for _ in range(rotations(n_in) - 1)]

        def call(i, plain=False):
            k, r, c = rot[i % len(rot)]
            return K11.shardkv_tick(cfg, kcfg, k, pre.alive, pre.base, r,
                                    keys, kn, skn, table, plain=plain,
                                    ctrl=c)

        out[name] = (device_ms(call, "shardkv_kernel"),
                     cuda_ms(call),
                     cuda_ms(lambda i: call(i, True), iters=5, warmup=1),
                     counted[name]["total"], ops)
        del rot
    set_counts(counts)
    return out, counted


def _k6shardkv_timing(dev, plain: bool = True, between=None) -> dict:
    """K6-shardkv's times at the shardkv flagship's shape in each mode and
    build, one SHARDKV_K6S_TIMED_TICKS-tick launch from tick 200: name ->
    (device ms, call ms, plain ms (None without ``plain``), bytes,
    operations). The bytes: the groups' and, in a controller mode, the
    controller's K6 state (the metric leaves with metrics) and the service
    leaves the mode writes, read and written once; the keys, the three knob
    tables and the schedule read once. The operations: per cluster-tick
    K6's draws (2 + total hashes and a word each) over the B x G group
    clusters (and the B controller clusters), and per tick the service
    tick's on this run's data as ``_shardkv_ops`` counts K11's (from the
    plain version's ticks, whose time includes that count's host reads;
    without ``plain`` the bound is the bytes'). Every row's kernel is timed
    before any plain route runs (``between()`` runs in between): see
    ``_shardkv_section``."""
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.tpusim import shardkv, step

    counts = read_counts()
    m = SHARDKV_K6S_TIMED_TICKS
    rows = {}
    for mode in ("schedule", "live", "computed"):
        for metrics_on in (False, True):
            cfg, kcfg, st, keys, kn, skn = _shardkv_state(dev, metrics_on,
                                                          mode=mode)
            tables = K11.chunk_tables(cfg, kcfg, kn, skn, int(keys.shape[0]))

            def call(i, a=(cfg, kcfg, st, keys, kn, skn, m, tables)):
                return K11.shardkv_chunk(*a)

            rows[_k6s_name(metrics_on, mode)] = (
                (cfg, kcfg, st, keys, kn, skn, tables, mode != "schedule"),
                device_ms(call, "shardkv_chunk_kernel", iters=5, warmup=1),
                cuda_ms(call, iters=3, warmup=1))
    if between is not None:
        between()
    out = {}
    for name, ((cfg, kcfg, st, keys, kn, skn, tables, ctrl), ms,
               call_ms) in rows.items():
        b, g = int(keys.shape[0]), kcfg.n_groups
        gkeys = shardkv.group_keys(keys, g).reshape(-1, 2)
        ckeys, gkn = shardkv.ctrl_keys(keys), shardkv._group_knobs(kn, g)
        service_ops = []

        def run_plain(i):
            k = st
            for _ in range(m):
                pre = k.rafts
                s = shardkv._unflat(step.step_cluster(
                    cfg, shardkv._flat(pre), gkeys, gkn), b)
                c = step.step_cluster(cfg, k.ctrl, ckeys, kn) if ctrl else None
                k2 = shardkv._shardkv_service_tick(
                    cfg, kcfg, k, pre.alive, pre.base, s, keys, kn, skn, c)
                n_b = _shardkv_bytes(cfg, kcfg, k, s, keys, tables[2], k2, c)
                service_ops.append(_shardkv_ops(
                    cfg, kcfg, k, k2, n_b["log_val_slots_read"],
                    n_b["shadow_slots_read"], n_b if ctrl else None))
                k = k2
            return k

        plain_ms = cuda_ms(run_plain, iters=1, warmup=0) if plain else None
        total = step._block_total(cfg.n_nodes)
        ops = (b * (g + ctrl) * m * ((2 + total) * OPS_PER_HASH + total)
               + sum(service_ops))
        written = [getattr(st, f) for w, f in K11.writes(kcfg) if w == "st"]
        nb = (2 * nbytes(*st.rafts, *(st.ctrl if ctrl else ()), *written)
              + nbytes(keys, *tables[0], *tables[1], *tables[2], st.cfg_tick,
                       st.cfg_owner, st.flip_a, st.flip_b))
        out[name] = (ms, call_ms, plain_ms, nb, ops)
    set_counts(counts)
    return out


def _profile_shardkv_tick(dev, metrics_on: bool, n_ticks: int = 512,
                          mode: str = "schedule") -> dict:
    """Where a shardkv flagship tick's wall goes (torch.profiler, the
    window retry of ``_profiled``), in ``mode``: the device operations a
    tick, the card's busy share of the wall and the host's, K6-shardkv's
    share and device ms a tick, over n_ticks ticks from tick 200 (the
    flagship's depth: two K6-shardkv launches)."""
    from madraft_tpu_torch.tpusim import engine, shardkv

    cfg, kcfg, st, keys, kn, skn = _shardkv_state(dev, metrics_on,
                                                  mode=mode)
    counts = read_counts()
    # every K6-shardkv launch of the window, or the shares would be of a
    # part
    _, kernels, wall_ms, _, attempts = _profiled(
        lambda: shardkv._advance_shardkv(cfg, kcfg, st, keys, kn, skn,
                                         n_ticks),
        expect={"shardkv_chunk_kernel": -(-n_ticks // engine.KERNEL_CHUNK)})
    set_counts(counts)

    def dev_ms(name):
        return sum(_dev_us(e) for e in kernels if name in e.key) / 1e3

    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    suffix = "_metrics" * metrics_on + ("" if mode == "schedule"
                                        else f"_{mode}")
    return {"phase": "profile_shardkv_tick" + suffix,
            "card": _smi(), "ticks": n_ticks, "mode": mode,
            "deployments": int(keys.shape[0]),
            "group_clusters": int(keys.shape[0]) * kcfg.n_groups,
            "controller_clusters": int(keys.shape[0]) * (mode != "schedule"),
            "profiler_attempts": attempts,
            "wall_ms_per_tick": wall_ms / n_ticks,
            "device_busy_ms_per_tick": busy_ms / n_ticks,
            "device_busy_share": busy_ms / wall_ms,
            "host_share": 1 - busy_ms / wall_ms,
            "k6shardkv_ms_per_tick": dev_ms("shardkv_chunk_kernel") / n_ticks,
            "k6shardkv_share": dev_ms("shardkv_chunk_kernel") / wall_ms,
            "k6_ms_per_tick": dev_ms("tick_chunk_kernel") / n_ticks,
            "k11_ms_per_tick": dev_ms("shardkv_kernel") / n_ticks,
            "device_ops_per_tick": sum(e.count for e in kernels) / n_ticks,
            "top_device_ms_per_tick": {
                e.key[:60]: _dev_us(e) / 1e3 / n_ticks for e in sorted(
                    kernels, key=_dev_us, reverse=True)[:5]}}


def _shardkv_phases(dev) -> dict:
    """Where a K11 launch's time goes at the shardkv flagship's shape (tick
    200 to 201), in each mode: the profile build's clock64() cycles a
    phase from each block's start (kernels/shardkv.py PHASES) and the
    truth walker's own, median and max over the deployments, the profile
    build's state held against K11's; then each build's ptxas report
    (registers, stack, spills) and its layout at that batch in each mode
    (threads a block, the blocks and warps an SM holds)."""
    import torch

    from madraft_tpu_torch import _build
    from madraft_tpu_torch.kernels import shardkv as K11
    from madraft_tpu_torch.kernels import tick as K6
    from madraft_tpu_torch.tpusim import shardkv

    counts = read_counts()
    out = {"phase": "shardkv_phases", "card": _smi(), "modes": {},
           "builds": {b: {"ptxas": _build.ptxas(b), "grid": {}} for b in (
               "shardkv", "shardkv_metrics", "shardkv_profile")}}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for mode in ("schedule", "live", "computed"):
        for build, metrics_on in (("shardkv", False),
                                  ("shardkv_metrics", True)):
            cfg, kcfg, st, keys, kn, skn = _shardkv_state(dev, metrics_on,
                                                          mode=mode)
            b, g, pre = int(keys.shape[0]), kcfg.n_groups, st.rafts
            s = shardkv._unflat(K6.tick_chunk(
                cfg, shardkv._flat(pre), shardkv.group_keys(keys, g).reshape(
                    -1, 2), shardkv._group_knobs(kn, g), 1), b)
            ctrl = (K6.tick_chunk(cfg, st.ctrl, shardkv.ctrl_keys(keys), kn,
                                  1) if mode != "schedule" else None)
            table = K11.knob_table(kn, skn, b)
            grid = K11.grid(cfg, kcfg, st, pre.alive, pre.base, s, keys,
                            table, K11._lib(build), ctrl)
            out["builds"][build]["grid"][mode] = _resident(
                grid, b, grid["deployments_a_block"])
            if metrics_on:
                continue
            lib = K11._lib("shardkv_profile")
            for _ in range(3):
                got = K11._launch(cfg, kcfg, st, pre.alive, pre.base, s, keys,
                                  table, lib, stream, ctrl)
            torch.cuda.synchronize()
            want = K11.shardkv_tick(cfg, kcfg, st, pre.alive, pre.base, s,
                                    keys, kn, skn, table, ctrl=ctrl)
            check(_shardkv_err(got, want) == 0,
                  f"K11's profile build differs from K11 ({mode})")
            out["modes"][mode] = {"deployments": b, **_phase_cycles(
                lib, "shardkv_phase_cycles", b, K11.PHASES)}
    set_counts(counts)
    return out


def _storm_cfg():
    """The flagship's config: --storm on the default 5-node SimConfig."""
    from madraft_tpu_torch.__main__ import _storm
    from madraft_tpu_torch.tpusim.config import SimConfig

    return _storm(SimConfig())


if __name__ == "__main__":
    # keep CUPTI attached across the script's profiler windows: torn down
    # and attached again at each window (PyTorch's default), it lost more
    # of a window's first kernel records the more windows the process had
    # opened (``cupti_probe.py``; PyTorch sets the same where it profiles
    # CUDA graphs)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    if sys.argv[1:2] == ["--service-leg"]:
        sys.exit(service_leg(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--k6-leg"]:
        sys.exit(k6_leg(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--kv-leg"]:
        sys.exit(kv_leg(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--ctrler-leg"]:
        sys.exit(ctrler_leg(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--shardkv-leg"]:
        sys.exit(shardkv_leg(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--shardkv-section"]:
        sys.exit(shardkv_section(*map(float, sys.argv[2:3])))
    if sys.argv[1:2] == ["--late-profiles"]:
        sys.exit(late_profiles(*map(float, sys.argv[2:3])))
    sys.exit(main())
