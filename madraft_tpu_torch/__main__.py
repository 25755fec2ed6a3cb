"""madtpu CLI on the PyTorch port (raw-raft verbs).

    python -m madraft_tpu_torch fuzz   --clusters 4096 --ticks 1024 [--storm]
    python -m madraft_tpu_torch pool   --clusters 4096 --ticks 512 --budget-ticks 1024
    python -m madraft_tpu_torch replay --seed S --cluster C --ticks T [--storm]
    python -m madraft_tpu_torch fuzz --list-profiles

The verbs take the JAX CLI's flags and print its JSON keys, so a report
from either package reads the same; ``pool`` streams one JSONL row per
retired cluster and then its summary line. Runs go to the CUDA card unless
``--platform cpu`` is given; without a card the run fails rather than fall
back. Exit codes: 0 clean, 1 violation found (or a failed
``--check-deterministic``), 2 usage error. The JAX CLI's other verbs, and
the flags of paths not ported yet (``--mesh``, ``--metrics``, pool's
``--devices N>1``, ``--coverage*``, ``--heartbeat``, ``--digest-every``),
exit 2 naming the ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NOT_PORTED_VERBS = (
    "kv-fuzz", "ctrler-fuzz", "shardkv-fuzz", "sweep", "explain",
    "bridge", "stats", "lint",
)


def _storm(cfg):
    return cfg.replace(
        p_client_cmd=0.2, loss_prob=0.1, p_crash=0.01, p_restart=0.2,
        max_dead=2, p_repartition=0.02, p_heal=0.05,
    )


def _sim_config(args):
    from madraft_tpu_torch.tpusim.config import SimConfig, storm_profiles

    profiles = storm_profiles()
    prof = args.profile
    single_cluster = getattr(args, "cluster", None) is not None
    if prof:
        cfg, rec_clusters, rec_ticks, _bugs = profiles[prof]
        if args.storm:
            print(
                f"madtpu: warning: --storm is ignored — profile {prof!r} "
                "defines the full fault storm", file=sys.stderr,
            )
        if args.bug and not single_cluster and (
                args.clusters * args.ticks < rec_clusters * rec_ticks):
            print(
                f"madtpu: warning: profile {prof!r} demonstrated "
                f"{args.bug!r} at --clusters {rec_clusters} --ticks "
                f"{rec_ticks}; the current budget may be too small for the "
                "bug to manifest", file=sys.stderr,
            )
    else:
        cfg = SimConfig(n_nodes=args.nodes)
        if args.storm:
            cfg = _storm(cfg)
        if args.bug and not single_cluster:
            want = [
                name for name, (_, _, _, bugs) in profiles.items()
                if args.bug in bugs
            ]
            hint = f" (try --profile {want[0]})" if want else ""
            print(
                f"madtpu: warning: --bug {args.bug!r} without --profile — "
                f"the bug may never manifest at these settings{hint}",
                file=sys.stderr,
            )
    if args.majority_override:
        cfg = cfg.replace(majority_override=args.majority_override)
    if args.bug:
        cfg = cfg.replace(bug=args.bug)
    if args.fsync_every:
        cfg = cfg.replace(fsync_every=args.fsync_every)
    if args.lose_unsynced >= 0:
        cfg = cfg.replace(p_lose_unsynced=args.lose_unsynced)
    return cfg


def cmd_list_profiles(args=None) -> int:
    """Print the scenario registry, one row per profile, and exit 0."""
    import dataclasses

    from madraft_tpu_torch.tpusim.config import (
        SimConfig,
        profile_gates,
        storm_profiles,
    )

    gates = profile_gates()
    print(f"{'profile':18s} {'floor>=':>8s} {'p99<=':>6s} {'scale':>10s} "
          f"{'bridge':11s} knobs")
    for name, (cfg, rec_clusters, rec_ticks, bugs) in storm_profiles().items():
        base = dataclasses.asdict(SimConfig(n_nodes=cfg.n_nodes))
        cur = dataclasses.asdict(cfg)
        delta = " ".join(
            f"{k}={v}" for k, v in cur.items() if v != base[k]
        ) or "(defaults)"
        if cfg.n_nodes != 5:
            delta = f"n_nodes={cfg.n_nodes} " + delta
        g = gates[name]
        wl = g.get("workload") or {}
        if wl:
            delta += " | workload: " + " ".join(
                f"{k}={v}" for k, v in wl.items()
            )
        if bugs:
            delta += " | demonstrates: " + ",".join(bugs)
        print(f"{name:18s} {g['liveness_floor']:>8g} {g['p99_ceiling']:>6d} "
              f"{rec_clusters:>5d}x{rec_ticks:<4d} {g['bridge']:11s} "
              f"{delta}")
    return 0


def _usage_error(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(2)


def _knobs_json(verb: str, raw: str):
    if not raw:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError as e:
        _usage_error(f"{verb}: --knobs-json is not valid JSON: {e}")


def _device(args):
    """--platform: None/cuda/gpu -> the card (required), cpu -> the CPU."""
    from madraft_tpu_torch.tpusim.engine import resolve_device

    plat = (args.platform or "cuda").lower()
    if plat not in ("cuda", "gpu", "cpu"):
        _usage_error(f"unknown --platform {args.platform!r} (cuda | cpu)")
    return resolve_device("cpu" if plat == "cpu" else "cuda")


def _reports_equal(a, b) -> bool:
    import numpy as np

    return all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in a._fields
    )


def _det_check(args, rep, rerun):
    """Re-run and demand a bit-identical report when --check-deterministic
    or MADTPU_TEST_CHECK_DETERMINISTIC (unset, empty or "0" = off) asks."""
    env = os.environ.get("MADTPU_TEST_CHECK_DETERMINISTIC", "0")
    if not (args.check_deterministic or env not in ("", "0")):
        return {}, False
    same = _reports_equal(rep, rerun())
    return {"deterministic": bool(same)}, not same


def _report_json(rep, extra=None):
    import numpy as np

    from madraft_tpu_torch.tpusim.config import violation_names

    bad = rep.violating_clusters()
    union = int(np.bitwise_or.reduce(rep.violations.ravel())) \
        if rep.violations.size else 0
    out = {
        "violating": int(rep.n_violating),
        "violating_clusters": [int(c) for c in bad[:16]],
        "violating_clusters_total": int(bad.size),
        "violation_names": violation_names(union),
    }
    for f in rep._fields:
        v = getattr(rep, f)
        if v is None or getattr(v, "ndim", 0) > 1:
            continue
        if hasattr(v, "mean"):
            out[f"{f}_mean"] = round(float(v.mean()), 2)
    if extra:
        out.update(extra)
    print(json.dumps(out))


def cmd_fuzz(args) -> int:
    from madraft_tpu_torch.tpusim.engine import make_fuzz_fn, report, run_telemetry

    if args.mesh:
        _usage_error("fuzz: --mesh is not ported yet (ROADMAP queue C)")
    cfg = _sim_config(args)
    try:
        fn = make_fuzz_fn(cfg, args.clusters, args.ticks, device=_device(args))
    except ValueError as e:
        _usage_error(f"fuzz: {e}")
    rep, tele = run_telemetry(
        fn, report, args.seed, args.clusters * args.ticks,
        n_lanes=args.clusters,
    )

    def rerun():
        return report(fn(args.seed))

    extra, det_failed = _det_check(args, rep, rerun)
    _report_json(rep, {"seed": args.seed, "telemetry": tele, **extra})
    return 1 if (rep.n_violating or det_failed) else 0


def _state_schema(cfg, knobs, ticks: int, device) -> dict:
    """The replay artifact's schema stamp: the schema version and the
    layout a pool of this run would carry (``packed_layout_reason``, the
    rule ``run_pool`` applies; the replayed state is the same in either).
    Called after the replay succeeded, so the knobs are known-valid."""
    from madraft_tpu_torch.tpusim.engine import resolve_knobs
    from madraft_tpu_torch.tpusim.state import (
        STATE_SCHEMA_VERSION,
        packed_layout_reason,
    )

    kn = resolve_knobs(cfg, knobs, device)
    packed = packed_layout_reason(cfg, kn, ticks) is None
    return {
        "state_schema_version": STATE_SCHEMA_VERSION,
        "state_layout": "packed" if packed else "wide",
    }


def cmd_replay(args) -> int:
    from madraft_tpu_torch.tpusim.config import violation_names
    from madraft_tpu_torch.tpusim.engine import replay_cluster

    cfg = _sim_config(args)
    knobs = _knobs_json("replay", args.knobs_json)
    dev = _device(args)
    try:
        st = replay_cluster(cfg, args.seed, args.cluster, args.ticks,
                            knobs=knobs, device=dev)
    except ValueError as e:
        _usage_error(f"replay: {e}")
    viol = int(st.violations[0])
    print(json.dumps({
        "seed": args.seed,
        "cluster": args.cluster,
        **_state_schema(cfg, knobs, args.ticks, dev),
        "violations": viol,
        "violation_names": violation_names(viol),
        "first_violation_tick": int(st.first_violation_tick[0]),
        "committed": int(st.shadow_len[0]),
        "terms": st.term[0].cpu().tolist(),
    }))
    return 1 if viol else 0


def cmd_pool(args) -> int:
    """Continuous fuzzing pool (retire-and-refill): --clusters lanes stay
    resident; a lane retires when its cluster violated or reached the
    --ticks horizon and is refilled under a new global id, so any streamed
    hit replays like a fuzz hit. Streams one JSONL line per retired
    cluster, then a summary line; exit 1 iff a violation was found.
    --devices 1 runs the lane-partitioned id scheme (lane l's generation-g
    cluster owns id g*lanes + l)."""
    import torch

    from madraft_tpu_torch.tpusim.engine import run_pool

    def usage_error(msg):
        # exit 2, not 1: for pool, exit 1 is the "violation found" signal
        _usage_error(f"pool: {msg}")

    for flag, on, item in (
            ("--mesh", args.mesh, "A6"),
            ("--coverage", args.coverage, "A8"),
            ("--coverage-random", args.coverage_random, "A8"),
            ("--coverage-bits", args.coverage_bits is not None, "A8"),
            ("--heartbeat", args.heartbeat, "A15"),
            ("--digest-every", args.digest_every, "A15")):
        if on:
            usage_error(f"{flag} is not ported yet (ROADMAP {item})")
    if args.devices < 0:
        usage_error(f"--devices {args.devices} must be >= 1 (0 = unset)")
    if args.devices > 1:
        usage_error(f"--devices {args.devices} is not ported yet (ROADMAP "
                    "A6: one device only)")
    if args.ticks < 1:
        usage_error(f"--ticks {args.ticks}: the horizon must be >= 1 tick")
    devices = args.devices or None
    cfg = _sim_config(args)
    dev = _device(args)
    budget_ticks = args.budget_ticks if args.budget_ticks > 0 else None
    budget_seconds = args.budget_seconds if args.budget_seconds > 0 else None
    emit_all = args.emit == "all"

    def on_retired(row):
        if emit_all or row["violations"]:
            print(json.dumps(row), flush=True)

    summary = run_pool(
        cfg, args.seed, args.clusters, args.ticks,
        chunk_ticks=args.chunk_ticks, budget_ticks=budget_ticks,
        budget_seconds=budget_seconds, devices=devices,
        on_retired=on_retired, device=dev,
    )
    summary.update({
        "seed": args.seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "backend": dev.type,
    })
    print(json.dumps(summary))
    return 1 if summary["retired_violating"] else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED_VERBS:
        print(f"madtpu: verb {argv[0]!r} is not ported yet (ROADMAP queue A)",
              file=sys.stderr)
        return 2
    p = argparse.ArgumentParser(prog="python -m madraft_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, clusters):
        sp.add_argument("--platform", default=None,
                        help="cuda (default: the attached card, required) "
                             "or cpu")
        sp.add_argument("--seed", type=int, default=12345)
        sp.add_argument("--nodes", type=int, default=5)
        sp.add_argument("--clusters", type=int, default=clusters)
        sp.add_argument("--ticks", type=int, default=512)
        sp.add_argument("--storm", action="store_true",
                        help="full fault storm (loss+crash+partitions)")
        sp.add_argument("--majority-override", type=int, default=0,
                        help="deliberately broken quorum (oracle demo)")
        sp.add_argument("--fsync-every", type=int, default=0,
                        help="background fsync cadence in ticks (0 = keep "
                             "the profile/default)")
        sp.add_argument("--lose-unsynced", type=float, default=-1.0,
                        help="probability a crash drops the un-fsynced "
                             "suffix (negative = keep profile/default)")
        sp.add_argument("--bug", default="",
                        help="raft-layer planted bug (config.RAFT_BUGS)")
        sp.add_argument("--metrics", action="store_true",
                        help="on-device metrics plane (not ported yet: "
                             "exits 2)")
        sp.add_argument("--profile", default="",
                        help="named scenario from config.storm_profiles() "
                             "(see --list-profiles)")
        sp.add_argument("--list-profiles", action="store_true",
                        help="print the scenario registry and exit 0")

    sp = sub.add_parser("fuzz", help="raw-raft batched fuzz")
    common(sp, 4096)
    sp.add_argument("--mesh", action="store_true",
                    help="shard over all devices (not ported yet: exits 2)")
    sp.add_argument("--check-deterministic", action="store_true",
                    help="run twice, demand a bit-identical report (also "
                         "enabled by MADTPU_TEST_CHECK_DETERMINISTIC)")
    sp.set_defaults(fn=cmd_fuzz)

    sp = sub.add_parser(
        "pool",
        help="continuous fuzzing pool: retire violated/horizon-reached "
             "clusters and refill their lanes under new global ids "
             "(--ticks is the per-cluster horizon); streams retired-cluster "
             "reports as JSONL + a summary line",
    )
    common(sp, 4096)
    sp.add_argument("--mesh", action="store_true",
                    help="shard over all devices (not ported yet: exits 2)")
    sp.add_argument("--devices", type=int, default=0,
                    help="1 = the lane-partitioned global-id scheme (lane "
                         "l's generation-g cluster owns id g*lanes + l); "
                         "0 = the monotone-id pool; more than 1 is not "
                         "ported yet (exits 2)")
    sp.add_argument("--chunk-ticks", type=int, default=0,
                    help="ticks per chunk between harvests (0 = the horizon "
                         "split into equal chunks of at most 256 ticks)")
    sp.add_argument("--budget-ticks", type=int, default=0,
                    help="stop once every lane has run this many ticks, "
                         "rounded up to whole chunks (0 = unset; with "
                         "--budget-seconds also unset, one horizon)")
    sp.add_argument("--budget-seconds", type=float, default=0.0,
                    help="stop at the first harvest past this wall-clock "
                         "budget (0 = unset)")
    sp.add_argument("--emit", default="all", choices=["all", "violations"],
                    help="stream every retired-cluster report, or only "
                         "violating ones")
    sp.add_argument("--coverage", action="store_true",
                    help="coverage-guided refill (not ported yet: exits 2)")
    sp.add_argument("--coverage-bits", type=int, default=None,
                    help="seen-set bitmap size (not ported yet: exits 2)")
    sp.add_argument("--coverage-random", action="store_true",
                    help="coverage baseline (not ported yet: exits 2)")
    sp.add_argument("--heartbeat", default="",
                    help="live-telemetry stream (not ported yet: exits 2)")
    sp.add_argument("--digest-every", type=int, default=0,
                    help="progress digest (not ported yet: exits 2)")
    sp.set_defaults(fn=cmd_pool)

    sp = sub.add_parser("replay", help="re-run ONE cluster exactly")
    common(sp, 1)
    sp.add_argument("--cluster", type=int, required=True)
    sp.add_argument("--knobs-json", default="",
                    help="JSON object of dynamic-knob overrides")
    sp.set_defaults(fn=cmd_replay)

    args = p.parse_args(argv)
    if args.list_profiles:
        return cmd_list_profiles(args)
    if args.profile:
        from madraft_tpu_torch.tpusim.config import storm_profiles

        names = list(storm_profiles())
        if args.profile not in names:
            print(
                f"madtpu: unknown --profile {args.profile!r}; available: "
                + " ".join(names), file=sys.stderr,
            )
            return 2
    if args.metrics:
        print("madtpu: --metrics is not ported yet (ROADMAP A7)",
              file=sys.stderr)
        return 2
    try:
        return args.fn(args)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 2


if __name__ == "__main__":
    sys.exit(main())
