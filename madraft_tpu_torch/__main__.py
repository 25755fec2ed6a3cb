"""madtpu CLI on the PyTorch port (the raw-raft verbs, kv-fuzz,
ctrler-fuzz and shardkv-fuzz).

    python -m madraft_tpu_torch fuzz   --clusters 4096 --ticks 1024 [--storm] [--metrics]
    python -m madraft_tpu_torch kv-fuzz --clusters 512 --ticks 512 [--service-bug stale_read]
    python -m madraft_tpu_torch ctrler-fuzz --clusters 512 --ticks 512 [--service-bug rotate_tiebreak]
    python -m madraft_tpu_torch shardkv-fuzz --clusters 64 --ticks 512 [--service-bug skip_freeze]
    python -m madraft_tpu_torch shardkv-fuzz --live-ctrler | --computed-ctrler [--service-bug stale_ctrler_read | rotate_tiebreak]
    python -m madraft_tpu_torch pool   --clusters 4096 --ticks 512 --budget-ticks 1024 [--coverage]
    python -m madraft_tpu_torch sweep  --loss 0,0.1,0.3 --crash 0,0.02 --repartition 0,0.05
    python -m madraft_tpu_torch replay --seed S --cluster C --ticks T [--storm] [--knobs-json ROW]
    python -m madraft_tpu_torch explain --seed S --cluster C --ticks T [--format jsonl|chrome] [--out F]
    python -m madraft_tpu_torch stats  REPORT.json [POOL.jsonl ...] [--json]
    python -m madraft_tpu_torch fuzz --list-profiles

The verbs take the JAX CLI's flags and print its JSON keys, so a report
from either package reads the same; ``pool`` streams one JSONL row per
retired cluster and then its summary line; ``pool --coverage`` is the
coverage-guided pool (abstract-state fingerprints in an on-device
seen-set, a biased knob refill; rows gain ``new_fingerprints``/``refill``/
``knobs``, which ``replay --knobs-json`` replays). ``explain`` replays
one cluster with the flight recorder on and prints its event timeline
(JSONL around the first violation) or a Perfetto trace. ``sweep`` runs a
fault-parameter grid, a knob row per cluster, and reports each cell.
``kv-fuzz`` fuzzes the kv service layer (clerks, apply machines, the kv
oracles) on top of the raft tick, with an optional planted service bug
(``--service-bug``); with ``--metrics`` its report adds the clerks'
submit->ack latency per key and per client. ``ctrler-fuzz`` fuzzes the
shard controller's config service (Join / Leave / Move / Query, the
canonical rebalance, the truth walker and the four controller oracles)
the same way (``--service-bug rotate_tiebreak | greedy_rebalance |
full_reshuffle``). ``shardkv-fuzz`` fuzzes the multi-group sharded kv
service (G raft groups a deployment, the pre-drawn config schedule, shard
migration with pulls, installs and GC, the truth walker and the shardkv
oracles; ``--service-bug skip_freeze | drop_dup_table | serve_frozen``),
or with ``--live-ctrler`` its configs' announces through a replicated
controller raft cluster (``--service-bug stale_ctrler_read``), or with
``--computed-ctrler`` its configs computed by the controller's 4A
rebalance (``--service-bug rotate_tiebreak``); both flags at once exit 2.
``--metrics`` turns on the on-device metrics plane (submit->commit latency
histograms, phase attribution, the worst op, event counters); ``stats``
merges and renders the metrics of any mix of those outputs on the host.
Runs go to the CUDA card unless ``--platform cpu`` is given; without a
card the run fails rather than fall back. Exit codes: 0 clean, 1 violation
found (or a failed ``--check-deterministic``), 2 usage error (``stats``:
input without metrics). The JAX CLI's other verbs, and the flags of paths
not ported yet (``--mesh``, pool's ``--devices N>1``, ``--heartbeat``,
``--digest-every``, ``stats --follow``, ``explain --heartbeat``), exit 2
naming the ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NOT_PORTED_VERBS = ("bridge", "lint")


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
    if args.metrics:
        cfg = cfg.replace(metrics=True)
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


def _violation_union(rep) -> int:
    """OR of every violation bitmask in the report (a report with
    per-group ``raft_violations`` included), as the reference's."""
    import numpy as np

    union = 0
    for field in ("violations", "raft_violations"):
        v = np.asarray(getattr(rep, field, np.zeros(0, np.int64))).ravel()
        if v.size:
            union |= int(np.bitwise_or.reduce(v))
    return union


def _axis_blocks(rep) -> dict:
    """The per-key / per-client latency blocks of a kv report (the
    reference's ``by_key`` / ``by_client``): a row with acked ops, and a
    client with retries even at zero ops, each with its ``retries``."""
    from madraft_tpu_torch.tpusim.metrics import latency_summary

    out = {}
    retries = getattr(rep, "client_retries", None)
    r = retries.sum(axis=0) if retries is not None else None
    for field, key in (("key_hist", "by_key"), ("client_hist", "by_client")):
        axes = getattr(rep, field, None)
        if axes is None:
            continue
        merged = axes.sum(axis=0)  # [rows, HB]
        want_c = key == "by_client" and r is not None
        out[key] = {
            str(k): latency_summary(merged[k])
            for k in range(merged.shape[0])
            if merged[k].sum() or (want_c and r[k])
        }
        if want_c:
            for k, d in out[key].items():
                d["retries"] = int(r[int(k)])
    return out


def _report_json(rep, extra=None):
    from madraft_tpu_torch.tpusim.config import violation_names

    bad = rep.violating_clusters()
    out = {
        "violating": int(rep.n_violating),
        "violating_clusters": [int(c) for c in bad[:16]],
        "violating_clusters_total": int(bad.size),
        "violation_names": violation_names(_violation_union(rep)),
    }
    for f in rep._fields:
        v = getattr(rep, f)
        # the metric rows (2-d, or None) get decoded blocks below
        if v is None or getattr(v, "ndim", 0) > 1:
            continue
        if hasattr(v, "mean"):
            out[f"{f}_mean"] = round(float(v.mean()), 2)
    if rep.lat_hist is not None:
        # rows merge across clusters by plain addition
        from madraft_tpu_torch.tpusim.metrics import (
            event_summary,
            latency_summary,
            merge_worst_registers,
            phases_summary,
        )

        out["latency"] = latency_summary(rep.lat_hist.sum(axis=0))
        out["latency"]["phases"] = phases_summary(
            rep.phase_hist.sum(axis=0), rep.phase_ticks.sum(axis=0))
        out["latency"]["ticks_total"] = int(rep.lat_ticks.sum())
        out["latency"].update(_axis_blocks(rep))
        out["worst_op"] = merge_worst_registers(
            rep.worst_lat, rep.worst_phases, rep.worst_key,
            rep.worst_client, rep.worst_sub)
        out["events"] = event_summary(rep.ev_counts.sum(axis=0))
    if extra:
        out.update(extra)
    print(json.dumps(out))


def _finish_fuzz(args, fn, rep_fn) -> int:
    """Set up and run the fuzz program ``fn`` (timed), optionally run it
    again for the determinism check, print the JSON report with the run's
    telemetry; the exit code (1 on a violation or a failed check)."""
    from madraft_tpu_torch.tpusim.engine import run_telemetry

    rep, tele = run_telemetry(fn, rep_fn, args.seed,
                              args.clusters * args.ticks,
                              n_lanes=args.clusters)

    def rerun():
        return rep_fn(fn(args.seed))

    extra, det_failed = _det_check(args, rep, rerun)
    _report_json(rep, {"seed": args.seed, "telemetry": tele, **extra})
    return 1 if (rep.n_violating or det_failed) else 0


def cmd_fuzz(args) -> int:
    from madraft_tpu_torch.tpusim.engine import make_fuzz_fn, report

    if args.mesh:
        _usage_error("fuzz: --mesh is not ported yet (ROADMAP A6)")
    cfg = _sim_config(args)
    try:
        fn = make_fuzz_fn(cfg, args.clusters, args.ticks, device=_device(args))
    except ValueError as e:
        _usage_error(f"fuzz: {e}")
    return _finish_fuzz(args, fn, report)


def _service_bugs(cfg_cls) -> set:
    """A service layer's planted-bug names, from its config dataclass's
    ``bug_*`` fields."""
    import dataclasses

    return {f.name[len("bug_"):] for f in dataclasses.fields(cfg_cls)
            if f.name.startswith("bug_")}


def _with_service_bug(kcfg, name):
    """Set the layer's planted-bug knob named by --service-bug ('' =
    none); an unknown name exits with the valid list, in the reference's
    words."""
    if not name:
        return kcfg
    known = _service_bugs(type(kcfg))
    if name not in known:
        raise SystemExit(
            f"unknown service bug {name!r}; this layer knows: {sorted(known)}"
        )
    return kcfg.replace(**{f"bug_{name}": True})


def cmd_kv_fuzz(args) -> int:
    from madraft_tpu_torch.tpusim.kv import KvConfig, kv_report, make_kv_fuzz_fn

    if args.mesh:
        _usage_error("kv-fuzz: --mesh is not ported yet (ROADMAP A6)")
    cfg = _sim_config(args).replace(
        p_client_cmd=0.0, compact_at_commit=False, compact_every=16)
    kcfg = _with_service_bug(
        KvConfig(p_get=args.p_get, p_put=args.p_put,
                 p_follow_hint=args.p_follow_hint,
                 retry_wait=args.retry_wait),
        args.service_bug)
    try:
        fn = make_kv_fuzz_fn(cfg, kcfg, args.clusters, args.ticks,
                             device=_device(args))
    except ValueError as e:
        _usage_error(f"kv-fuzz: {e}")
    return _finish_fuzz(args, fn, kv_report)


def cmd_ctrler_fuzz(args) -> int:
    from madraft_tpu_torch.tpusim.ctrler import (
        CtrlerConfig,
        ctrler_report,
        make_ctrler_fuzz_fn,
    )

    if args.mesh:
        _usage_error("ctrler-fuzz: --mesh is not ported yet (ROADMAP A6)")
    cfg = _sim_config(args).replace(
        p_client_cmd=0.0, compact_at_commit=False, log_cap=32,
        compact_every=8)
    kcfg = _with_service_bug(
        CtrlerConfig(p_query=args.p_query, p_move=args.p_move),
        args.service_bug)
    try:
        fn = make_ctrler_fuzz_fn(cfg, kcfg, args.clusters, args.ticks,
                                 device=_device(args))
    except ValueError as e:
        _usage_error(f"ctrler-fuzz: {e}")
    return _finish_fuzz(args, fn, ctrler_report)


def cmd_shardkv_fuzz(args) -> int:
    from madraft_tpu_torch.tpusim.config import SimConfig
    from madraft_tpu_torch.tpusim.shardkv import (
        ShardKvConfig,
        make_shardkv_fuzz_fn,
        shardkv_report,
    )

    if args.mesh:
        _usage_error("shardkv-fuzz: --mesh is not ported yet (ROADMAP A6)")
    # the reference builds this verb's SimConfig from scratch: it owns the
    # fault shape
    cfg = SimConfig(
        n_nodes=args.nodes, p_client_cmd=0.0, compact_at_commit=False,
        log_cap=64, compact_every=16,
        loss_prob=0.1 if args.storm else 0.05,
        p_crash=0.01 if args.storm else 0.0,
        p_restart=0.2, max_dead=1 if args.storm else 0,
        bug=args.bug, metrics=args.metrics,
    )
    # the controller-mode bugs without their mode, in the reference's words
    if args.service_bug == "stale_ctrler_read" and not args.live_ctrler:
        raise SystemExit(
            "--service-bug stale_ctrler_read needs --live-ctrler: the bug "
            "lives in the query path to the on-device replicated controller"
        )
    if args.service_bug == "rotate_tiebreak" and not args.computed_ctrler:
        raise SystemExit(
            "--service-bug rotate_tiebreak needs --computed-ctrler: the bug "
            "rotates each controller replica's rebalance order, which only "
            "exists when config content is computed on-device"
        )
    # both modes at once: the config's own check (the reference lets its
    # ValueError escape), as a usage error
    try:
        kcfg = ShardKvConfig(p_get=args.p_get, p_put=args.p_put,
                             live_ctrler=args.live_ctrler,
                             computed_ctrler=args.computed_ctrler)
    except ValueError as e:
        _usage_error(f"shardkv-fuzz: {e}")
    kcfg = _with_service_bug(kcfg, args.service_bug)
    try:
        fn = make_shardkv_fuzz_fn(cfg, kcfg, args.clusters, args.ticks,
                                  device=_device(args))
    except ValueError as e:
        _usage_error(f"shardkv-fuzz: {e}")
    return _finish_fuzz(args, fn, shardkv_report)


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


def cmd_explain(args) -> int:
    """Flight-recorder replay of ONE cluster: its decoded event timeline
    (JSONL: a header, then the events within --window ticks of the first
    violation) or a Perfetto-loadable chrome trace. A debugging tool, not
    a checker: exit 0 whenever the replay ran, violations or not."""
    from madraft_tpu_torch.tpusim.config import violation_names
    from madraft_tpu_torch.tpusim.trace import (
        chrome_trace,
        decode_events,
        events_in_window,
        replay_cluster_traced,
    )

    if args.heartbeat:
        _usage_error("explain: --heartbeat (the pool's host timeline) is not "
                     "ported yet (ROADMAP A15)")
    if args.cluster is None:
        _usage_error("explain: --cluster is required (or --heartbeat PATH for "
                     "the pool host timeline)")
    cfg = _sim_config(args)
    knobs = _knobs_json("explain", args.knobs_json)
    dev = _device(args)
    try:
        final, rec = replay_cluster_traced(cfg, args.seed, args.cluster,
                                           args.ticks, knobs=knobs,
                                           device=dev)
    except ValueError as e:
        _usage_error(f"explain: {e}")
    events = decode_events(rec)
    viol = int(final.violations[0])
    fvt = int(final.first_violation_tick[0])
    header = {
        "seed": args.seed,
        "cluster": args.cluster,
        "ticks": args.ticks,
        **_state_schema(cfg, knobs, args.ticks, dev),
        "violations": viol,
        "violation_names": violation_names(viol),
        "first_violation_tick": fvt,
        "committed": int(final.shadow_len[0]),
        "events_total": len(events),
    }
    if args.format == "chrome":
        doc = chrome_trace(
            rec, cfg.ms_per_tick, events,
            label=f"madtpu cluster {args.cluster} seed {args.seed}",
        )
        text = json.dumps(doc)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
            header["trace_file"] = args.out
            header["trace_events"] = len(doc["traceEvents"])
            print(json.dumps(header))
        else:
            print(text)
        return 0
    shown = events_in_window(events, fvt if fvt >= 0 else None, args.window)
    header["window"] = args.window
    header["events_shown"] = len(shown)
    print(json.dumps(header))
    for e in shown:
        print(json.dumps(e))
    return 0


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
    ccfg = None
    if not args.coverage and (args.coverage_random
                              or args.coverage_bits is not None):
        # a modifier ignored in silence would run the plain pool
        usage_error(
            "--coverage-random/--coverage-bits modify --coverage — add "
            "--coverage (or drop them)"
        )
    if args.coverage:
        from madraft_tpu_torch.tpusim.config import CoverageConfig

        bits = {} if args.coverage_bits is None else \
            {"bitmap_bits": args.coverage_bits}
        try:
            ccfg = CoverageConfig(guided=not args.coverage_random, **bits)
        except ValueError as e:  # e.g. --coverage-bits 100
            usage_error(str(e))
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
        on_retired=on_retired, coverage=ccfg, device=dev,
    )
    summary.update({
        "seed": args.seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "backend": dev.type,
    })
    if "latency" in summary:
        # the client experience in one line, on stderr so stdout stays JSONL
        lat = summary["latency"]
        print(
            f"pool: latency p50={lat['p50_ticks']} p99={lat['p99_ticks']} "
            f"ticks over {lat['ops']} ops; "
            f"{summary['violations_per_s']} violations/s",
            file=sys.stderr,
        )
    print(json.dumps(summary))
    return 1 if summary["retired_violating"] else 0


def cmd_sweep(args) -> int:
    """Fault-parameter grid (engine.make_sweep_fn): the cartesian product
    of --loss x --crash x --repartition tiles across the cluster batch,
    each cluster under its cell's knob row; per-cell safety and liveness
    are reported. Grids of up to engine.SWEEP_UNIFORM_MAX_CELLS cells run
    cell by cell (``dispatch`` "uniform"), larger ones as one batch of
    knob rows ("per_cluster")."""
    import itertools

    import torch

    from madraft_tpu_torch.tpusim.engine import (
        make_sweep_fn,
        report,
        run_telemetry,
    )

    if args.mesh:
        _usage_error("sweep: --mesh is not ported yet (ROADMAP A6)")
    cfg = _sim_config(args)
    try:
        axes = {
            "loss_prob": [float(x) for x in args.loss.split(",")],
            "p_crash": [float(x) for x in args.crash.split(",")],
            "p_repartition": [float(x) for x in args.repartition.split(",")],
        }
    except ValueError as e:
        _usage_error(f"sweep: {e}")
    combos = list(itertools.product(*axes.values()))
    per = args.clusters // len(combos)
    if per == 0:
        _usage_error(f"sweep: --clusters {args.clusters} < {len(combos)} "
                     "grid cells")
    n = per * len(combos)
    if any(c[1] > 0 for c in combos) and cfg.max_dead == 0:
        # crash cells are inert without a dead-node budget + restarts
        cfg = cfg.replace(max_dead=2, p_restart=max(cfg.p_restart, 0.2))
    if any(c[2] > 0 for c in combos) and cfg.p_heal == 0.0:
        cfg = cfg.replace(p_heal=0.05)
    dev = _device(args)

    def tile(i):
        return torch.tensor([c[i] for c in combos],
                            dtype=torch.float32).repeat_interleave(per)

    kn = cfg.knobs()._replace(**{name: tile(i) for i, name in enumerate(axes)})
    try:
        fn = make_sweep_fn(cfg, kn, n, args.ticks, device=dev)
    except ValueError as e:
        _usage_error(f"sweep: {e}")

    rep, tele = run_telemetry(fn, report, args.seed, n * args.ticks,
                              n_lanes=n)

    def rerun():
        return report(fn(args.seed))

    extra, det_failed = _det_check(args, rep, rerun)
    extra["telemetry"] = tele
    cells = []
    for i, c in enumerate(combos):
        sl = slice(i * per, (i + 1) * per)
        cells.append({
            "loss": c[0], "crash": c[1], "repartition": c[2],
            "clusters": per,
            "violating": int((rep.violations[sl] != 0).sum()),
            "live": int((rep.committed[sl] > 0).sum()),
            "committed_mean": round(float(rep.committed[sl].mean()), 1),
        })
    print(json.dumps({
        "violating": int(rep.n_violating),
        # --clusters rounded down to a multiple of the cell count
        "clusters_run": n,
        "dispatch": fn.dispatch,
        "cells": cells,
        "seed": args.seed,
        **extra,
    }))
    return 1 if (rep.n_violating or det_failed) else 0


class _StatsMerge:
    """What ``stats`` pulls out of its input streams: the merged latency
    histogram and event counters, the per-stream source counts (so the
    exit-2 message names the inputs that carried nothing), phase rows
    merged by name, the per-key/per-client axes, the worst op, and each
    stream's last heartbeat row."""

    def __init__(self, hist_buckets: int, n_events: int):
        import numpy as np

        self.hist = np.zeros(hist_buckets, np.int64)
        self.events = np.zeros(n_events, np.int64)
        self.seen = 0
        self.seen_per_stream: list = []
        self.phases: dict = {}    # name -> (hist row, ticks_total)
        self.by_key: dict = {}    # key -> hist row
        self.by_client: dict = {}  # client -> hist row
        self.worst = None
        self.live_per_stream: list = []
        self.paths: list = []


def _merge_axis(table: dict, key, hist_row) -> None:
    import numpy as np

    row = np.asarray(hist_row, np.int64)
    table[key] = table[key] + row if key in table else row


def _collect_stats(streams) -> _StatsMerge:
    """Merge every histogram and counter of the metrics plane found in
    report JSON streams (one list of lines per input): fuzz reports and
    pool summaries ({"latency": {...}, "events": {...}}), pool JSONL rows
    ({"latency_hist": [...], "events": {...}}) and heartbeat rows. All of
    it merges by addition over the fixed buckets; phase rows and the
    key/client axes merge by name; worst ops by ``merge_worst``. A pool
    stream holds both its rows and a summary that already merged them, so
    within one stream a summary-level "latency" suppresses the bare row
    columns (a rows-only stream still merges in full)."""
    import numpy as np

    from madraft_tpu_torch.tpusim.config import HIST_BUCKETS, METRIC_EVENTS
    from madraft_tpu_torch.tpusim.metrics import merge_worst

    m = _StatsMerge(HIST_BUCKETS, len(METRIC_EVENTS))
    for lines in streams:
        docs = []
        for raw in lines:
            raw = raw.strip()
            if not raw:
                continue
            try:
                doc = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict):
                docs.append(doc)
        use_rows = not any(
            isinstance(d.get("latency"), dict) and d["latency"].get("hist")
            for d in docs
        )
        stream_seen = 0
        last_hb = None
        for doc in docs:
            if doc.get("hb") == 1:
                # a heartbeat row: its window histograms sum to the run's
                last_hb = doc
                hlat = (doc.get("det") or {}).get("latency")
                m.seen += 1
                stream_seen += 1
                if isinstance(hlat, dict) and hlat.get("hist_w") and \
                        len(hlat["hist_w"]) == HIST_BUCKETS:
                    m.hist += np.asarray(hlat["hist_w"], np.int64)
                    for name, t in (hlat.get("phase_ticks_w") or {}).items():
                        old_h, old_t = m.phases.get(
                            name, (np.zeros(HIST_BUCKETS, np.int64), 0))
                        m.phases[name] = (old_h, old_t + int(t))
                continue
            lat = doc.get("latency")
            row_hist = None
            row_phases = None
            from_summary = False
            if isinstance(lat, dict) and lat.get("hist"):
                row_hist = lat["hist"]
                from_summary = True
                if isinstance(lat.get("phases"), dict):
                    row_phases = {
                        name: (d.get("hist"), d.get("ticks_total", 0))
                        for name, d in lat["phases"].items()
                        if isinstance(d, dict)
                    }
            elif use_rows and doc.get("latency_hist"):
                row_hist = doc["latency_hist"]
                if isinstance(doc.get("latency_phases"), dict):
                    # rows carry no exact tick totals: ticks_total 0
                    row_phases = {
                        name: (h, 0)
                        for name, h in doc["latency_phases"].items()
                    }
            # an events-only report still merges; a pool row suppressed by
            # its stream's summary contributes nothing
            ev_only = (
                "latency_hist" not in doc
                and not isinstance(lat, dict)
                and isinstance(doc.get("events"), dict)
            )
            if row_hist is None and not ev_only:
                continue
            m.seen += 1
            stream_seen += 1
            if row_hist is not None and len(row_hist) == HIST_BUCKETS:
                m.hist += np.asarray(row_hist, np.int64)
            if row_phases:
                for name, (h, ticks) in row_phases.items():
                    if h is None or len(h) != HIST_BUCKETS:
                        continue
                    old_h, old_t = m.phases.get(
                        name, (np.zeros(HIST_BUCKETS, np.int64), 0))
                    m.phases[name] = (old_h + np.asarray(h, np.int64),
                                      old_t + int(ticks))
            if from_summary or use_rows:
                for src, table in (("by_key", m.by_key),
                                   ("by_client", m.by_client)):
                    ax = lat.get(src) if isinstance(lat, dict) else None
                    if isinstance(ax, dict):
                        for k, d in ax.items():
                            if isinstance(d, dict) and d.get("hist"):
                                _merge_axis(table, str(k), d["hist"])
                w = doc.get("worst_op")
                if isinstance(w, dict):
                    # a pool row's cluster id rides the row, not the dict
                    m.worst = merge_worst(m.worst, w,
                                          b_id=doc.get("cluster_id"))
            row_ev = doc.get("events")
            if isinstance(row_ev, dict):
                for i, name in enumerate(METRIC_EVENTS):
                    m.events[i] += int(row_ev.get(name, 0))
        m.seen_per_stream.append(stream_seen)
        m.live_per_stream.append(last_hb)
    return m


def _top_axis(table: dict, top: int) -> list:
    """The top-N rows of a per-key/per-client axis, worst p99 first."""
    from madraft_tpu_torch.tpusim.metrics import latency_summary

    rows = [(k, latency_summary(h)) for k, h in table.items()]
    rows.sort(key=lambda kv: (-(kv[1]["p99_ticks"] or 0), -kv[1]["ops"]))
    return rows[:top]


def _print_stats(args, m: _StatsMerge, lat: dict) -> None:
    from madraft_tpu_torch.tpusim.config import METRIC_EVENTS
    from madraft_tpu_torch.tpusim.metrics import (
        latency_summary,
        render_histogram,
    )

    print(f"sources merged: {m.seen}")
    for p, hbr in zip(m.paths, m.live_per_stream):
        if hbr is None:
            continue
        # a heartbeat stream's newest row: counters, then wall-clock parts
        det, t = hbr.get("det", {}), hbr.get("t", {})
        bits = [f"gen {hbr.get('gen')}"]
        if hbr.get("lane_ticks") is not None:
            bits.append(f"lane_ticks {hbr['lane_ticks']}")
        if det.get("retired") is not None:
            bits.append(f"retired {det['retired']} "
                        f"({det.get('violating', 0)} violating)")
        if det.get("new_fps") is not None:
            bits.append(f"fingerprints {det['new_fps']}")
        if t.get("budget_frac") is not None:
            bits.append(f"{100.0 * t['budget_frac']:.0f}% of budget")
        if t.get("wall_s") is not None:
            bits.append(f"wall {t['wall_s']}s")
        state = "final" if hbr.get("final") else "live"
        name = "stdin" if p == "-" else p
        print(f"pool {name} [{state}]: " + " · ".join(bits))
    print(f"latency: ops={lat['ops']} p50={lat['p50_ticks']} "
          f"p99={lat['p99_ticks']} (ticks; log-spaced buckets, quantile = "
          f"bucket upper edge)")
    for line in render_histogram(m.hist):
        print(line)
    if m.phases:
        # share = the phase's exact tick total over all phases' (0 when
        # the inputs were raw rows without tick totals)
        total_ticks = sum(t for _, t in m.phases.values())
        print("phases (sum of phase durations == e2e latency, per op):")
        width = max(len(n) for n in m.phases)
        for name, (h, ticks) in m.phases.items():
            d = latency_summary(h)
            share = (f"  {100.0 * ticks / total_ticks:5.1f}% of ticks"
                     if total_ticks else "")
            print(f"  {name:<{width}}  ops={d['ops']:>8}  "
                  f"p50={str(d['p50_ticks']):>6} p99={str(d['p99_ticks']):>6}"
                  f"{share}")
    for flag, label, table in (("by_key", "key", m.by_key),
                               ("by_client", "client", m.by_client)):
        if getattr(args, flag, False) and table:
            print(f"top {label}s by p99:")
            for k, d in _top_axis(table, args.top):
                print(f"  {label} {k:>4}  ops={d['ops']:>8}  "
                      f"p50={str(d['p50_ticks']):>6} "
                      f"p99={str(d['p99_ticks']):>6}")
    if m.worst is not None:
        ph = ", ".join(f"{k}={v}" for k, v in m.worst["phases"].items()
                       if v)
        print(f"worst op: {m.worst['latency_ticks']} ticks "
              f"(submit tick {m.worst['submit_tick']}, "
              f"key {m.worst['key']}, client {m.worst['client']}"
              + (f", cluster {m.worst['cluster_id']}"
                 if "cluster_id" in m.worst else "")
              + f") — {ph or 'all phases 0'}")
    if m.events.any():
        print("events:")
        width = max(len(n) for n in METRIC_EVENTS)
        for i, name in enumerate(METRIC_EVENTS):
            print(f"  {name:<{width}}  {int(m.events[i])}")
    if args.json:
        doc = {
            "sources": m.seen,
            "latency": lat,
            "events": {n: int(m.events[i])
                       for i, n in enumerate(METRIC_EVENTS)},
        }
        if m.phases:
            doc["latency"]["phases"] = {
                name: {**latency_summary(h), "ticks_total": int(t)}
                for name, (h, t) in m.phases.items()
            }
        if m.by_key:
            doc["latency"]["by_key"] = {
                k: latency_summary(h) for k, h in m.by_key.items()}
        if m.by_client:
            doc["latency"]["by_client"] = {
                k: latency_summary(h) for k, h in m.by_client.items()}
        if m.worst is not None:
            doc["worst_op"] = m.worst
        print(json.dumps(doc))


def cmd_stats(args) -> int:
    """Render the metrics plane of report artifacts: a fuzz report, a pool
    summary and its JSONL rows, or any mix of files (or stdin). Merges
    every histogram and counter it finds and prints the latency
    distribution, p50/p99, the phase table, the worst op and the event
    counters. Exit 0 when metrics were found, 2 when the inputs carry none
    (naming them)."""
    from madraft_tpu_torch.tpusim.metrics import latency_summary

    if args.follow:
        _usage_error("stats: --follow is not ported yet (ROADMAP A15)")
    paths = args.inputs or ["-"]
    streams = []
    for path in paths:
        if path == "-":
            streams.append(sys.stdin.read().splitlines())
        else:
            try:
                with open(path) as f:
                    streams.append(f.read().splitlines())
            except OSError as e:
                _usage_error(f"stats: {e}")
    m = _collect_stats(streams)
    m.paths = list(paths)
    empty = [p for p, n in zip(paths, m.seen_per_stream) if n == 0]
    which = ", ".join("stdin" if p == "-" else p for p in empty)
    if not m.seen:
        print(f"stats: no metrics found in: {which} — was the run made "
              "with --metrics?", file=sys.stderr)
        return 2
    if empty:
        print(f"stats: warning: no metrics blocks in: {which} (merged the "
              f"other {m.seen} source(s))", file=sys.stderr)
    try:
        _print_stats(args, m, latency_summary(m.hist))
    except BrokenPipeError:  # e.g. `stats ... | head`
        pass
    return 0


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
                        help="on-device metrics plane: per-lane "
                             "submit->commit latency histograms, phase "
                             "attribution, the worst op and liveness-event "
                             "counters; reports gain latency, events and "
                             "worst_op")
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

    def service_common(sp, clusters=512):
        common(sp, clusters)
        sp.add_argument("--mesh", action="store_true",
                        help="shard over all devices (not ported yet: exits "
                             "2)")
        sp.add_argument("--check-deterministic", action="store_true",
                        help="run twice, demand a bit-identical report (also "
                             "enabled by MADTPU_TEST_CHECK_DETERMINISTIC)")
        sp.add_argument("--service-bug", default="",
                        help="plant one of this layer's service bugs (an "
                             "unknown name lists the valid set)")

    sp = sub.add_parser("kv-fuzz", help="KV service fuzz (Lab 3)")
    service_common(sp)
    sp.add_argument("--p-get", type=float, default=0.3)
    sp.add_argument("--p-put", type=float, default=0.2)
    sp.add_argument("--p-follow-hint", type=float, default=0.0,
                    help="prob a clerk targets its believed leader (the "
                         "NotLeader{hint} model) instead of a random node; "
                         "0 = random routing")
    sp.add_argument("--retry-wait", type=int, default=0,
                    help="ticks a clerk pauses after a submit landed at a "
                         "leader (the call-timeout pacing)")
    sp.set_defaults(fn=cmd_kv_fuzz)

    sp = sub.add_parser(
        "ctrler-fuzz", help="shard-controller config service (Lab 4A)")
    service_common(sp)
    sp.add_argument("--p-query", type=float, default=0.3)
    sp.add_argument("--p-move", type=float, default=0.1)
    sp.set_defaults(fn=cmd_ctrler_fuzz)

    sp = sub.add_parser("shardkv-fuzz",
                        help="multi-group sharded KV (Lab 4B)")
    service_common(sp, 64)
    sp.add_argument("--p-get", type=float, default=0.3)
    sp.add_argument("--p-put", type=float, default=0.2)
    sp.add_argument("--live-ctrler", action="store_true",
                    help="configs ride an on-device replicated controller "
                         "raft cluster (announce/query protocol) instead of "
                         "the schedule tensor")
    sp.add_argument("--computed-ctrler", action="store_true",
                    help="the controller cluster's apply machine IS the 4A "
                         "state machine: membership flips ride its raft and "
                         "config content is computed by the shared 4A "
                         "rebalance (supersedes --live-ctrler)")
    sp.set_defaults(fn=cmd_shardkv_fuzz)

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
                    help="coverage-guided pool: every tick each lane's "
                         "abstract-state fingerprint updates an on-device "
                         "seen-set, and retiring lanes that found new "
                         "fingerprints respawn with mutated storm knobs "
                         "(rows gain new_fingerprints/refill/knobs, the "
                         "summary a coverage dict)")
    sp.add_argument("--coverage-bits", type=int, default=None,
                    help="seen-set size in bits (power of two, default "
                         "65536)")
    sp.add_argument("--coverage-random", action="store_true",
                    help="with --coverage: count coverage but refill at "
                         "the base knobs (the random baseline)")
    sp.add_argument("--heartbeat", default="",
                    help="live-telemetry stream (not ported yet: exits 2)")
    sp.add_argument("--digest-every", type=int, default=0,
                    help="progress digest (not ported yet: exits 2)")
    sp.set_defaults(fn=cmd_pool)

    sp = sub.add_parser(
        "sweep", help="fault-parameter grid, a knob row per cluster "
                      "(per-cell report)"
    )
    common(sp, 4096)
    sp.add_argument("--mesh", action="store_true",
                    help="shard over all devices (not ported yet: exits 2)")
    sp.add_argument("--check-deterministic", action="store_true",
                    help="run twice, demand a bit-identical report (also "
                         "enabled by MADTPU_TEST_CHECK_DETERMINISTIC)")
    sp.add_argument("--loss", default="0,0.1,0.3",
                    help="comma list of loss_prob values")
    sp.add_argument("--crash", default="0,0.02",
                    help="comma list of p_crash values")
    sp.add_argument("--repartition", default="0,0.05",
                    help="comma list of p_repartition values")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("replay", help="re-run ONE cluster exactly")
    common(sp, 1)
    sp.add_argument("--cluster", type=int, required=True)
    sp.add_argument("--knobs-json", default="",
                    help="JSON object of dynamic-knob overrides (field -> "
                         "value): a coverage pool row's \"knobs\" replays "
                         "that lane bit-exactly")
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser(
        "explain",
        help="flight-recorder replay of ONE cluster: decoded event timeline "
             "(JSONL) around the first violation, or a Perfetto export",
    )
    common(sp, 1)
    sp.add_argument("--cluster", type=int, default=None,
                    help="cluster id to replay (required)")
    sp.add_argument("--heartbeat", default="",
                    help="the pool host timeline (not ported yet: exits 2)")
    sp.add_argument("--window", type=int, default=60,
                    help="+-ticks around first_violation_tick to print "
                         "(<= 0 = the full timeline; violation events are "
                         "always shown)")
    sp.add_argument("--format", default="jsonl", choices=["jsonl", "chrome"],
                    help="jsonl = header line + one event per line; chrome "
                         "= Perfetto/chrome://tracing trace JSON (one track "
                         "per node: role spans + instant events)")
    sp.add_argument("--out", default="",
                    help="with --format chrome: write the trace JSON to "
                         "this file (a summary line goes to stdout)")
    sp.add_argument("--knobs-json", default="",
                    help="JSON object of dynamic-knob overrides: a coverage "
                         "pool row's \"knobs\" decodes that lane's run")
    sp.set_defaults(fn=cmd_explain)

    sp = sub.add_parser(
        "stats",
        help="render the metrics plane of any report artifact: merges the "
             "latency histograms and event counters found in fuzz reports, "
             "pool summaries and pool JSONL rows (files or stdin), prints "
             "the distribution, p50/p99 and the counter table",
    )
    sp.add_argument("inputs", nargs="*", metavar="FILE",
                    help="report/JSONL files to merge ('-' or none = stdin)")
    sp.add_argument("--json", action="store_true",
                    help="also print the merged digest as one JSON line")
    sp.add_argument("--by-key", action="store_true", dest="by_key",
                    help="the top-N per-key latency rows (reports with a "
                         "per-key axis)")
    sp.add_argument("--by-client", action="store_true", dest="by_client",
                    help="the top-N per-client latency rows")
    sp.add_argument("--top", type=int, default=5,
                    help="N for --by-key/--by-client (default 5)")
    sp.add_argument("--follow", action="store_true",
                    help="tail live heartbeat inputs (not ported yet: "
                         "exits 2)")
    sp.set_defaults(fn=cmd_stats)

    args = p.parse_args(argv)
    if args.cmd == "stats":  # a host-side renderer: no device, no config
        return args.fn(args)
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
    try:
        return args.fn(args)
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            return e.code or 0
        # a message, as Python's own exit prints it: on stderr, status 1
        print(e.code, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
