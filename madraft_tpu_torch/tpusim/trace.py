"""Flight recorder: per-tick replay traces for one cluster.

The twin of ``madraft_tpu/tpusim/trace.py`` (its docstring gives the
design). ``replay_cluster_traced`` re-runs one cluster from its (seed,
cluster_id) stream, as ``engine.replay_cluster`` does, and records every
tick: a ``TickRecord`` of the post-tick node rows, the tick's exact
per-type delivery counts (derived from the pre-tick mailbox stamps and the
post-tick liveness and links, without touching the tick), the install
outcomes, the cluster-wide scalars and, with the metrics plane, its
leaves (zero-size when it is off). The host then decodes the stacked
records into an event timeline (``decode_events``), a window of it around
the first violation (``events_in_window``) or a Perfetto trace
(``chrome_trace``).

On the card the replay ticks the wide state with K6-trace: launches of up
to ``engine.KERNEL_CHUNK`` ticks (``kernels/tick.py`` with ``trace``;
K6-metrics with ``cfg.metrics``) that write each tick's row, K8's row
(``kernels/trace.py``), into a device buffer [T, 1, W], which the host
copies once at the end; on the CPU the eager tick and K8's plain
version. The contract is the reference's: the
traced final state equals ``replay_cluster``'s bit for bit (the same tick
on the same stream; the packed carry is exact, so the port ticks the wide
state throughout).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels import trace as K8
from madraft_tpu_torch.tpusim.config import (
    LEADER,
    METRIC_EVENTS,
    SimConfig,
    phase_names,
    violation_names,
)
from madraft_tpu_torch.tpusim.state import ClusterState, init_cluster
from madraft_tpu_torch.tpusim.step import step_cluster

ROLE_NAMES = ("follower", "candidate", "leader")
_DEAD = 3  # pseudo-role for Perfetto spans


class TickRecord(NamedTuple):
    """One cluster's trace: per-tick post-state rows and deliveries, host
    numpy arrays with a leading [n_ticks] axis (the reference's fields,
    shapes and dtypes; ``kernels.trace.field_shapes`` gives the per-tick
    shapes). The metric fields have zero size with metrics off."""

    # --- per-node post-tick state [n] ---
    role: np.ndarray
    term: np.ndarray
    commit: np.ndarray
    log_len: np.ndarray
    base: np.ndarray            # snapshot boundary
    durable_len: np.ndarray     # fsync watermark
    alive: np.ndarray           # bool
    adj_mask: np.ndarray        # i32 row bitmask: bit s of row d = link s->d up
    # --- exact per-type delivery counts this tick (i32 scalars) ---
    rv_req_delivered: np.ndarray
    rv_rsp_delivered: np.ndarray
    ae_req_delivered: np.ndarray
    ae_rsp_delivered: np.ndarray
    snap_delivered: np.ndarray
    # --- install-snapshot outcomes [n] ---
    snap_installed_src: np.ndarray   # -1 = none this tick
    snap_installed_len: np.ndarray
    # --- cluster-wide scalars ---
    shadow_len: np.ndarray      # committed entries ever (durability shadow)
    msg_count: np.ndarray       # cumulative delivered messages
    violations: np.ndarray      # sticky oracle bitmask
    # --- metrics plane (zero-size with cfg.metrics off) ---
    shadow_sub: np.ndarray      # [CAP] this tick's shadow-record stamps
    lat_hist: np.ndarray        # [HIST_BUCKETS] cumulative histogram
    ev_counts: np.ndarray       # [len(METRIC_EVENTS)] cumulative counters
    phase_ticks: np.ndarray     # [n_phases] cumulative per-phase ticks
    worst_lat: np.ndarray       # [1] the worst-op register (the last
    worst_phases: np.ndarray    # [n_phases] tick's values describe the
    worst_key: np.ndarray       # [1] whole trace)
    worst_client: np.ndarray    # [1]
    worst_sub: np.ndarray       # [1]


assert TickRecord._fields == tuple(
    f for f, _ in K8.field_shapes(SimConfig())), "K8's row order drifted"


def _traced_ticks(cfg: SimConfig, state: ClusterState, keys: torch.Tensor,
                  kn, n_ticks: int, rows: torch.Tensor) -> ClusterState:
    """n_ticks ticks of ``state``, each tick's row into ``rows[i]``: on
    the card K6-trace launches of up to KERNEL_CHUNK ticks (the knob
    table built once), on the CPU the eager tick and K8's plain
    version."""
    from madraft_tpu_torch.tpusim.engine import KERNEL_CHUNK, tick_route

    if tick_route(state.tick.device) == "kernel":
        table = K6.knob_table(kn, keys.shape[0])
        for done in range(0, n_ticks, KERNEL_CHUNK):
            m = min(KERNEL_CHUNK, n_ticks - done)
            state = K6.tick_chunk(cfg, state, keys, kn, m, table,
                                  trace=rows[done:done + m])
        return state
    for i in range(n_ticks):
        nxt = step_cluster(cfg, state, keys, kn)
        K8.record(cfg, state, nxt, rows[i])
        state = nxt
    return state


def traced_rows(cfg: SimConfig, seed: int, cluster_id: int, n_ticks: int,
                knobs=None, device=None) -> tuple:
    """``replay_cluster_traced``'s run without the decode: (final state,
    the rows int32 [n_ticks, 1, W] on the run's device)."""
    from madraft_tpu_torch.tpusim.engine import (
        check_card_shape,
        cluster_keys,
        resolve_device,
        resolve_knobs,
    )

    dev = resolve_device(device)
    check_card_shape(dev, cfg)
    kn = resolve_knobs(cfg, knobs, dev)
    keys = cluster_keys(seed, 1, dev, id0=int(cluster_id))
    rows = torch.empty((int(n_ticks), 1, K8.record_width(cfg)),
                       dtype=torch.int32, device=dev)
    final = _traced_ticks(cfg, init_cluster(cfg, keys, kn), keys, kn,
                          int(n_ticks), rows)
    return final, rows


def replay_cluster_traced(cfg: SimConfig, seed: int, cluster_id: int,
                          n_ticks: int, knobs=None, device=None) -> tuple:
    """Re-run ONE cluster with the flight recorder on.

    Returns ``(final_state, trace)``: the final wide ``ClusterState``
    with a batch axis of 1, bit-identical to ``engine.replay_cluster``'s,
    and a ``TickRecord`` of host numpy arrays with a leading [n_ticks]
    axis. ``knobs``: an optional knob override (``engine.resolve_knobs``),
    e.g. a coverage-pool row's mutated knobs, so the timeline decodes the
    execution that row ran."""
    final, rows = traced_rows(cfg, seed, cluster_id, n_ticks, knobs, device)
    return final, TickRecord(**K8.decode(cfg, rows[:, 0].cpu().numpy()))


# --------------------------------------------------------------- host decode
def alive_masks(rec: TickRecord) -> np.ndarray:
    """[T] int alive bitmask per tick (bit i = node i alive) — the
    schedule-invariant signal the bridge compares across backends."""
    n = rec.alive.shape[1]
    return (rec.alive.astype(np.int64) << np.arange(n)).sum(axis=1)


def decode_events(rec: TickRecord) -> list:
    """Stacked per-tick arrays -> structured event timeline.

    Every event is a dict with at least ``tick`` (1-based, matching
    ``first_violation_tick``) and ``event``; ticks with nothing notable
    emit nothing, so a 600-tick trace decodes to a readable timeline.
    """
    T, n = rec.role.shape
    events = []
    # tick-0 baseline = init_cluster: all followers, term 0, alive, fully
    # connected, empty logs, no commits, no violations
    prev_role = np.zeros(n, np.int64)
    prev_term = np.zeros(n, np.int64)
    prev_alive = np.ones(n, bool)
    prev_adj = np.full(n, (1 << n) - 1, np.int64)
    prev_len = np.zeros(n, np.int64)
    prev_shadow = 0
    prev_viol = 0
    for ti in range(T):
        t = ti + 1
        role = rec.role[ti]
        term = rec.term[ti]
        alive = rec.alive[ti]
        adj = rec.adj_mask[ti]
        llen = rec.log_len[ti]
        for i in range(n):
            if prev_alive[i] and not alive[i]:
                lost = int(prev_len[i] - llen[i])
                ev = {"tick": t, "event": "crash", "node": i}
                if lost > 0:  # un-fsynced suffix dropped (durability axis)
                    ev["lost_suffix"] = lost
                events.append(ev)
            elif alive[i] and not prev_alive[i]:
                events.append({"tick": t, "event": "restart", "node": i,
                               "term": int(term[i])})
        if (adj != prev_adj).any():
            events.append({
                "tick": t, "event": "partition_change",
                "adj_rows": [int(r) for r in adj],
            })
        for i in range(n):
            if term[i] > prev_term[i] and alive[i]:
                events.append({
                    "tick": t, "event": "term_bump", "node": i,
                    "term": int(term[i]),
                    "role": ROLE_NAMES[int(role[i])],
                })
            if role[i] == LEADER and prev_role[i] != LEADER:
                events.append({
                    "tick": t, "event": "leader_elected", "node": i,
                    "term": int(term[i]),
                })
            elif prev_role[i] == LEADER and role[i] != LEADER and alive[i]:
                events.append({
                    "tick": t, "event": "step_down", "node": i,
                    "term": int(term[i]),
                })
        for i in range(n):
            src = int(rec.snap_installed_src[ti][i])
            if src >= 0:
                events.append({
                    "tick": t, "event": "snapshot_install", "node": i,
                    "from": src,
                    "boundary": int(rec.snap_installed_len[ti][i]),
                })
        shadow = int(rec.shadow_len[ti])
        if shadow > prev_shadow:
            ev = {
                "tick": t, "event": "commit_advance",
                "committed": shadow, "delta": shadow - prev_shadow,
            }
            if rec.shadow_sub.shape[-1]:
                # metrics trace: the commit IS the ack — attach the
                # latencies of the client entries recorded this tick,
                # host-decoded from the per-tick submit stamps (no-ops and
                # unstamped service entries carry 0 and are skipped)
                subs = rec.shadow_sub[ti]
                ev["latencies"] = sorted(
                    int(t - s) for s in subs[subs > 0]
                )
            events.append(ev)
        viol = int(rec.violations[ti])
        new_bits = viol & ~prev_viol
        if new_bits:
            events.append({
                "tick": t, "event": "violation",
                "first": prev_viol == 0,
                "new_bits": new_bits,
                "names": violation_names(new_bits),
            })
        prev_role, prev_term, prev_alive = role, term, alive
        prev_adj, prev_len = adj, llen
        prev_shadow, prev_viol = shadow, viol
    return events


def events_in_window(
    events: list, center: Optional[int], window: int
) -> list:
    """Events within ``window`` ticks of ``center`` — violation events are
    always kept (they are the reason the user is here). ``window <= 0`` or
    no center (no violation found) returns the full timeline."""
    if center is None or center < 0 or window <= 0:
        return events
    return [
        e for e in events
        if abs(e["tick"] - center) <= window or e["event"] == "violation"
    ]


# ------------------------------------------------------------ Perfetto export
def chrome_trace(
    rec: TickRecord,
    ms_per_tick: int,
    events: Optional[list] = None,
    label: str = "cluster",
) -> dict:
    """Chrome/Perfetto trace-event JSON for one traced replay: one track
    (tid) per node with role spans (follower/candidate/leader/dead),
    instant events for the decoded timeline, and counter tracks for commit
    progress and per-tick deliveries. Load in ui.perfetto.dev or
    chrome://tracing."""
    if events is None:
        events = decode_events(rec)
    T, n = rec.role.shape
    us = float(ms_per_tick) * 1000.0  # ts unit is microseconds
    out = [{"name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": label}}]
    for i in range(n):
        out.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                    "args": {"name": f"node {i}"}})
    # role spans (complete "X" events over contiguous (role|dead) runs)
    states = np.where(rec.alive, rec.role, _DEAD)  # [T, n]
    for i in range(n):
        start = 0
        for ti in range(1, T + 1):
            if ti < T and states[ti, i] == states[start, i] \
                    and (states[start, i] != LEADER
                         or rec.term[ti, i] == rec.term[start, i]):
                continue
            sid = int(states[start, i])
            name = "dead" if sid == _DEAD else ROLE_NAMES[sid]
            if sid == LEADER:
                name = f"leader t{int(rec.term[start, i])}"
            out.append({
                "name": name, "ph": "X", "pid": 0, "tid": i,
                "ts": (start + 1) * us, "dur": (ti - start) * us,
                "args": {"term": int(rec.term[start, i]),
                         "commit": int(rec.commit[start, i])},
            })
            start = ti
    # instant events from the decoded timeline
    for e in events:
        ts = e["tick"] * us
        args = {k: v for k, v in e.items() if k not in ("tick", "event")}
        if "node" in e:
            out.append({"name": e["event"], "ph": "i", "s": "t", "pid": 0,
                        "tid": e["node"], "ts": ts, "args": args})
        elif e["event"] in ("partition_change", "violation"):
            out.append({"name": e["event"], "ph": "i", "s": "p", "pid": 0,
                        "tid": 0, "ts": ts, "args": args})
    # counters: commit progress and message deliveries per tick
    prev_shadow = -1
    for ti in range(T):
        ts = (ti + 1) * us
        shadow = int(rec.shadow_len[ti])
        if shadow != prev_shadow:
            out.append({"name": "committed", "ph": "C", "pid": 0, "ts": ts,
                        "args": {"committed": shadow}})
            prev_shadow = shadow
        out.append({
            "name": "deliveries", "ph": "C", "pid": 0, "ts": ts,
            "args": {
                "rv_req": int(rec.rv_req_delivered[ti]),
                "rv_rsp": int(rec.rv_rsp_delivered[ti]),
                "ae_req": int(rec.ae_req_delivered[ti]),
                "ae_rsp": int(rec.ae_rsp_delivered[ti]),
                "snap": int(rec.snap_delivered[ti]),
            },
        })
    # metrics trace: per-tick liveness-event counter tracks from
    # the cumulative ev_counts rows (deltas — the spike view that makes a
    # latency-tail bucket's CAUSE visible in the same timeline), plus a
    # commit-latency track (max latency folded per tick) so a tail op shows
    # as a spike at its ack tick.
    if rec.ev_counts.shape[-1]:
        ev = np.asarray(rec.ev_counts, np.int64)
        deltas = np.diff(np.concatenate([np.zeros((1, ev.shape[1]),
                                                  np.int64), ev], axis=0),
                         axis=0)
        idx = {name: k for k, name in enumerate(METRIC_EVENTS)}
        for ti in range(T):
            ts = (ti + 1) * us
            out.append({
                "name": "liveness", "ph": "C", "pid": 0, "ts": ts,
                "args": {
                    "elections_won": int(deltas[ti, idx["elections_won"]]),
                    "term_bumps": int(deltas[ti, idx["term_bumps"]]),
                    "crashes": int(deltas[ti, idx["crashes"]]),
                    "restarts": int(deltas[ti, idx["restarts"]]),
                    "commit_advances": int(
                        deltas[ti, idx["commit_advances"]]
                    ),
                },
            })
            subs = rec.shadow_sub[ti]
            lat = (ti + 1) - subs[subs > 0]
            out.append({
                "name": "commit_latency_ticks", "ph": "C", "pid": 0,
                "ts": ts,
                "args": {"max": int(lat.max()) if lat.size else 0},
            })
        # attribution plane: per-phase counter tracks — the
        # per-tick DELTA of each phase's exact tick total, so a latency
        # spike's phase shows as a spike in exactly one track
        pt = np.asarray(rec.phase_ticks, np.int64)
        names = phase_names(pt.shape[1])
        pdeltas = np.diff(
            np.concatenate([np.zeros((1, pt.shape[1]), np.int64), pt],
                           axis=0),
            axis=0,
        )
        for ti in range(T):
            out.append({
                "name": "latency_phases", "ph": "C", "pid": 0,
                "ts": (ti + 1) * us,
                "args": {name: int(pdeltas[ti, k])
                         for k, name in enumerate(names)},
            })
        # synthesized span for the traced worst op: the final tick's
        # register names the argmax-latency op — render it as a complete
        # span from its submit tick, phase vector in the args, on its own
        # track so the tail op is visible against the node timelines
        w_sub = int(rec.worst_sub[-1][0])
        if w_sub > 0:
            w_lat = int(rec.worst_lat[-1][0])
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": n, "args": {"name": "worst op"}})
            out.append({
                "name": f"worst op ({w_lat} ticks)", "ph": "X", "pid": 0,
                "tid": n, "ts": w_sub * us, "dur": max(w_lat, 1) * us,
                "args": {
                    "latency_ticks": w_lat,
                    "submit_tick": w_sub,
                    "key": int(rec.worst_key[-1][0]),
                    "client": int(rec.worst_client[-1][0]),
                    "phases": {
                        name: int(rec.worst_phases[-1][k])
                        for k, name in enumerate(names)
                    },
                },
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}
