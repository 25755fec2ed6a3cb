"""The metrics plane's folds and host helpers, the twin of the raw-raft part
of ``madraft_tpu/tpusim/metrics.py``.

Bucket convention (``config.HIST_BUCKETS`` fixed log-spaced buckets):
  bucket 0        latency in [0, 1] ticks
  bucket k >= 1   latency in [2^k, 2^(k+1) - 1]
  last bucket     open-ended: [2^(HB-1), inf)
The bucket of a latency is the count of ``BUCKET_EDGES`` at or below it.
``quantile_from_hist`` reports the upper edge of the bucket holding the
quantile (the lower edge for the open-ended last bucket). Fixed edges mean
histograms merge by plain addition across lanes, runs and files.

The device folds (``fold_latencies``, ``fold_phases``, ``update_worst``)
are written batch-first, with a leading cluster axis, and stay in int32
(the CPU's UInt16/UInt32 lack sums and shifts). Together they are the
plain version of kernel K4 (``kernels/metrics.py``); the tick reaches them
only through K4's wrapper. The host helpers work on numpy rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from madraft_tpu_torch.tpusim.config import (
    HIST_BUCKETS,
    METRIC_EVENTS,
    phase_names,
)

I32 = torch.int32

# Lower edges of buckets 1..HB-1 (bucket 0's lower edge is 0).
BUCKET_EDGES = tuple(1 << k for k in range(1, HIST_BUCKETS))


def bucket_of(lat: torch.Tensor) -> torch.Tensor:
    """Bucket index of every latency: the count of edges at or below it."""
    edges = torch.tensor(BUCKET_EDGES, dtype=I32, device=lat.device)
    return (lat[..., None] >= edges).sum(-1, dtype=I32)


def fold_latencies(hist: torch.Tensor, lat: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Add each masked latency's bucket to ``hist``: hist [..., HB],
    lat/mask [..., m] -> [..., HB]. A one-hot sum, as the reference."""
    oh = (bucket_of(lat)[..., None]
          == torch.arange(HIST_BUCKETS, dtype=I32, device=lat.device))
    return hist + (oh & mask[..., None]).sum(-2, dtype=I32)


def fold_latencies_by(hist2d: torch.Tensor, lat: torch.Tensor,
                      mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Add each masked latency's bucket to row ``idx`` of ``hist2d``: the
    per-key / per-client axes. hist2d [B, rows, HB], lat/mask/idx [B, m]
    -> [B, rows, HB]; a two-way one-hot sum, as the reference's."""
    rows = hist2d.shape[-2]
    dev = lat.device
    b_oh = (bucket_of(lat)[..., None]
            == torch.arange(HIST_BUCKETS, dtype=I32, device=dev))  # [B, m, HB]
    r_oh = idx[..., None] == torch.arange(rows, dtype=I32, device=dev)
    hit = r_oh[..., :, None] & b_oh[..., None, :] & mask[..., None, None]
    return hist2d + hit.sum(-3, dtype=I32)


def clerk_phase_matrix(t, sub, app, cmt, apl, is_get) -> torch.Tensor:
    """The exact 4-phase split [B, 4, m] of the latency ``t - sub`` from a
    clerk's boundary stamps (``config.LATENCY_PHASES`` order), the stamps
    clamped monotone so that the rows telescope to ``t - sub``. ``t`` is
    [B, 1] or broadcasts against the [B, m] stamps."""
    app_e = torch.maximum(app, sub)
    cmt_e = torch.maximum(cmt, app_e)
    b3 = torch.where(is_get, torch.maximum(apl, cmt_e), cmt_e)
    return torch.stack([app_e - sub, cmt_e - app_e, b3 - cmt_e, t - b3],
                       dim=-2)


def fold_phases(phase_hist, phase_ticks, lat_ticks, phases, lat, mask):
    """Fold each phase duration of every masked op into that phase's
    histogram row (zeros land in bucket 0, so each row's mass equals the
    acked count) and add the exact tick totals. Shapes: phase_hist
    [B, P, HB], phase_ticks [B, P], lat_ticks [B, 1], phases [B, P, m],
    lat/mask [B, m]. int32 sums wrap, as the reference's."""
    new_hist = fold_latencies(phase_hist, phases, mask[:, None, :])
    new_ticks = phase_ticks + torch.where(
        mask[:, None, :], phases, 0).sum(-1, dtype=I32)
    new_lat = lat_ticks + torch.where(mask, lat, 0).sum(
        -1, dtype=I32, keepdim=True)
    return new_hist, new_ticks, new_lat


def update_worst(reg: tuple, lat, mask, phases, keys, clients, subs) -> tuple:
    """Per-lane worst-op register update: among this tick's masked ops the
    argmax-latency one (lowest index on ties, over ``where(mask, lat, -1)``
    as the reference) replaces the register when it is strictly greater, or
    when the register is empty (worst_sub 0). ``reg`` is (worst_lat [B, 1],
    worst_phases [B, P], worst_key [B, 1], worst_client [B, 1], worst_sub
    [B, 1])."""
    worst_lat, worst_phases, worst_key, worst_client, worst_sub = reg
    i = torch.argmax(torch.where(mask, lat, -1), dim=-1, keepdim=True)

    def sel(x):  # [B, m] -> [B, 1]
        return x.gather(-1, i)

    cand = sel(lat)
    better = mask.any(-1, keepdim=True) & ((cand > worst_lat) | (worst_sub == 0))
    cand_ph = phases.gather(-1, i[:, None, :].expand(-1, phases.shape[1], 1))
    return (
        torch.where(better, cand, worst_lat),
        torch.where(better, cand_ph[..., 0], worst_phases),
        torch.where(better, sel(keys), worst_key),
        torch.where(better, sel(clients), worst_client),
        torch.where(better, sel(subs), worst_sub),
    )


def latency_fold_plain(lat, mask, phases, keys, clients, subs, lat_hist,
                       phase_hist, phase_ticks, lat_ticks, worst: tuple):
    """``fold_latencies`` + ``fold_phases`` + ``update_worst`` in one call,
    the plain version of kernel K4. Returns (lat_hist, phase_hist,
    phase_ticks, lat_ticks, worst)."""
    lat_hist = fold_latencies(lat_hist, lat, mask)
    phase_hist, phase_ticks, lat_ticks = fold_phases(
        phase_hist, phase_ticks, lat_ticks, phases, lat, mask)
    worst = update_worst(worst, lat, mask, phases, keys, clients, subs)
    return lat_hist, phase_hist, phase_ticks, lat_ticks, worst


def planted_fold_inputs(b: int, m: int, p: int, seed: int) -> tuple:
    """CPU inputs of the latency fold (``latency_fold_plain``'s argument
    order) planted at its edges, for holding K4 against its plain version:
    latencies at every bucket edge 2^k - 1 and 2^k, 0, 1, 2, at and past
    2^15, near 2^31 and negative; int32 sums that wrap; and per cluster
    (b >= 8): 0 every op masked, 1 none masked, 2 the maximum tied across
    many ops, 3 a held register above every op, 4 a held register equal
    to the best op (kept), 5 an empty register (worst_sub 0) above every
    op (replaced), 6 latencies -1 and 0 (a masked -1 ties with the
    unmasked ops), 7 a single masked op at the last index. Not a
    reachable state."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, 3, -1, -5, 2**20, 2**31 - 1]
    for k in range(2, 17):
        edges += [2**k - 1, 2**k, 2**k + 1]
    edges = np.asarray(edges, np.int64)

    def pick(shape):
        v = np.where(rng.random(shape) < 0.5, rng.choice(edges, shape),
                     rng.integers(0, 4096, shape))
        return v.astype(np.int32)

    lat = pick((b, m))
    mask = rng.random((b, m)) < 0.4
    phases = pick((b, p, m))
    keys = rng.integers(-1, 1000, (b, m)).astype(np.int32)
    clients = rng.integers(-1, 64, (b, m)).astype(np.int32)
    subs = rng.integers(0, 5000, (b, m)).astype(np.int32)
    hb = HIST_BUCKETS
    lat_hist = rng.integers(0, 2**31 - 2**20, (b, hb)).astype(np.int32)
    phase_hist = rng.integers(0, 2**31 - 2**20, (b, p, hb)).astype(np.int32)
    phase_ticks = rng.integers(-2**31, 2**31, (b, p)).astype(np.int32)
    lat_ticks = rng.integers(2**31 - 2**16, 2**31, (b, 1)).astype(np.int32)
    wl = rng.integers(0, 2**15, (b, 1)).astype(np.int32)
    wp = rng.integers(0, 2**15, (b, p)).astype(np.int32)
    wk = rng.integers(-1, 1000, (b, 1)).astype(np.int32)
    wc = rng.integers(-1, 64, (b, 1)).astype(np.int32)
    ws = np.where(rng.random((b, 1)) < 0.3, 0,
                  rng.integers(1, 5000, (b, 1))).astype(np.int32)
    if b >= 8:
        mask[0] = True
        mask[1] = False
        lat[2] = rng.integers(0, 300, m)
        lat[2, ::3] = 4000
        mask[2] = True
        lat[3], mask[3], wl[3], ws[3] = 10, True, 2**30, 7
        lat[4], mask[4] = rng.integers(0, 100, m), True
        wl[4], ws[4] = lat[4].max(), 9
        lat[5], mask[5], wl[5], ws[5] = 10, True, 2**30, 0
        lat[6], mask[6] = rng.integers(-1, 1, m), rng.random(m) < 0.5
        mask[7], mask[7, m - 1] = False, True
    return tuple(torch.from_numpy(x) for x in (
        lat, mask, phases, keys, clients, subs, lat_hist, phase_hist,
        phase_ticks, lat_ticks)) + (
        tuple(torch.from_numpy(x) for x in (wl, wp, wk, wc, ws)),)


# --------------------------------------------------------------------------
# Host-side helpers (numpy): decode, merge, render.
# --------------------------------------------------------------------------


def phases_summary(phase_hist, phase_ticks,
                   ms_per_tick: Optional[int] = None) -> dict:
    """The ``latency.phases`` dict: one latency_summary per phase row,
    keyed by name, plus the row's exact tick total."""
    names = phase_names(len(phase_hist))
    pt = np.asarray(phase_ticks, np.int64)
    out = {}
    for p, name in enumerate(names):
        d = latency_summary(phase_hist[p], ms_per_tick)
        d["ticks_total"] = int(pt[p])
        out[name] = d
    return out


def worst_op_dict(worst_lat, worst_phases, worst_key, worst_client,
                  worst_sub) -> Optional[dict]:
    """One worst-op register as the report dict (None when it is empty)."""
    if int(np.asarray(worst_sub).reshape(-1)[0]) == 0:
        return None
    ph = np.asarray(worst_phases, np.int64).reshape(-1)
    names = phase_names(ph.shape[0])
    return {
        "latency_ticks": int(np.asarray(worst_lat).reshape(-1)[0]),
        "submit_tick": int(np.asarray(worst_sub).reshape(-1)[0]),
        "key": int(np.asarray(worst_key).reshape(-1)[0]),
        "client": int(np.asarray(worst_client).reshape(-1)[0]),
        "phases": {name: int(ph[p]) for p, name in enumerate(names)},
    }


def merge_worst(a: Optional[dict], b: Optional[dict],
                a_id=None, b_id=None) -> Optional[dict]:
    """The higher latency wins; ties go to the smaller cluster id."""
    if a is not None and a_id is not None and "cluster_id" not in a:
        a = {**a, "cluster_id": int(a_id)}
    if b is not None and b_id is not None and "cluster_id" not in b:
        b = {**b, "cluster_id": int(b_id)}
    if a is None:
        return b
    if b is None:
        return a
    ka = (a["latency_ticks"], -a.get("cluster_id", 0))
    kb = (b["latency_ticks"], -b.get("cluster_id", 0))
    return a if ka >= kb else b


def merge_worst_registers(worst_lat, worst_phases, worst_key, worst_client,
                          worst_sub, ids=None,
                          into: Optional[dict] = None) -> Optional[dict]:
    """Merge per-lane worst-op registers (leading axis = lanes) by
    ``merge_worst``; ``ids`` labels each lane's cluster id (default: the
    lane index), ``into`` seeds the merge."""
    worst = into
    for c in range(np.asarray(worst_lat).shape[0]):
        worst = merge_worst(
            worst,
            worst_op_dict(worst_lat[c], worst_phases[c], worst_key[c],
                          worst_client[c], worst_sub[c]),
            b_id=int(ids[c]) if ids is not None else c,
        )
    return worst


def host_bucket(lat) -> np.ndarray:
    """Bucket index per latency by another route than the fold
    (searchsorted over the edges), for cross-checks."""
    return np.searchsorted(np.asarray(BUCKET_EDGES), np.asarray(lat),
                           side="right")


def bucket_bounds(k: int) -> tuple:
    """(lower, upper) latency of bucket k; upper None for the last."""
    lo = 0 if k == 0 else (1 << k)
    hi = None if k == HIST_BUCKETS - 1 else (1 << (k + 1)) - 1
    return lo, hi


def quantile_from_hist(hist, q: float) -> Optional[int]:
    """The q-quantile latency (ticks) of a histogram: the upper edge of the
    bucket where the cumulative count first reaches q * total (lower edge
    for the open-ended last bucket); None when it is empty."""
    h = np.asarray(hist, dtype=np.int64)
    total = int(h.sum())
    if total == 0:
        return None
    k = int(np.searchsorted(np.cumsum(h), q * total, side="left"))
    k = min(k, HIST_BUCKETS - 1)
    lo, hi = bucket_bounds(k)
    return lo if hi is None else hi


def latency_summary(hist, ms_per_tick: Optional[int] = None) -> dict:
    """Op count, p50/p99 from the buckets, and the raw row."""
    h = np.asarray(hist, dtype=np.int64)
    out = {
        "ops": int(h.sum()),
        "p50_ticks": quantile_from_hist(h, 0.50),
        "p99_ticks": quantile_from_hist(h, 0.99),
        "hist": [int(x) for x in h],
    }
    if ms_per_tick and out["p99_ticks"] is not None:
        out["p50_ms"] = out["p50_ticks"] * ms_per_tick
        out["p99_ms"] = out["p99_ticks"] * ms_per_tick
    return out


def event_summary(ev) -> dict:
    """METRIC_EVENTS-keyed counter dict from one merged ev_counts row."""
    ev = np.asarray(ev, dtype=np.int64)
    return {name: int(ev[i]) for i, name in enumerate(METRIC_EVENTS)}


def render_histogram(hist, width: int = 40) -> list:
    """ASCII rendering of one merged histogram: a line per non-empty
    bucket, the bar scaled to the largest."""
    h = np.asarray(hist, dtype=np.int64)
    total = int(h.sum())
    if total == 0:
        return ["(no latency samples)"]
    top = int(h.max())
    lines = []
    cum = 0
    for k in range(HIST_BUCKETS):
        if h[k] == 0:
            continue
        cum += int(h[k])
        lo, hi = bucket_bounds(k)
        rng = f"[{lo}, {hi}]" if hi is not None else f"[{lo}, inf)"
        bar = "#" * max(1, round(width * int(h[k]) / top))
        lines.append(
            f"{rng:>16} ticks  {int(h[k]):>10}  {100.0 * cum / total:5.1f}%  "
            f"{bar}"
        )
    return lines
