"""K6's metrics and coverage variants (``kernels/tick.py`` ``variant``,
``csrc/tick.{cu,cuh}`` under ``-DMADRAFT_K6_METRICS`` /
``-DMADRAFT_K6_COVERAGE``) on the CPU, their device code built for the host
(``tests/tick_host_emu.cpp``, a warp as 32 threads, the warps one after
another) and driven through the wrapper's own marshalling:

- the header's metric-leaf and event enums mirror the wrapper's and the
  config's tables, and each variant is a registered build;
- K6-metrics equals the eager tick with metrics (its plain version) on
  every leaf, the metric leaves included, after every chunk: every
  template instance (n = 3, 5, 7 x cap 16, 64), the runtime one, a planted
  bug, metric registers planted at the int32 wrap with held, empty and
  beaten worst-op registers, submit stamps and latencies across the int32
  tick wrap, and full rings at cap 64 (no compaction, a command a tick)
  in a batch of seven, whose last tile works on the spare stamp rows;
- K6-coverage plus the credit pass equal the per-tick ``seen_update_plain``
  loop on the stamps, the credits and the state: one seen-set row, shard
  rows on a 16-bit seen-set (many lanes on one bit a tick), the identity
  map, violated lanes, and with the metrics plane (the combined variant);
  the case on 16 bits also shows that the host's warp order would make
  the K5 rule (credit when the stamp read back is >= t) credit other
  lanes, so the equality tests the credit pass's rule;
- the credit pass's plain version on planted indices and stamps;
- K6-metrics (host build) equals the live JAX package's vmapped
  ``step_cluster`` with ``cfg.metrics`` on every leaf, 16 clusters x 64
  ticks of ``--storm``, under an explicit threefry layout.
Tolerance: exact equality."""

import pathlib
import re

import numpy as np
import pytest
import torch

import _tick_host
from _torch_parity import (
    Pair,
    configs,
    jax_host,
    single_thread,
    threefry_layout,
)
from madraft_tpu_torch import _build
from madraft_tpu_torch.kernels import coverage as K5
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import coverage
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import state as pstate

HEADER = pathlib.Path(__file__).resolve().parent.parent / \
    "madraft_tpu_torch" / "csrc" / "tick.cuh"
SEED = 21
VARIANTS = ("tick_metrics", "tick_coverage", "tick_metrics_coverage")
I32 = torch.int32


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The variants' device code built for the host, by build name."""
    return _tick_host.build(tmp_path_factory.mktemp("tick_variants"),
                            VARIANTS)


def _enum(text: str, name: str) -> list:
    body = re.search(rf"enum {name} \{{(.*?)\}};", text, re.S).group(1)
    return [x.split("=")[0].strip() for x in body.split(",") if x.strip()]


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_metric_enums_mirror_the_tables():
    text = HEADER.read_text()
    assert _enum(text, "MetricLeaf")[:-1] == [
        f"M_{n.upper()}" for n in K6.METRIC_LEAVES]
    assert _enum(text, "Event")[:-1] == [
        f"E_{n.upper()}" for n in pcfg.METRIC_EVENTS]
    assert _const(text, "kHist") == pcfg.HIST_BUCKETS
    assert _const(text, "kLatPhases") == len(pcfg.LATENCY_PHASES)
    assert _const(text, "kReplicate") == pcfg.LATENCY_PHASES.index("replicate")
    for metrics in (False, True):
        for cov in (False, True):
            name = K6.variant(metrics, cov)
            assert name == "tick" or _build.VARIANTS[name][0] == "tick"
    cfg = pcfg.SimConfig(metrics=True)
    s = pstate.init_cluster(cfg, pengine.cluster_keys(0, 3, "cpu"))
    assert [tuple(getattr(s, f).shape[1:]) for f in K6.METRIC_LEAVES] == \
        list(K6.metric_shapes(cfg))


def _plant_registers(s: pstate.ClusterState) -> pstate.ClusterState:
    """The metric leaves of a fresh batch planted at their edges: stale
    submit stamps in every ring slot (a no-op must clear its slot's, an
    install-snapshot keeps them, as the reference does), sums a few counts
    below the int32 wrap, and per lane in turn an empty worst-op register
    holding a large latency (the first op replaces it), a held one every
    op beats, and a held one above every op (kept)."""
    b = s.tick.shape[0]
    rng = np.random.default_rng(5)
    top = 2**31 - 1

    def near(x, spread):
        v = top - rng.integers(0, spread, x.shape)
        return torch.from_numpy(v.astype(np.int32))

    lane = torch.arange(b)
    kind = lane % 3
    return s._replace(
        log_tick=torch.from_numpy(
            rng.integers(1, 6, s.log_tick.shape).astype(np.int32)),
        lat_hist=near(s.lat_hist, 4), ev_counts=near(s.ev_counts, 8),
        phase_hist=near(s.phase_hist, 4), phase_ticks=near(s.phase_ticks, 4),
        lat_ticks=near(s.lat_ticks, 4),
        worst_lat=torch.where(kind == 2, 2**30, torch.where(
            kind == 0, 10**6, 0)).to(I32)[:, None],
        worst_phases=torch.from_numpy(
            rng.integers(0, 99, s.worst_phases.shape).astype(np.int32)),
        worst_key=torch.full_like(s.worst_key, 7),
        worst_client=torch.full_like(s.worst_client, 3),
        worst_sub=torch.where(kind == 0, 0, 5).to(I32)[:, None])


_CAP16 = dict(log_cap=16, compact_every=4, uncommitted_cap=4)


@pytest.mark.parametrize("case", [
    "n3_cap16", "n5_cap16", "n7_cap16", "n3", "n5", "n7", "n5_runtime",
    "n5_bug", "registers", "registers_cap16", "tick_wraps",
    "full_ring_cap64"])
def test_metrics_device_code_on_the_host_equals_plain(host, case):
    storm = pcfg.storm_profiles()["storm"][0].replace(metrics=True)
    cfg, b, ticks, chunk = storm, 8, 96, 48
    if case == "full_ring_cap64":  # leaders fill their rings by tick ~96
        cfg = pcfg.SimConfig(metrics=True, compact_at_commit=False,
                             p_client_cmd=1.0)
        b, ticks, chunk = 7, 128, 64
    elif case[1].isdigit():
        cfg = storm.replace(n_nodes=int(case[1]),
                            **(_CAP16 if "cap16" in case else {}))
    elif case.endswith("cap16"):
        cfg = storm.replace(**_CAP16)
    if case.endswith("runtime"):  # the flagship's shape, one more entry
        cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)  # a message
    if case.endswith("bug"):
        cfg = cfg.replace(bug="commit_any_term")
    want_instance = 0 if "runtime" in case else 1 + K6.SHAPES.index(
        (cfg.n_nodes, cfg.log_cap))
    assert K6.instance(cfg) == want_instance
    keys = pengine.cluster_keys(SEED, b, "cpu")
    kn = cfg.knobs()
    s = pstate.init_cluster(cfg, keys, kn)
    if case.startswith("registers"):
        s = _plant_registers(s)
    if case == "tick_wraps":  # ticks across the int32 and u32 wraps
        s = s._replace(tick=torch.tensor(
            [(2**31 - 10, -20, 1000)[i % 3] for i in range(b)],
            dtype=I32))
    done = 0
    with threefry_layout(True):
        while done < ticks:
            m = min(chunk, ticks - done)
            got, _ = K6._launch(cfg, s, keys, kn, m, host["tick_metrics"],
                                None)
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m)
            done += m
            d = pstate.first_divergence(done, pstate.state_to_numpy(want),
                                        pstate.state_to_numpy(got))
            assert d is None, d
            s = want
    final = pstate.state_to_numpy(s)
    assert final["lat_hist"].sum() != 0 and final["ev_counts"].sum() != 0
    if case == "full_ring_cap64":
        assert (final["log_len"] - final["base"] == cfg.log_cap).any()
    if case.startswith("registers"):  # the sums wrapped; each kind met an op
        assert (final["lat_ticks"] < 0).any()
        assert (final["worst_lat"][2::3, 0] == 2**30).all()
        assert (final["worst_sub"][0::3, 0] > 0).any()


def _old_rule_credits(fp, seen0, t0, b, per_warp):
    """The credits K5's rule (a lane-tick credited when the stamp it reads
    back is >= its tick) gives when the lane-ticks land in the host's
    order: each warp's clusters through all their ticks, one warp after
    another."""
    flat = seen0.view(-1).clone()
    got = torch.zeros(b, dtype=I32)
    for first in range(0, b, per_warp):
        for i in range(fp.shape[0]):
            for c in range(first, min(first + per_warp, b)):
                f = int(fp[i, c])
                if f < 0:
                    continue
                old = int(flat[f])
                got[c] += old >= t0 + i
                flat[f] = min(old, t0 + i)
    return got


@pytest.mark.parametrize("case", [
    "one_row", "shards_16bits", "identity", "violated", "metrics"])
def test_coverage_device_code_on_the_host_equals_plain(host, case):
    storm = pcfg.storm_profiles()["storm"][0]
    cfg, ccfg, shards, b, ticks, chunk = (storm, pcfg.CoverageConfig(), None,
                                          16, 96, 48)
    if case == "shards_16bits":
        ccfg, shards = pcfg.CoverageConfig(bitmap_bits=16), 4
    elif case == "identity":  # every code its own bit (3 nodes)
        cfg, ccfg, _ = pcfg.coverage_ground_truth()
        assert coverage.identity_mapped(cfg.n_nodes, ccfg)
    elif case == "violated":  # a broken quorum: lanes violate and stop
        cfg = storm.replace(majority_override=2)
    elif case == "metrics":
        cfg, shards = storm.replace(metrics=True), 2
    lib = host[K6.variant(cfg.metrics, True)]
    keys = pengine.cluster_keys(SEED, b, "cpu")
    kn = cfg.knobs()
    s = pstate.init_cluster(cfg, keys, kn)
    rows = None if shards is None else coverage.lane_shards(b, shards)
    fp_cfg = ccfg.fingerprint_key()
    seen_k = torch.full((shards or 1, ccfg.bitmap_bits), coverage.UNSEEN,
                        dtype=I32)
    nf_k = torch.zeros(b, dtype=I32)
    seen_p, nf_p = seen_k.clone(), nf_k.clone()
    done, differs = 0, False
    with threefry_layout(True):
        while done < ticks:
            m = min(chunk, ticks - done)
            fp = torch.empty((m, b), dtype=I32)
            seen0 = seen_k.clone()
            got, _ = K6._launch(cfg, s, keys, kn, m, lib, None,
                                cov=K6.Seen(fp_cfg, seen_k, rows, nf_k, done),
                                fp=fp)
            nf0 = nf_k.clone()
            assert lib.credit_launch(fp.data_ptr(), seen_k.data_ptr(),
                                     nf_k.data_ptr(), b, m, done, None) == 0
            want = K6.tick_chunk_plain(
                cfg, s, keys, kn, m, cov=K6.Seen(fp_cfg, seen_p, rows, nf_p,
                                                 done))
            # the plain credit pass on the same indices and stamps
            assert torch.equal(K5.credit_plain(fp, seen_k, nf0.clone(), done),
                               nf_k)
            per_warp = 2  # every instance runs two clusters a warp
            differs |= not torch.equal(
                nf0 + _old_rule_credits(fp, seen0, done, b, per_warp), nf_k)
            done += m
            d = pstate.first_divergence(done, pstate.state_to_numpy(want),
                                        pstate.state_to_numpy(got))
            assert d is None, d
            assert torch.equal(seen_k, seen_p), done
            assert torch.equal(nf_k, nf_p), (done, nf_k, nf_p)
            s = want
    seen_bits = int((seen_p != coverage.UNSEEN).sum())
    assert seen_bits > 1 and int(nf_p.sum()) >= seen_bits
    if case == "violated":
        assert (s.violations != 0).any()
    if case == "shards_16bits":
        assert differs, "the host's order gave no case for the credit rule"


def test_credit_plain_credits_a_lane_tick_at_its_own_stamp():
    # two rows of 8 bits; lanes 0-2 in row 0, lane 3 in row 1; ticks 10, 11
    seen = torch.full((2, 8), coverage.UNSEEN, dtype=I32)
    seen[0, 1] = 10   # lanes 0 and 1 both landed here at tick 10
    seen[0, 2] = 3    # set by an earlier chunk
    seen[0, 4] = 10   # lane 2 at tick 10; lane 0 again at tick 11
    seen[1, 1] = 11   # lane 3 at tick 11 (another row, same bit)
    fp = torch.tensor([[1, 1, 4, -1],
                       [4, 2, -1, 8 + 1]], dtype=I32)
    got = K5.credit_plain(fp, seen, torch.tensor([5, 0, 0, 0], dtype=I32), 10)
    assert got.tolist() == [6, 1, 1, 1]
    # the wrapper takes the plain version on CPU tensors
    assert K5.credit_pass(fp, seen, torch.zeros(4, dtype=I32), 10).tolist() \
        == [1, 1, 1, 1]


def test_k6_metrics_host_build_matches_the_jax_reference(host):
    with threefry_layout(True):
        pair = Pair(*configs("storm", metrics=True), seed=SEED, n_clusters=16)
        ps, js, tick = pair.ps, pair.js, 0
        for m in (32, 32):
            ps, _ = K6._launch(pair.pcfg, ps, pair.pkeys, pair.pkn, m,
                               host["tick_metrics"], None)
            for _ in range(m):
                js = pair._jstep(js, pair.jkeys, pair.jkn)
            tick += m
            d = pstate.first_divergence(tick, jax_host(js),
                                        pstate.state_to_numpy(ps))
            assert d is None, d
    final = pstate.state_to_numpy(ps)
    assert int(final["tick"][0]) == 64 and final["lat_hist"].sum() > 0
