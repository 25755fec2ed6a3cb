"""K6-trace on the CPU: K6 with a trace buffer (``kernels/tick.py``
``tick_chunk(..., trace=)``, ``csrc/tick.cuh`` ``record``) writes each
tick's flight-recorder row, K8's row (``kernels/trace.py``
``record_plain``), from inside its chunk. Its device code is built for the
host with g++ (``tests/tick_host_emu.cpp``, the plain and metrics builds,
module-scoped) and driven through the wrapper's own marshalling:

- the rows equal the eager tick's ``record_plain`` rows at every tick, for
  every template instance and the runtime one, metrics on and off, the
  planted bug ``explain`` shows (its cluster violates at tick 87), ticks
  across the int32 wrap, each in batches of three clusters, so that the
  last warp holds a tile past the batch's end;
- the traced replay's chunking (``tpusim/trace.py``: K6-trace launches of
  up to ``engine.KERNEL_CHUNK`` ticks, here 300 ticks in two launches)
  gives the CPU route's rows and final state;
- the host build's rows of a storm cluster equal the live JAX package's
  ``replay_cluster_traced`` (24 ticks: a crash, an election's votes),
  field by field.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import _tick_host
from _torch_parity import configs, single_thread, threefry_layout
from madraft_tpu.tpusim import trace as jtrace
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.kernels import trace as K8
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import state as pstate
from madraft_tpu_torch.tpusim import trace as ptrace

SEED = 21
I32 = torch.int32
# lanes whose ticks cross the int32 wrap, the u32 wrap, and neither
WRAP_TICKS = (2**31 - 10, -20, 1000)
_CAP16 = dict(log_cap=16, compact_every=4, uncommitted_cap=4)


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """K6's plain and metrics builds for the host, by build name."""
    return _tick_host.build(tmp_path_factory.mktemp("tick_trace"),
                            ("tick", "tick_metrics"))


def _rows_vs_plain(lib, cfg, s, keys, kn, ticks: int, chunk: int):
    """K6-trace (the host build) and the eager tick with record_plain
    from ``s`` over ``ticks`` ticks in chunks of ``chunk``: the rows at
    every tick and the state after every chunk equal. Returns the final
    state and all the rows [ticks, B, W]."""
    b, w = s.tick.shape[0], K8.record_width(cfg)
    rows = []
    done = 0
    while done < ticks:
        m = min(chunk, ticks - done)
        got_rows = torch.full((m, b, w), -7, dtype=I32)
        want_rows = torch.full((m, b, w), -7, dtype=I32)
        got, _ = K6._launch(cfg, s, keys, kn, m, lib, None, trace=got_rows)
        want = K6.tick_chunk_plain(cfg, s, keys, kn, m, trace=want_rows)
        bad = (got_rows != want_rows).any(-1).nonzero()
        assert not bad.numel(), (
            f"row of cluster {int(bad[0, 1])} differs at tick "
            f"{done + int(bad[0, 0]) + 1}: columns "
            f"{(got_rows[tuple(bad[0])] != want_rows[tuple(bad[0])]).nonzero().flatten().tolist()}")
        done += m
        d = pstate.first_divergence(done, pstate.state_to_numpy(want),
                                    pstate.state_to_numpy(got))
        assert d is None, d
        rows.append(want_rows)
        s = want
    return s, torch.cat(rows)


SHAPE_CASES = [f"n{n}_cap{cap}" for n, cap in K6.SHAPES] + [
    "n5_cap64_runtime", "n4_cap32_runtime"]


@pytest.mark.parametrize("metrics_on", [False, True])
@pytest.mark.parametrize("case", SHAPE_CASES + ["bug", "tick_wraps"])
def test_k6_trace_rows_equal_record_plain(host, case, metrics_on):
    storm = pcfg.storm_profiles()["storm"][0].replace(metrics=metrics_on)
    cfg, ticks, chunk, seed, id0 = storm, 24, 12, SEED, 0
    if case.startswith("n"):
        n, cap = int(case[1]), int(case.split("_")[1][3:])
        shape = (_CAP16 if cap == 16 else
                 dict(log_cap=32, compact_every=8) if cap == 32 else {})
        cfg = storm.replace(n_nodes=n, **shape)
        if case == "n5_cap64_runtime":  # the flagship's shape, one more
            cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)  # entry a message
    elif case == "bug":  # the clusters 30-32 of explain's seed, 32 its bug
        cfg = pcfg.storm_profiles()["durability"][0].replace(
            bug="ack_before_fsync", metrics=metrics_on)
        ticks, chunk, seed, id0 = 96, 48, 5, 30
    want_instance = 0 if "runtime" in case else 1 + K6.SHAPES.index(
        (cfg.n_nodes, cfg.log_cap))
    assert K6.instance(cfg) == want_instance
    b = 3
    keys = pengine.cluster_keys(seed, b, "cpu", id0=id0)
    kn = cfg.knobs()
    s = pstate.init_cluster(cfg, keys, kn)
    if case == "tick_wraps":
        s = s._replace(tick=torch.tensor(
            [WRAP_TICKS[i % 3] for i in range(b)], dtype=I32))
    lib = host[K6.variant(metrics_on, False)]
    with threefry_layout(True):
        final, rows = _rows_vs_plain(lib, cfg, s, keys, kn, ticks, chunk)
    # the rows saw deliveries, and the sums add up to the delivered count
    dec = [K8.decode(cfg, rows[:, c].numpy()) for c in range(b)]
    for c, r in enumerate(dec):
        sent = sum(r[f] for f in K8.DELIVERED)
        assert (np.diff(r["msg_count"], prepend=r["msg_count"][0] - sent[0])
                == sent).all()
    assert sum(int(r["msg_count"][-1]) for r in dec) != 0
    if case == "bug":
        assert int(final.first_violation_tick[2]) == 87
    if metrics_on:
        assert any(r["ev_counts"].any() for r in dec)


def test_traced_replay_chunks_equal_the_cpu_route(host, monkeypatch):
    """300 ticks of the bug cluster through ``trace.replay_cluster_traced``
    on the host build (K6-trace launches of 256 and 44 ticks, a batch of
    one, so its warp's second tile holds no cluster) against the CPU
    route (the eager tick and K8's plain version)."""
    cfg = pcfg.storm_profiles()["durability"][0].replace(
        bug="ack_before_fsync", metrics=True)
    seed, cluster, ticks = 5, 32, 300
    calls = []

    def host_chunk(cfg_, state, keys, kn, m, table=None, cov=None,
                   trace=None):
        calls.append((m, trace is not None))
        out, _ = K6._launch(cfg_, state, keys, kn, m,
                            host[K6.variant(cfg_.metrics, False)], None,
                            table=table, trace=trace)
        return out

    with threefry_layout(True):
        want_final, want = ptrace.traced_rows(cfg, seed, cluster, ticks,
                                              device="cpu")
        monkeypatch.setattr(pengine, "tick_route", lambda dev: "kernel")
        monkeypatch.setattr(K6, "tick_chunk", host_chunk)
        final, rec = ptrace.replay_cluster_traced(cfg, seed, cluster, ticks,
                                                  device="cpu")
    assert calls == [(pengine.KERNEL_CHUNK, True),
                     (ticks - pengine.KERNEL_CHUNK, True)]
    want_rec = ptrace.TickRecord(**K8.decode(cfg, want[:, 0].numpy()))
    for f in rec._fields:
        a, b = getattr(want_rec, f), getattr(rec, f)
        bad = np.nonzero((a != b).reshape(ticks, -1).any(-1))[0]
        assert not bad.size, f"{f} differs from tick {bad[0] + 1}"
    assert all(torch.equal(a, b) for a, b in zip(final, want_final))
    assert int(final.first_violation_tick[0]) == 87


def test_k6_trace_host_build_equals_the_jax_reference(host):
    jcfg, cfg = configs("storm")
    seed, cluster, ticks = 12345, 5, 24
    with threefry_layout(True):
        _, jrec = jtrace.replay_cluster_traced(jcfg, seed, cluster, ticks)
        keys = pengine.cluster_keys(seed, 1, "cpu", id0=cluster)
        kn = cfg.knobs()
        rows = torch.empty((ticks, 1, K8.record_width(cfg)), dtype=I32)
        K6._launch(cfg, pstate.init_cluster(cfg, keys, kn), keys, kn, ticks,
                   host["tick"], None, trace=rows)
    rec = K8.decode(cfg, rows[:, 0].numpy())
    assert tuple(rec) == jrec._fields
    for f, x in rec.items():
        a = np.asarray(getattr(jrec, f))
        assert a.dtype == x.dtype and a.shape == x.shape, f
        bad = np.nonzero((a != x).reshape(ticks, -1).any(-1))[0]
        assert not bad.size, f"{f} differs from tick {bad[0] + 1}"
    assert rec["rv_req_delivered"].sum() > 0 and not rec["alive"].all()
