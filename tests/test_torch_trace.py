"""The flight recorder (``tpusim/trace.py``, the ``explain`` verb) and K8,
its per-tick record (``kernels/trace.py``), on the CPU.

The traced replay against the live JAX package's ``replay_cluster_traced``
under the partitionable threefry layout, every TickRecord field at every
tick and the final state, for a storm cluster and a planted-bug cluster
that violates (the durability profile's ``ack_before_fsync``, seed 5,
cluster 32, first violation at tick 87), metrics on and off, 100 ticks; the traced
final state against ``replay_cluster``'s; the reference's
``decode_events``, ``events_in_window`` and ``chrome_trace`` against the
port's on the same record; the ``explain`` CLI's output, JSONL and chrome
(to stdout and with ``--out``), against the reference CLI's, byte for
byte; ``explain --heartbeat`` exits 2 naming ROADMAP A15. Then K8's device
code, built for the host with g++ (``tests/kernel_host_emu.cpp``), against
its plain version at every tick. Tolerance: exact equality."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import _kernel_host
from _torch_parity import configs, single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu.tpusim import trace as jtrace
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.kernels import trace as K8
from madraft_tpu_torch.tpusim import engine, state, trace

TICKS = 100
# (profile, bug, seed, cluster): a storm cluster, and a bug cluster whose
# first violation lands at tick 87
CLUSTERS = {"storm": ("storm", "", 12345, 5),
            "bug": ("durability", "ack_before_fsync", 5, 32)}
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def _traced(which: str, metrics_on: bool):
    key = (which, metrics_on)
    if key not in _CACHE:
        profile, bug, seed, cluster = CLUSTERS[which]
        jcfg, pcfg = configs(profile, bug, metrics=metrics_on)
        _CACHE[key] = (pcfg, jtrace.replay_cluster_traced(
            jcfg, seed, cluster, TICKS), trace.replay_cluster_traced(
            pcfg, seed, cluster, TICKS, device="cpu"))
    return _CACHE[key]


@pytest.mark.parametrize("metrics_on", [False, True])
@pytest.mark.parametrize("which", ["storm", "bug"])
def test_traced_replay_equals_the_reference(which, metrics_on):
    pcfg, (jfinal, jrec), (final, rec) = _traced(which, metrics_on)
    assert rec._fields == jrec._fields
    for f in rec._fields:
        a, b = np.asarray(getattr(jrec, f)), getattr(rec, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        bad = np.nonzero((a != b).reshape(TICKS, -1).any(-1))[0]
        assert not bad.size, f"{f} differs from tick {bad[0] + 1}"
    want = {f: np.asarray(x)[None] for f, x in zip(jfinal._fields, jfinal)}
    assert state.first_divergence(TICKS, want,
                                  state.state_to_numpy(final)) is None
    profile, bug, seed, cluster = CLUSTERS[which]
    plain = engine.replay_cluster(pcfg, seed, cluster, TICKS, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(final, plain))
    if which == "bug":
        assert int(final.first_violation_tick[0]) == 87
    # the deliveries add up to the tick's delivered messages
    sent = (rec.rv_req_delivered + rec.rv_rsp_delivered + rec.ae_req_delivered
            + rec.ae_rsp_delivered + rec.snap_delivered)
    assert (sent == np.diff(rec.msg_count, prepend=0)).all()


@pytest.mark.parametrize("metrics_on", [False, True])
@pytest.mark.parametrize("which", ["storm", "bug"])
def test_decode_and_chrome_trace_equal_the_reference(which, metrics_on):
    pcfg, _, (final, rec) = _traced(which, metrics_on)
    jrec = jtrace.TickRecord(**rec._asdict())
    events = trace.decode_events(rec)
    assert events == jtrace.decode_events(jrec) and events
    fvt = int(final.first_violation_tick[0])
    for center, window in ((fvt, 20), (None, 20), (30, 0), (30, 15)):
        assert trace.events_in_window(events, center, window) \
            == jtrace.events_in_window(events, center, window)
    assert (trace.alive_masks(rec) == jtrace.alive_masks(jrec)).all()
    assert trace.chrome_trace(rec, pcfg.ms_per_tick, events, label="x") \
        == jtrace.chrome_trace(jrec, pcfg.ms_per_tick, events, label="x")


def _cli(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, buf.getvalue(), err.getvalue()


@pytest.mark.parametrize("fmt", ["jsonl", "chrome", "chrome_out"])
@pytest.mark.parametrize("which", ["storm", "bug"])
def test_explain_cli_matches_the_reference(which, fmt, tmp_path):
    profile, bug, seed, cluster = CLUSTERS[which]
    argv = ["explain", "--platform", "cpu", "--profile", profile, "--seed",
            str(seed), "--cluster", str(cluster), "--ticks", str(TICKS),
            "--window", "25"]
    if bug:
        argv += ["--bug", bug]
    if fmt != "jsonl":
        argv += ["--format", "chrome"]
    outs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        extra = ["--out", str(tmp_path / "trace.json")] if fmt == "chrome_out" \
            else []
        rc, text, _ = _cli(main, argv + extra)
        body = (tmp_path / "trace.json").read_text() if extra else ""
        outs.append((rc, text, body))
    assert outs[0] == outs[1]
    rc, text, body = outs[1]
    assert rc == 0
    head = json.loads(text.splitlines()[0])
    if fmt == "jsonl":
        assert bool(head["violations"]) == bool(bug)
        assert head["events_shown"] == len(text.splitlines()) - 1
    elif fmt == "chrome_out":
        assert head["trace_events"] == len(json.loads(body)["traceEvents"])


def test_explain_with_knobs_json_matches_the_reference():
    argv = ["explain", "--platform", "cpu", "--profile", "storm", "--seed",
            "12345", "--cluster", "5", "--ticks", str(TICKS), "--knobs-json",
            json.dumps({"loss_prob": 0.25, "p_crash": 0.03})]
    assert _cli(jax_main, argv)[:2] == _cli(port_main, argv)[:2]
    rc, _, err = _cli(port_main, argv[:-1] + ['{"no_such_knob": 1}'])
    assert rc == 2 and "no_such_knob" in err


def test_explain_usage_errors():
    rc, _, err = _cli(port_main, ["explain", "--platform", "cpu",
                                  "--heartbeat", "hb.jsonl", "--format",
                                  "chrome"])
    assert rc == 2 and "A15" in err
    rc, _, err = _cli(port_main, ["explain", "--platform", "cpu"])
    assert rc == 2 and "--cluster is required" in err


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return _kernel_host.build(tmp_path_factory.mktemp("kernel_host"))


@pytest.mark.parametrize("metrics_on", [False, True])
@pytest.mark.parametrize("which", ["storm", "bug"])
def test_record_host_build_equals_plain(host, which, metrics_on):
    # 8 clusters around the traced one, every tick of the first 60
    profile, bug, seed, cluster = CLUSTERS[which]
    _, cfg = configs(profile, bug, metrics=metrics_on)
    keys = engine.cluster_keys(seed, 8, "cpu", id0=cluster - 3)
    kn = cfg.knobs("cpu")
    s = state.init_cluster(cfg, keys, kn)
    out = torch.empty((8, K8.record_width(cfg)), dtype=torch.int32)
    delivered = 0
    for _ in range(60):
        nxt = engine._advance(cfg, s, keys, kn, 1)
        prev_c, nxt_c = (state.ClusterState(*(x.contiguous() for x in y))
                         for y in (s, nxt))
        K8._launch(cfg, prev_c, nxt_c, out, host, None)
        want = K8.record_plain(s, nxt)
        assert torch.equal(out, want)
        delivered += int(want[:, 8 * cfg.n_nodes:8 * cfg.n_nodes + 5].sum())
        s = nxt
    assert delivered > 0
