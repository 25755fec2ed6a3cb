"""K6-kv on the CPU: K6 with the kv service tick after each raft tick of
a chunk (``kernels/kv.py`` ``kv_chunk``, ``csrc/tick.cuh`` ``kv_tick`` on
``csrc/kv.cuh``'s phases), its device code built for the host with g++
(``tests/tick_host_emu.cpp`` with ``-DMADRAFT_K6_KV``, the plain and
metrics builds, module-scoped) and driven through the wrapper's own
marshalling (``kernels.tick._launch(..., side=kernels.kv.Side(...))``):

- every ``KvState`` leaf, the raft leaves included, equals the plain
  route's (``step_cluster``, then ``_kv_service_tick``) after every
  launch (from a state 24 ticks in), at n = 3, 5 and 7 (the template
  instances) and at a runtime shape, under each kv service bug and a
  raft bug, with 32 clients and 64 keys (two clerks a lane), the open
  loop with the Zipf key, metrics on and off, both threefry layouts,
  ticks across the int32 wrap, each in batches of three clusters (the
  second warp holds a tile past the batch's end);
- ``tpusim.kv._advance_kv``'s chunking (K6-kv launches of up to
  ``engine.KERNEL_CHUNK`` ticks: 300 ticks in a launch of 256 and a short
  one of 44) gives the CPU route's final state;
- the host build equals the live JAX package's ``kv_step`` over a storm
  batch's first ticks, leaf by leaf;
- a shape past the kernels' limits is refused for a CUDA device before
  anything is allocated there (``engine.check_card_shape``).
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import _tick_host
import test_torch_kv as tkv
from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import kv as jkv
from madraft_tpu.tpusim.config import SimConfig as JaxCfg
from madraft_tpu_torch.kernels import kv as K9
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import kv as pkv
from madraft_tpu_torch.tpusim.config import SimConfig

I32 = torch.int32
SEED = 11
# the ticks a case runs on K6-kv before the compared launches
WARM = 24
# lanes whose ticks cross the int32 wrap, the u32 wrap, and neither
WRAP_TICKS = (2**31 - 10, -20, 1000)
# the kv tests' storm faults, at the compaction pace of each ring
STORM = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
             p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
             p_heal=0.05)
CAP = {16: dict(log_cap=16, compact_every=4, uncommitted_cap=4),
       32: dict(log_cap=32, compact_every=8),
       64: dict(log_cap=64, compact_every=16)}
HOT_KEY = dict(open_rate=0.25, zipf_a=3.0, open_queue_cap=8, p_get=0.3,
               p_put=0.2)
# name -> (n, cap, kv knobs, raft overrides, metrics, partitionable)
CASES = {
    "n3_cap16_tick_wraps": (3, 16, {"p_put": 0.2}, {}, False, True),
    "n5_cap64_metrics_hot_key_openloop": (5, 64, HOT_KEY, {}, True, True),
    "n7_cap64_metrics_legacy": (7, 64, {}, {}, True, False),
    "n4_cap32_runtime": (4, 32, {"p_put": 0.2}, {}, True, True),
    "skip_dedup": (5, 16, {"bug_skip_dedup": True}, {}, True, False),
    "apply_uncommitted": (5, 16, {"bug_apply_uncommitted": True}, {}, False,
                          True),
    "stale_read": (5, 64, {"bug_stale_read": True, "p_get": 0.5,
                           "p_put": 0.2}, {}, True, True),
    "stale_hint": (3, 64, {"bug_stale_hint": True, "p_follow_hint": 0.9,
                           "retry_wait": 3}, {}, False, False),
    "raft_bug_ack_before_fsync": (5, 16, {}, {"bug": "ack_before_fsync"},
                                  True, True),
    "wide_tables": (7, 16, {"n_clients": 32, "n_keys": 64, "p_put": 0.2},
                    {}, True, True),
}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """K6-kv's plain and metrics builds for the host, by build name."""
    return _tick_host.build(tmp_path_factory.mktemp("tick_kv"),
                            ("tick_kv", "tick_metrics_kv"))


def launch(lib, cfg, kcfg, ks, keys, kn, kkn, m: int):
    """One K6-kv launch of m ticks on the host build ``lib``."""
    b = keys.shape[0]
    out, launched = K6._launch(
        cfg, ks.raft, keys, kn, m, lib, None, table=K6.knob_table(kn, b),
        side=K9.Side(cfg, kcfg, ks, K9.knob_table(kn, kkn, b)))
    assert launched
    return out


def chunks_vs_plain(lib, cfg, kcfg, ks, keys, kn, kkn, chunks):
    """K6-kv (the host build) and the plain route from ``ks``, a launch of
    each of ``chunks`` ticks: every leaf equal after every launch. Returns
    the final state."""
    done = 0
    for m in chunks:
        got = launch(lib, cfg, kcfg, ks, keys, kn, kkn, m)
        want = K9.kv_chunk_plain(cfg, kcfg, ks, keys, kn, kkn, m)
        done += m
        d = pkv.first_divergence(done, pkv.kv_state_to_numpy(want),
                                 pkv.kv_state_to_numpy(got))
        assert d is None, d
        ks = want
    return ks


@pytest.mark.parametrize("case", list(CASES))
def test_k6_kv_equals_the_plain_route_after_every_launch(host, case):
    n, cap, kw, raft, metrics, flag = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **STORM, **CAP[cap], **raft)
    kcfg = pkv.KvConfig(**kw)
    assert K6.instance(cfg) == (0 if "runtime" in case else
                                1 + K6.SHAPES.index((n, cap)))
    b = 3
    with threefry_layout(flag):
        keys = pengine.cluster_keys(SEED, b, "cpu")
        kn, kkn = cfg.knobs(), kcfg.knobs()
        ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
        if case.endswith("tick_wraps"):
            ks = ks._replace(raft=ks.raft._replace(tick=torch.tensor(
                WRAP_TICKS, dtype=I32)))
        lib = host[K6.variant(metrics, False, kv=True)]
        # past the first elections on K6-kv itself (from init, every launch
        # is held to the plain route in the long run and the JAX case),
        # then launches of 8, 1 and 11 ticks held to the plain route
        ks = launch(lib, cfg, kcfg, ks, keys, kn, kkn, WARM)
        final = chunks_vs_plain(lib, cfg, kcfg, ks, keys, kn, kkn,
                                (8, 1, 11))
    assert final.clerk_acked.sum() > 0, "no op acked"
    if case == "stale_read":
        assert (final.raft.violations != 0).any(), "the oracle never fired"


def test_k6_kv_chunks_of_a_long_run(host, monkeypatch):
    """300 ticks through ``_advance_kv`` on the kernel route: a K6-kv
    launch of 256 ticks and one of 44 (the host build standing in for the
    card's), equal to the CPU route's run."""
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[16])
    kcfg = pkv.KvConfig(p_put=0.2)
    keys = pengine.cluster_keys(SEED, 3, "cpu")
    kn, kkn = cfg.knobs(), kcfg.knobs()
    ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
    want = pkv._advance_kv(cfg, kcfg, ks, keys, kn, kkn, 300)
    ms = []

    def kv_chunk(cfg_, kcfg_, ks_, keys_, kn_, kkn_, m, table, ktable):
        ms.append(m)
        return launch(host["tick_kv"], cfg_, kcfg_, ks_, keys_, kn_, kkn_,
                      m)

    monkeypatch.setattr(pengine, "tick_route", lambda *a, **k: "kernel")
    monkeypatch.setattr(K9, "kv_chunk", kv_chunk)
    got = pkv._advance_kv(cfg, kcfg, ks, keys, kn, kkn, 300)
    assert ms == [pengine.KERNEL_CHUNK, 300 - pengine.KERNEL_CHUNK]
    d = pkv.first_divergence(300, pkv.kv_state_to_numpy(want),
                             pkv.kv_state_to_numpy(got))
    assert d is None, d
    assert want.clerk_acked.sum() > 0


def test_k6_kv_equals_the_reference_kv_step(host):
    """A storm batch (the JAX kv tests' config) from init: the host build's
    state after each launch equals the live JAX ``kv_step``'s, leaf by
    leaf."""
    with threefry_layout(True):
        jcfg = JaxCfg(**tkv.BASE, metrics=False)
        cfg = SimConfig(**tkv.BASE, metrics=False)
        jk, kcfg = jkv.KvConfig(), pkv.KvConfig()
        init, step = tkv._jax_programs(jcfg, jk.static_key(), True)
        jkeys = jengine._cluster_keys(np.uint32(tkv.SEED), tkv.CLUSTERS)
        jkn, jkkn = jcfg.knobs(), jk.knobs()
        keys = pengine.cluster_keys(tkv.SEED, tkv.CLUSTERS, "cpu")
        kn, kkn = cfg.knobs("cpu"), kcfg.knobs("cpu")
        js = init(jkeys)
        ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
        done = 0
        for m in (7, 9):
            for _ in range(m):
                js = step(js, jkeys, jkn, jkkn)
            ks = launch(host["tick_kv"], cfg, kcfg, ks, keys, kn, kkn, m)
            done += m
            d = pkv.first_divergence(done, tkv.jax_flat(js),
                                     pkv.kv_state_to_numpy(ks))
            assert d is None, d


def test_k6_kv_refuses_what_it_does_not_take(host):
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[16])
    kcfg = pkv.KvConfig()
    keys = pengine.cluster_keys(1, 3, "cpu")
    kn, kkn = cfg.knobs(), kcfg.knobs()
    ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
    side = K9.Side(cfg, kcfg, ks, K9.knob_table(kn, kkn, 3))
    # the metrics build refuses a metrics-off state, the kv build a launch
    # without the kv side or with trace rows
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_metrics_kv"], None,
                   side=side)
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_kv"], None)
    rows = torch.zeros((4, 3, K6.K8.record_width(cfg)), dtype=I32)
    with pytest.raises(RuntimeError, match="tick_launch"):
        K6._launch(cfg, ks.raft, keys, kn, 4, host["tick_kv"], None,
                   trace=rows, side=side)
    with pytest.raises(ValueError, match="n_keys"):
        K9.Side(cfg, kcfg.replace(n_keys=128), ks, side.table)
    with pytest.raises(ValueError, match="clerk_seq"):
        K9.Side(cfg, kcfg, ks._replace(clerk_seq=ks.clerk_seq.to(
            torch.int64)), side.table)


@pytest.mark.parametrize("verb", ["fuzz", "kv", "ctrler", "shardkv"])
def test_shapes_past_the_kernels_limits_are_refused_on_the_card(
        verb, monkeypatch):
    """A program for a CUDA device refuses, before it allocates anything
    there, a shape past its kernels' limits, naming the limit and the CPU
    route (``engine.check_card_shape``); the CPU takes the same shape.
    Here the card is a stand-in: ``torch.cuda.is_available`` says yes, and
    a program that got past the check would fail at its first allocation
    with another error than ValueError."""
    from madraft_tpu_torch.tpusim import ctrler as pctrler
    from madraft_tpu_torch.tpusim import shardkv as pshardkv

    base = pcfg.storm_profiles()["storm"][0]
    if verb == "fuzz":
        kcfg, svc = None, {}
        make = (lambda c, k, dev:
                pengine.make_fuzz_fn(c, 8, 64, device=dev))
    else:
        mod = {"kv": pkv, "ctrler": pctrler, "shardkv": pshardkv}[verb]
        kcfg = {"kv": pkv.KvConfig, "ctrler": pctrler.CtrlerConfig,
                "shardkv": pshardkv.ShardKvConfig}[verb]()
        base = base.replace(p_client_cmd=0.0, compact_at_commit=False)
        svc = {"n_clients": kcfg.replace(n_clients=33)}
        make = getattr(mod, f"make_{verb}_fuzz_fn")
        make = (lambda c, k, dev, make=make: make(c, k, 8, 64, device=dev))
    past = {"n": base.replace(n_nodes=17), "cap": base.replace(log_cap=512),
            "ae_max": base.replace(ae_max=65)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for what, c in past.items():
        with pytest.raises(ValueError, match="--platform cpu"):
            make(c, kcfg, "cuda")
    for what, k in svc.items():
        with pytest.raises(ValueError, match=f"{what} <= .*--platform cpu"):
            make(base, k, "cuda")
    # a shape the kernels take gets past the check, and the CPU runs any
    pengine.check_card_shape(torch.device("cuda"), base)
    assert make(past["n"], kcfg, "cpu").device.type == "cpu"
