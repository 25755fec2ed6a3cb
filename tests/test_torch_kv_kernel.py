"""K9, the kv service tick (``kernels/kv.py``, ``csrc/kv.cuh``), built for
the host with g++ (``tests/kv_host_emu.cpp``), against its plain version
(``tpusim/kv.py`` ``_kv_service_tick``) through the wrapper's own
``_launch``: every leaf of the new state after every tick of a run, K9
and K9-metrics, at n = 3, 5 and 7, under every planted kv bug, with Puts,
hint following, the open loop with the Zipf key, [B] knob rows that mix
the bugs, 32 clients and 64 keys, 11 apply rounds, states planted at
mixed ticks, both threefry layouts and ragged batch sizes; then the
wrapper's refusals. The host build runs a phase's lanes one after
another, reversed on odd clusters, on a poisoned region. Skips only where
there is no g++. Tolerance: exact equality."""

import pathlib

import pytest
import torch

import _kernel_host
import chip_smoke
from _torch_parity import single_thread
from madraft_tpu_torch.kernels import kv as K9
from madraft_tpu_torch.tpusim import engine, prng
from madraft_tpu_torch.tpusim import kv as pkv
from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.step import step_cluster

BASE = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
            p_crash=0.01, p_restart=0.2, max_dead=2, p_repartition=0.02,
            p_heal=0.05, log_cap=32, compact_every=8)
HOT_KEY = dict(open_rate=0.25, zipf_a=3.0, open_queue_cap=8, p_get=0.3,
               p_put=0.2)
TICKS = 80
# name -> (n, kv knobs, metrics, partitionable, clusters)
CASES = {
    "n3": (3, {}, False, True, 13),
    "n7_metrics_legacy": (7, {"p_put": 0.2}, True, False, 9),
    "skip_dedup": (5, {"bug_skip_dedup": True}, True, True, 13),
    "apply_uncommitted": (5, {"bug_apply_uncommitted": True}, False, False,
                          13),
    "stale_read": (5, {"bug_stale_read": True, "p_get": 0.5, "p_put": 0.2},
                   True, False, 11),
    "stale_hint_hints": (5, {"bug_stale_hint": True, "p_follow_hint": 0.9,
                             "retry_wait": 3}, True, True, 13),
    "hot_key_openloop": (5, HOT_KEY, True, True, 17),
    "mixed_rows": (5, "rows", True, True, 16),
    "mixed_rows_off": (7, "rows", False, False, 16),
    # 32 clients and 64 keys: the widest tables, a warp's every lane a
    # clerk
    "wide_tables": (7, {"n_clients": 32, "n_keys": 64, "p_put": 0.2}, True,
                    True, 9),
    # more apply rounds than the kernel loads ahead of the first
    "apply_max_11": (5, {"apply_max": 11, "p_put": 0.2,
                         "bug_skip_dedup": True}, True, False, 13),
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("kv_host"))
    return {m: _kernel_host.build_kv(d, m) for m in (False, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def cat(a, b):
    """Two kv states' batches, one after the other."""
    return pkv.KvState(type(a.raft)(*(torch.cat(x) for x in zip(a.raft, b.raft))),
                       *(torch.cat(x) for x in zip(a[1:], b[1:])))


def host_vs_plain(cfg, kcfg, ks, keys, kn, kkn, lib, ticks: int):
    """``ticks`` ticks on the plain version, K9's host build held against
    it at each; returns (first divergence or None, final state)."""
    table = K9.knob_table(kn, kkn, keys.shape[0])
    for t in range(ticks):
        pre = ks.raft
        s = step_cluster(cfg, pre, keys, kn)
        want = pkv._kv_service_tick(cfg, kcfg, ks, pre.alive, pre.base,
                                    pre.shadow_len, s, keys, kn, kkn)
        got = K9._launch(cfg, kcfg, ks, pre.alive, pre.base, pre.shadow_len,
                         s, keys, table, lib, None)
        d = pkv.first_divergence(t, pkv.kv_state_to_numpy(want),
                                 pkv.kv_state_to_numpy(got))
        if d is not None:
            return d, want
        ks = want
    return None, ks


@pytest.mark.parametrize("case", list(CASES))
def test_kv_kernel_host_build_equals_plain_every_tick(libs, case):
    n, kw, metrics, partitionable, b = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **BASE)
    kcfg = pkv.KvConfig(**({} if kw == "rows" else kw))
    with prng.layout(partitionable):
        keys = engine.cluster_keys(11, b, "cpu")
        kn = cfg.knobs()
        kkn = (chip_smoke.kv_knob_rows(kcfg, b) if kw == "rows"
               else kcfg.knobs())
        ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
        d, final = host_vs_plain(cfg, kcfg, ks, keys, kn, kkn,
                                 libs[metrics], TICKS)
    assert d is None, d
    assert final.clerk_acked.sum() > 0
    if kw == "rows":
        viol = final.raft.violations != 0
        assert viol.any() and not viol[torch.arange(b) % 5 == 0].any()


@pytest.mark.parametrize("metrics", [False, True])
def test_kv_kernel_host_build_on_states_at_mixed_ticks(libs, metrics):
    """Two storm batches run to different ticks, side by side in one
    batch (a pool's lanes), then ticked on."""
    cfg = SimConfig(n_nodes=5, metrics=metrics, **BASE)
    kcfg = pkv.KvConfig(p_put=0.2, bug_stale_read=True)
    kn, kkn = cfg.knobs(), kcfg.knobs()
    parts = []
    for seed, ticks, b in ((3, 23, 6), (4, 71, 7)):
        keys = engine.cluster_keys(seed, b, "cpu")
        ks = pkv._advance_kv(cfg, kcfg, pkv.init_kv_cluster(
            cfg, kcfg, keys, kn), keys, kn, kkn, ticks)
        parts.append((ks, keys))
    ks, keys = cat(parts[0][0], parts[1][0]), torch.cat([parts[0][1],
                                                         parts[1][1]])
    assert len(set(ks.raft.tick.tolist())) == 2
    d, _ = host_vs_plain(cfg, kcfg, ks, keys, kn, kkn, libs[metrics], 40)
    assert d is None, d


def test_kv_kernel_refuses_what_it_does_not_take(libs):
    cfg = SimConfig(n_nodes=5, **BASE)
    kcfg = pkv.KvConfig()
    keys = engine.cluster_keys(1, 4, "cpu")
    kn, kkn = cfg.knobs(), kcfg.knobs()
    ks = pkv.init_kv_cluster(cfg, kcfg, keys, kn)
    s = step_cluster(cfg, ks.raft, keys, kn)
    table = K9.knob_table(kn, kkn, 4)
    args = (cfg, kcfg, ks, ks.raft.alive, ks.raft.base, ks.raft.shadow_len,
            s, keys, table)
    # the metrics build refuses a metrics-off state (its descriptor check)
    with pytest.raises(RuntimeError, match="kv_launch"):
        K9._launch(*args, libs[True], None)
    bad = ks._replace(clerk_seq=ks.clerk_seq.to(torch.int64))
    with pytest.raises(ValueError, match="clerk_seq"):
        K9._launch(cfg, kcfg, bad, *args[3:], libs[False], None)
    with pytest.raises(ValueError, match="keys"):
        K9._launch(*args[:7], keys[:3], table, libs[False], None)
    with pytest.raises(ValueError, match="n_keys"):
        K9._launch(cfg, kcfg.replace(n_keys=128), *args[2:], libs[False],
                   None)
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        K9.kv_tick(cfg, kcfg, ks, ks.raft.alive, ks.raft.base,
                   ks.raft.shadow_len, s._replace(tick=s.tick.to("meta")),
                   keys, kn, kkn)
