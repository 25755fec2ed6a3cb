"""K11, the shardkv service tick (``kernels/shardkv.py``,
``csrc/shardkv.cuh``), built for the host with g++
(``tests/shardkv_host_emu.cpp``), against its plain version
(``tpusim/shardkv.py`` ``_shardkv_service_tick``) through the wrapper's
own ``_launch``: every leaf of the new state after every tick of a run,
K11 and K11-metrics, at n = 3, 5 and 7, uniform knobs and [B] knob rows
that mix each planted bug, Puts, the WrongGroup re-query, open-loop Zipf
traffic and two config intervals, one and five groups, 32 clients, more
apply rounds and walker steps than the defaults, states planted at mixed
ticks, both threefry layouts and ragged batch sizes; then the wrapper's
refusals. The host
build runs a phase's lanes one after another, reversed on odd
deployments, on a poisoned region. Skips only where there is no g++.
Tolerance: exact equality."""

import pathlib

import numpy as np
import pytest
import torch

import _kernel_host
from _torch_parity import single_thread
from madraft_tpu_torch.kernels import shardkv as K11
from madraft_tpu_torch.tpusim import engine, prng
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.step import step_cluster

BASE = dict(p_client_cmd=0.0, compact_at_commit=False, log_cap=64,
            compact_every=16, loss_prob=0.1, p_crash=0.01, p_restart=0.2,
            max_dead=1)
TICKS = 90
# name -> (n, shardkv config ("rows": the mixed knob rows), metrics,
# partitionable, deployments)
CASES = {
    "n3": (3, {}, False, True, 5),
    "n5_metrics_legacy": (5, {}, True, False, 4),
    # every kind as a knob row (each bug, Puts, the re-query, open-loop
    # Zipf traffic, mixed intervals), both builds, both layouts
    "mixed_rows": (3, "rows", True, True, 10),
    "mixed_rows_legacy": (5, "rows", False, False, 10),
    "g5_n7_clients32": (7, {"n_groups": 5, "n_clients": 32, "p_put": 0.2},
                        True, True, 3),
    "g1_apply9_walk11": (3, {"n_groups": 1, "apply_max": 9, "walk_max": 11,
                             "bug_serve_frozen": True}, False, True, 5),
}

def knob_rows(kcfg, b: int):
    """[B] shardkv knob rows mixing the planted bugs, Puts, the re-query
    and open-loop Zipf traffic (deployment d: d % 5 == 0 clean)."""
    k = kcfg.knobs().broadcast(b)
    i = torch.arange(b)
    return k._replace(
        bug_skip_freeze=i % 5 == 1, bug_drop_dup_table=i % 5 == 2,
        bug_serve_frozen=i % 5 == 3, requery_wrong_group=i % 2 == 1,
        p_put=torch.where(i % 3 == 1, 0.3, 0.0).float(),
        open_queue_cap=torch.where(i % 5 == 4, 4, 0).int(),
        open_rate=torch.where(i % 5 == 4, 0.4, 0.0).float(),
        zipf_a=torch.where(i % 4 == 0, 2.0, 1.0).float(),
        cfg_interval=torch.where(i % 2 == 0, 20, 14).int())


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("shardkv_host"))
    return {m: _kernel_host.build_shardkv(d, m) for m in (False, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def host_vs_plain(cfg, kcfg, st, keys, kn, skn, lib, ticks: int):
    """``ticks`` ticks on the plain version, K11's host build held against
    it at each; returns (first divergence or None, final state)."""
    table = K11.knob_table(kn, skn, keys.shape[0])
    g = kcfg.n_groups
    gkeys = psk.group_keys(keys, g).reshape(-1, 2)
    gkn = psk._group_knobs(kn, g)
    b = keys.shape[0]
    for t in range(ticks):
        pre = st.rafts
        s = psk._unflat(step_cluster(cfg, psk._flat(pre), gkeys, gkn), b)
        want = psk._shardkv_service_tick(cfg, kcfg, st, pre.alive, pre.base,
                                         s, keys, kn, skn)
        got = K11._launch(cfg, kcfg, st, pre.alive, pre.base, s, keys, table,
                          lib, None)
        d = psk.first_divergence(t, psk.shardkv_state_to_numpy(want),
                                 psk.shardkv_state_to_numpy(got))
        if d is not None:
            return d, want
        st = want
    return None, st


@pytest.mark.parametrize("case", list(CASES))
def test_shardkv_kernel_host_build_equals_plain_every_tick(libs, case):
    n, kw, metrics, partitionable, b = CASES[case]
    cfg = SimConfig(n_nodes=n, metrics=metrics, **BASE)
    kcfg = psk.ShardKvConfig(**({"cfg_interval": 20} if kw == "rows"
                                else {"cfg_interval": 20, **kw}))
    with prng.layout(partitionable):
        keys = engine.cluster_keys(7, b, "cpu")
        kn = cfg.knobs()
        skn = knob_rows(kcfg, b) if kw == "rows" else kcfg.knobs()
        st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        d, final = host_vs_plain(cfg, kcfg, st, keys, kn, skn,
                                 libs[metrics], TICKS)
    assert d is None, d
    assert final.clerk_acked.sum() > 0
    if kw == "rows":
        # the planted bugs' rows violate, the clean rows (d % 5 == 0) not
        viol = final.violations != 0
        assert viol.any() and not viol[torch.arange(b) % 5 == 0].any()
    if kcfg.n_groups > 1:
        assert final.installs_done.sum() > 0
        # five groups reconfigure slower: their GCs come after the run
        assert kcfg.n_groups > 3 or final.deletes_done.sum() > 0


def staging_edges(libs, cfg, kcfg, b: int, misaligned: bool,
                  ticks: int = 16):
    """K11's host build against the plain version on a batch warmed for
    30 ticks, its inputs (the controller cluster's among them) one element
    off their alignment when ``misaligned``: every leaf after each tick."""
    g = kcfg.n_groups
    keys = engine.cluster_keys(19, b, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    gkeys = psk.group_keys(keys, g).reshape(-1, 2)
    gkn = psk._group_knobs(kn, g)
    ckeys = psk.ctrl_keys(keys)
    table = K11.knob_table(kn, skn, b)
    ctrl_mode = kcfg.live_ctrler or kcfg.computed_ctrler
    st = psk._advance_shardkv(cfg, kcfg, psk.init_shardkv_cluster(
        cfg, kcfg, keys, kn, skn), keys, kn, skn, 30)
    for t in range(ticks):
        pre = st.rafts
        s = psk._unflat(step_cluster(cfg, psk._flat(pre), gkeys, gkn), b)
        ctrl = step_cluster(cfg, st.ctrl, ckeys, kn) if ctrl_mode else None
        want = psk._shardkv_service_tick(cfg, kcfg, st, pre.alive, pre.base,
                                         s, keys, kn, skn, ctrl)
        args = (st, pre.alive, pre.base, s, ctrl)
        if misaligned:
            args = tuple(_kernel_host.misaligned(x) for x in args)
        got = K11._launch(cfg, kcfg, *args[:4], keys, table,
                          libs[cfg.metrics], None, args[4])
        d = psk.first_divergence(t, psk.shardkv_state_to_numpy(want),
                                 psk.shardkv_state_to_numpy(got))
        assert d is None, d
        st = want
    return st


@pytest.mark.parametrize("n,misaligned", [(3, True), (7, False),
                                           (7, True)])
def test_shardkv_kernel_host_build_staging_edges(libs, n, misaligned):
    """The staging plan at its edges through the host build, the schedule
    mode's instance: inputs one element off their alignment (word and byte
    rows only, the log rows by words) or aligned (the bulk rows), a ragged
    batch of three, K11-metrics, n = 3 and 7."""
    cfg = SimConfig(n_nodes=n, metrics=True, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=8, p_put=0.2)
    final = staging_edges(libs, cfg, kcfg, 3, misaligned)
    assert final.clerk_acked.sum() > 0


@pytest.mark.parametrize("metrics", [False, True])
def test_shardkv_kernel_host_build_on_states_at_mixed_ticks(libs, metrics):
    """Two storm batches run to different ticks, side by side in one
    batch (a pool's lanes), then ticked on."""
    cfg = SimConfig(n_nodes=5, metrics=metrics, **BASE)
    kcfg = psk.ShardKvConfig(cfg_interval=20, p_put=0.2)
    kn, skn = cfg.knobs(), kcfg.knobs()
    parts = []
    for seed, ticks, b in ((3, 23, 2), (4, 71, 3)):
        keys = engine.cluster_keys(seed, b, "cpu")
        st = psk._advance_shardkv(cfg, kcfg, psk.init_shardkv_cluster(
            cfg, kcfg, keys, kn, skn), keys, kn, skn, ticks)
        parts.append((psk.shardkv_state_to_numpy(st), keys))
    flat = {f: np.concatenate([parts[0][0][f], parts[1][0][f]])
            for f in parts[0][0]}
    st = psk.shardkv_state_from_numpy(flat)
    keys = torch.cat([parts[0][1], parts[1][1]])
    assert len(set(st.rafts.tick[:, 0].tolist())) == 2
    d, _ = host_vs_plain(cfg, kcfg, st, keys, kn, skn, libs[metrics], 30)
    assert d is None, d


def test_shardkv_kernel_refuses_what_it_does_not_take(libs):
    cfg = SimConfig(n_nodes=3, **BASE)
    kcfg = psk.ShardKvConfig()
    keys = engine.cluster_keys(1, 2, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    s = st.rafts
    table = K11.knob_table(kn, skn, 2)
    args = (cfg, kcfg, st, s.alive, s.base, s, keys, table)
    # the metrics build refuses a metrics-off state (its descriptor check)
    with pytest.raises(RuntimeError, match="shardkv_launch"):
        K11._launch(*args, libs[True], None)
    bad = st._replace(last_seq=st.last_seq.to(torch.int64))
    with pytest.raises(ValueError, match="last_seq"):
        K11._launch(cfg, kcfg, bad, *args[3:], libs[False], None)
    with pytest.raises(ValueError, match="keys"):
        K11._launch(*args[:6], keys[:1], table, libs[False], None)
    with pytest.raises(ValueError, match="n_groups <= 8"):
        K11._launch(cfg, kcfg.replace(n_groups=9), *args[2:], libs[False],
                    None)
    with pytest.raises(ValueError, match="n_configs"):
        K11.check_shape(cfg, kcfg.replace(n_configs=65))
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        K11.shardkv_tick(cfg, kcfg, st, s.alive, s.base,
                         s._replace(tick=s.tick.to("meta")), keys, kn, skn)
