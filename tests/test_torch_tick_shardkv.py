"""K6-shardkv on the CPU: a deployment a block, its groups' and its
controller's raft ticks then K11's service tick, each tick of a chunk
(``kernels/shardkv.py`` ``shardkv_chunk``, ``csrc/tick.cuh``
``run_deployment`` on ``csrc/shardkv.cuh``'s phases), its device code
built for the host with g++ (``tests/tick_host_emu.cpp`` with
``-DMADRAFT_K6_SHARDKV``, the plain and metrics builds, once a run) and
driven through the wrapper's own marshalling (``kernels.shardkv.
_chunk_launch``):

- every ``ShardKvState`` leaf, the group rafts' and the controller's
  included, equals ``shardkv_chunk_plain``'s (``shardkv_step``'s eager
  route) after every launch from init, in all three modes, metrics on and
  off, both threefry layouts, n = 3, 5 and 7 (n = 5 at cap 64 the builds'
  template instance, the rest the runtime one), with
  ``chip_smoke.SHARDKV_ROW_CASES`` (and a controller mode's bug) as [B]
  knob rows, with a deployment whose tile count is odd (its last tile a
  copy of group 0 that writes nothing) and with eight groups and the
  controller (five warps), at a shape whose clusters' blocks go to device
  memory (n = 16, cap 256), and on a run in which a group installs a
  pulled shard on a tick on which another group compacts;
- ``tpusim.shardkv._advance_shardkv``'s chunking (a launch of 256 ticks
  and one of 44) gives the CPU route's final state;
- the host build equals the live JAX package's ``shardkv_step`` over a
  storm batch's first ticks, leaf by leaf;
- the builds refuse what they do not take.
Tolerance: exact equality."""

import pytest
import torch

import _tick_host
import chip_smoke
import test_torch_shardkv as tsk
from _torch_parity import single_thread, threefry_layout
from madraft_tpu_torch.kernels import shardkv as K11
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import shardkv as psk
from madraft_tpu_torch.tpusim.config import SimConfig

SEED = 1
# the compared launches' lengths, from init
LAUNCHES = (20, 8, 1, 11)
# the CLI's storm at cap 64, and a fast-compacting cap 16 ring
STORM = dict(p_client_cmd=0.0, compact_at_commit=False, loss_prob=0.1,
             p_crash=0.01, p_restart=0.2, max_dead=1)
CAP = {16: dict(log_cap=16, compact_every=4),
       64: dict(log_cap=64, compact_every=16),
       256: dict(log_cap=256, compact_every=64)}
# name -> (n, cap, shardkv config, metrics, partitionable, deployments);
# "rows" in the config: chip_smoke.shardkv_knob_rows' [B] rows
CASES = {
    # every row case a deployment, at the builds' template instance
    "schedule_rows_n5_metrics": (5, 64, {"rows": True}, True, True, 7),
    "schedule_n3_metrics_legacy": (3, 16, {}, True, False, 1),
    "live_stale_read_n5_metrics_legacy": (
        5, 64, {"live_ctrler": True, "bug_stale_ctrler_read": True,
                "p_phantom": 0.5}, True, False, 1),
    "computed_rotate_n7": (7, 16, {"computed_ctrler": True, "n_groups": 4,
                                   "bug_rotate_tiebreak": True}, False, True,
                           1),
    "computed_n3_metrics_legacy": (3, 64, {"computed_ctrler": True}, True,
                                   False, 1),
    # eight groups and the controller: nine tiles and a copy, five warps
    "live_g8_clients8": (3, 16, {"live_ctrler": True, "n_groups": 8,
                                 "n_clients": 8}, False, True, 1),
    # the clusters' blocks past what a block's shared memory holds (no
    # faults: sixteen nodes elect and commit within the launches)
    "schedule_n16_cap256": (16, 256, {"n_groups": 2}, True, True, 1),
    # a group installs a pulled shard on ticks on which another group
    # compacts (ticks 40-47 at this seed)
    "install_while_compacting": (3, 16, {}, False, True, 2),
}
# a case's launches where they are not LAUNCHES, its cfg_interval where it
# is not 10
CASE_LAUNCHES = {"install_while_compacting": (24, 8, 16)}
CASE_INTERVAL = {"install_while_compacting": 12}


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """K6-shardkv's plain and metrics builds for the host, by metrics."""
    libs = _tick_host.build(tmp_path_factory.mktemp("tick_shardkv"),
                            ("tick_shardkv", "tick_metrics_shardkv"))
    return {m: libs[K11.chunk_variant(m)] for m in (False, True)}


def launch(lib, cfg, kcfg, st, keys, kn, skn, m: int):
    """One K6-shardkv launch of m ticks on the host build ``lib``."""
    tables = K11.chunk_tables(cfg, kcfg, kn, skn, keys.shape[0])
    return K11._chunk_launch(cfg, kcfg, st, keys, m, tables, lib, None)


def installs_while_compacting(cfg, kcfg, st, keys, kn, skn, m: int) -> int:
    """The ticks of the plain route's next m on which a group installs a
    pulled shard (a node's phase goes from pulling to owned) while another
    group of the deployment compacts (a live node's base moves)."""
    hits = 0
    for _ in range(m):
        pre_phase, pre_base = st.phase, st.rafts.base
        st = psk.shardkv_step(cfg, kcfg, st, keys, kn, skn, tick="eager")
        inst = ((pre_phase == 2) & (st.phase == 1)).flatten(2).any(2)
        comp = ((st.rafts.base != pre_base) & st.rafts.alive).any(2)
        other = comp.sum(1, keepdim=True) - comp.int() > 0
        hits += int((inst & other).any())
    return hits


def case_configs(case):
    n, cap, kw, metrics, flag, b = CASES[case]
    kw = dict(kw)
    rows = kw.pop("rows", False)
    quiet = dict(loss_prob=0.0, p_crash=0.0) if n == 16 else {}
    cfg = SimConfig(n_nodes=n, metrics=metrics, **{**STORM, **CAP[cap],
                                                   **quiet})
    kcfg = psk.ShardKvConfig(cfg_interval=CASE_INTERVAL.get(case, 10), **kw)
    return cfg, kcfg, rows, flag, b


@pytest.mark.parametrize("case", list(CASES))
def test_k6_shardkv_equals_the_plain_route_after_every_launch(host, case):
    cfg, kcfg, rows, flag, b = case_configs(case)
    with threefry_layout(flag):
        keys = pengine.cluster_keys(SEED, b, "cpu")
        kn = cfg.knobs()
        skn = chip_smoke.shardkv_knob_rows(kcfg, b) if rows else kcfg.knobs()
        st = start = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
        done = 0
        for m in CASE_LAUNCHES.get(case, LAUNCHES):
            got = launch(host[cfg.metrics], cfg, kcfg, st, keys, kn, skn, m)
            want = K11.shardkv_chunk_plain(cfg, kcfg, st, keys, kn, skn, m)
            done += m
            d = psk.first_divergence(done, psk.shardkv_state_to_numpy(want),
                                     psk.shardkv_state_to_numpy(got))
            assert d is None, d
            st = want
        if case == "install_while_compacting":
            assert installs_while_compacting(cfg, kcfg, start, keys, kn, skn,
                                             done) > 0
    if cfg.n_nodes == 16:  # sixteen nodes elect and commit, acks come later
        assert (st.rafts.commit > 0).any(), "nothing committed"
    else:
        assert st.clerk_acked.sum() > 0, "no op acked"


def test_k6_shardkv_chunks_of_a_long_run(host, monkeypatch):
    """300 ticks through ``_advance_shardkv`` on the kernel route: a
    K6-shardkv launch of 256 ticks and one of 44 (the host build standing
    in for the card's), equal to the CPU route's run: one group, one warp
    of the host build, at the builds' template instance."""
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[64])
    kcfg = psk.ShardKvConfig(n_groups=1, cfg_interval=12)
    keys = pengine.cluster_keys(SEED, 1, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    want = psk._advance_shardkv(cfg, kcfg, st, keys, kn, skn, 300)
    ms = []

    def shardkv_chunk(cfg_, kcfg_, st_, keys_, kn_, skn_, m, tables):
        ms.append(m)
        return K11._chunk_launch(cfg_, kcfg_, st_, keys_, m, tables,
                                 host[False], None)

    monkeypatch.setattr(pengine, "tick_route", lambda *a, **k: "kernel")
    monkeypatch.setattr(K11, "shardkv_chunk", shardkv_chunk)
    got = psk._advance_shardkv(cfg, kcfg, st, keys, kn, skn, 300)
    assert ms == [pengine.KERNEL_CHUNK, 300 - pengine.KERNEL_CHUNK]
    d = psk.first_divergence(300, psk.shardkv_state_to_numpy(want),
                             psk.shardkv_state_to_numpy(got))
    assert d is None, d
    assert want.clerk_acked.sum() > 0


def test_k6_shardkv_equals_the_reference_shardkv_step(host):
    """The JAX shardkv tests' storm batch (a deployment a row case, n = 3)
    from init:
    the host build's state after each launch equals the live JAX
    ``shardkv_step``'s, leaf by leaf."""
    with threefry_layout(True):
        pair = tsk.ShardKvPair({}, 3, False, len(tsk.KINDS), 6, rows=True)
        st, done = pair.ps, 0
        for m in (16, 8):
            for _ in range(m):
                pair.js = pair._jstep(pair.js, pair.jkeys, pair.jkn,
                                      pair.jskn)
            st = launch(host[False], pair.pcfg, pair.pk, st, pair.pkeys,
                        pair.pkn, pair.pskn, m)
            done += m
            d = psk.first_divergence(done, tsk.jax_flat(pair.js),
                                     psk.shardkv_state_to_numpy(st))
            assert d is None, d
        assert (st.rafts.role == 2).any(), "no group elected a leader"


def test_k6_shardkv_refuses_what_it_does_not_take(host):
    cfg = SimConfig(n_nodes=5, **STORM, **CAP[64])
    kcfg = psk.ShardKvConfig()
    keys = pengine.cluster_keys(1, 2, "cpu")
    kn, skn = cfg.knobs(), kcfg.knobs()
    st = psk.init_shardkv_cluster(cfg, kcfg, keys, kn, skn)
    # the metrics build refuses a metrics-off state
    with pytest.raises(RuntimeError, match="shardkv_chunk_launch"):
        launch(host[True], cfg, kcfg, st, keys, kn, skn, 4)
    # shapes past K11's limits, a leaf on another device
    with pytest.raises(ValueError, match="n_clients <= 32"):
        launch(host[False], cfg, kcfg.replace(n_clients=40), st, keys, kn,
               skn, 4)
    with pytest.raises(ValueError, match="clerk_seq"):
        launch(host[False], cfg, kcfg,
               st._replace(clerk_seq=st.clerk_seq.to(torch.int64)), keys, kn,
               skn, 4)
    with pytest.raises(ValueError, match="tick_chunk: term"):
        launch(host[False], cfg, kcfg, st._replace(rafts=st.rafts._replace(
            term=st.rafts.term[:, :, :4])), keys, kn, skn, 4)
