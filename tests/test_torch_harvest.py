"""K7, the pool harvest (``kernels/harvest.py``), on the CPU.

Its plain version against the live JAX package's harvest programs
(``engine._harvest_program``, ``_lane_harvest_program`` and
``_cov_harvest_program``, guided and unguided) on the same inputs, under
the partitionable threefry layout: 16 lanes of a broken-quorum storm
(lanes violate mid-chunk), three harvests a run with the port's ticks in
between, wide and packed; every output equal (state, keys, ids, the id
bookkeeping, the snapshot, knob rows, kinds, credits). Then K7's own
device code, built for the host with g++ (``tests/kernel_host_emu.cpp``,
driven through the wrapper's ``_launch``), against the plain version on
planted inputs, both threefry layouts, metrics on and off, and its refill
arithmetic (a true FMA, ``std::fmaf``) against the plain version's
float64 twin over all 2^23 uniforms. Tolerance: exact equality."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _kernel_host
from _torch_parity import configs, single_thread, threefry_layout
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim.config import Knobs as JKnobs
from madraft_tpu.tpusim.state import ClusterState as JState
from madraft_tpu.tpusim.state import PackedClusterState as JPacked
from madraft_tpu_torch.kernels import harvest as K7
from madraft_tpu_torch.kernels import pack as K3
from madraft_tpu_torch.tpusim import config, coverage, engine, prng, state

LANES, SEED, HORIZON = 16, 12345, 48
FIRST_TICKS, CHUNK, HARVESTS = 40, 24, 3


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return _kernel_host.build(tmp_path_factory.mktemp("kernel_host"))


def _jax_state(s, packed: bool, cfg):
    if packed:
        p = K3.pack_state(cfg, s)
        return JPacked(*(jnp.asarray(x.numpy()) for x in p))
    return JState(*(jnp.asarray(x.contiguous().numpy()) for x in s))


def _jax_knobs(kn):
    return JKnobs(*(jnp.asarray(x.numpy()) for x in kn))


def _reference(scheme, jcfg, packed, s, ids, book, cov, pcfg):
    """The reference's harvest program on the port's inputs: (state out,
    keys, ids, book, harvest, knob rows, kinds, new_fps)."""
    static, jkn = jcfg.static_key(), jcfg.knobs()
    args = (_jax_state(s, packed, pcfg),
            jnp.zeros((LANES, 2), jnp.uint32), jnp.asarray(ids.numpy()))
    seed, hz = jnp.asarray(SEED, jnp.uint32), jnp.asarray(HORIZON, jnp.int32)
    if scheme == "monotone":
        out = jengine._harvest_program(static, LANES, packed)(
            *args, jnp.asarray(book.numpy()), seed, jkn, hz)
        return (*out, None, None, None)
    if scheme == "lane":
        out = jengine._lane_harvest_program(static, LANES, None, packed)(
            *args, jnp.asarray(book.numpy()), seed, jkn, hz)
        return (*out, None, None, None)
    bitmap = jnp.asarray((cov.seen != coverage.UNSEEN).any(0).numpy())
    st, keys, new_ids, kn_new, kinds, nf, book_out, h = \
        jengine._cov_harvest_program(static, LANES, cov.ccfg, packed)(
            *args, _jax_knobs(cov.kn_lanes), jnp.asarray(cov.kinds.numpy()),
            jnp.asarray(cov.new_fps.numpy()), bitmap,
            jnp.asarray(book.numpy()), seed, jkn, hz)
    return st, keys, new_ids, book_out, h, kn_new, kinds, nf


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("scheme", ["monotone", "lane", "cov_guided",
                                    "cov_random"])
def test_harvest_equals_the_reference_programs(scheme, packed):
    jcfg, pcfg = configs("storm", majority_override=2)
    with threefry_layout(True):
        keys = engine.cluster_keys(SEED, LANES, "cpu")
        kn = pcfg.knobs("cpu")
        s = engine._advance(pcfg, state.init_cluster(pcfg, keys, kn), keys,
                            kn, FIRST_TICKS)
        ids = torch.arange(LANES, dtype=torch.int32)
        book = (torch.zeros(LANES, dtype=torch.int32) if scheme == "lane"
                else torch.tensor(LANES, dtype=torch.int32))
        cov = None
        if scheme.startswith("cov"):
            seen = torch.full((1, 1 << 10), coverage.UNSEEN, dtype=torch.int32)
            seen[0, ::7] = 3
            cov = K7.Cov(config.CoverageConfig(
                bitmap_bits=1 << 10, guided=scheme == "cov_guided"),
                kn.broadcast(LANES), torch.zeros(LANES, dtype=torch.int32),
                torch.arange(LANES, dtype=torch.int32) % 3, seen)
        retired = []
        for gen in range(HARVESTS):
            want = _reference(scheme.split("_")[0], jcfg, packed, s, ids,
                              book, cov, pcfg)
            got = K7.harvest_plain(pcfg, s, ids, book, SEED, HORIZON, kn,
                                   scheme == "lane", cov)
            jst, jkeys, jids, jbook, jh, jkn, jkinds, jnf = want
            out_state = (K3.pack_state(pcfg, got.state) if packed
                         else got.state)
            for f, x, y in zip(type(jst)._fields, jst, out_state):
                _equal(x, y.numpy(), f"gen {gen} state {f}")
            _equal(np.asarray(jkeys).astype(np.int64), got.keys.numpy(),
                   f"gen {gen} keys")
            _equal(jids, got.ids.numpy(), f"gen {gen} ids")
            _equal(jbook, got.book.numpy(), f"gen {gen} book")
            shapes = tuple(tuple(getattr(s, f).shape[1:])
                           for f in K7.METRIC_ROWS)
            h, cols = engine._fetch(got.snapshot, shapes)
            for f, x in zip(engine.PoolHarvest._fields, h):
                _equal(getattr(jh, f), x, f"gen {gen} snapshot {f}")
            if cov is not None:
                _equal(jh.new_fps, cols[:, 0], "snapshot new_fps")
                _equal(jh.refill_kind, cols[:, 1], "snapshot kinds")
                assert int(jh.seen_bits) == int(cols[0, 2])
                for j, name in enumerate(coverage.MUTABLE_KNOBS):
                    _equal(getattr(jh.knobs, name),
                           cols[:, 3 + j].view(np.float32), f"knobs {name}")
                for f, x, y in zip(jkn._fields, jkn, got.kn_lanes):
                    _equal(x, y.numpy(), f"gen {gen} knob row {f}")
                _equal(jkinds, got.kinds.numpy(), f"gen {gen} kinds")
                _equal(jnf, got.new_fps.numpy(), f"gen {gen} new_fps")
            retired.append(int(h.retired.sum()))
            s = engine._advance(pcfg, got.state, got.keys,
                                kn if cov is None else got.kn_lanes, CHUNK)
            ids, book = got.ids, got.book
            if cov is not None:
                cov = cov._replace(kn_lanes=got.kn_lanes, kinds=got.kinds,
                                   new_fps=got.new_fps + 1)
    # violations in the first harvest, the horizon in the second
    assert 0 < retired[0] < LANES and retired[1] > retired[0], retired


def test_snapshot_rows_are_the_pool_harvests():
    assert K7.METRIC_ROWS == engine.PoolHarvest._fields[9:]
    assert ("retired", "ids", *K7.SCALARS) == tuple(
        f.replace("committed", "shadow_len").replace(
            "snap_installs", "snap_install_count").replace(
            "ticks_run", "tick") for f in engine.PoolHarvest._fields[:9])


@pytest.mark.parametrize("case", ["mixed", "all", "none", "eto_edge"])
@pytest.mark.parametrize("cov_mode", [None, "guided", "random"])
@pytest.mark.parametrize("lane_ids", [False, True])
def test_harvest_host_build_equals_plain(host, case, cov_mode, lane_ids):
    # 100 lanes and a block of 64 threads: the monotone ranks cross warps
    # and carry over tiles
    host.harvest_host_threads(64)
    for metrics_on in (False, True):
        cfg = config.storm_profiles()["storm"][0].replace(metrics=metrics_on)
        for flag in (True, False):
            with prng.layout(flag):
                args = K7.planted_inputs(cfg, 100, case, lane_ids, cov_mode,
                                         5)
                want = K7.harvest_plain(cfg, *args)
                got = K7._launch(cfg, *K7.inputs_to(args, "cpu"), host, None)
                assert not K7.differences(want, got), (metrics_on, flag)
                n = int(want.snapshot[:, 0].sum())
                assert n == {"all": 100, "none": 0}.get(case, n)


@pytest.mark.parametrize("name", ["default", "ground_truth", "other"])
def test_refill_true_fma_equals_the_float64_twin(host, name):
    # the host build's std::fmaf is a true FMA; the plain version forms
    # each FMA in float64 and rounds once: equal over every uniform
    ccfg = {"default": config.CoverageConfig(),
            "ground_truth": config.coverage_ground_truth()[1],
            "other": config.CoverageConfig(mut_span=3.7, fresh_lo=0.1,
                                           fresh_hi=2.9)}[name]
    n = 1 << 23
    mut, fresh = torch.empty(n), torch.empty(n)
    consts = K7.refill_consts(ccfg)
    assert host.refill_grid_launch(consts.ctypes.data, mut.data_ptr(),
                                   fresh.data_ptr(), n, None) == 0
    want_mut, want_fresh = coverage.refill_grid(ccfg)
    assert torch.equal(mut.view(torch.int32), want_mut.view(torch.int32))
    assert torch.equal(fresh.view(torch.int32), want_fresh.view(torch.int32))


def test_pool_rows_do_not_change_with_the_routing(monkeypatch):
    # the A/B's way of routing a pool: engine._advance and engine._harvest
    # patched to a route; the CPU runs the plain versions on either
    cfg = config.storm_profiles()["storm"][0].replace(majority_override=2)
    advance, harvest = engine._advance, engine._harvest
    runs = []
    with threefry_layout(True):
        for tick in ("kernel", "eager"):
            monkeypatch.setattr(engine, "_advance",
                                functools.partial(advance, tick=tick))
            monkeypatch.setattr(engine, "_harvest",
                                functools.partial(harvest, tick=tick))
            rows = []
            engine.run_pool(cfg, 7, 16, 32, chunk_ticks=16, budget_ticks=64,
                            on_retired=rows.append, device="cpu")
            runs.append([{k: v for k, v in r.items()
                          if k not in ("wall_s", "violations_per_s")}
                         for r in rows])
    assert runs[0] == runs[1] and runs[0]
    with pytest.raises(ValueError):
        harvest(cfg, cfg.knobs("cpu"), None, 7, 32, False, False, None,
                tick="fast")
