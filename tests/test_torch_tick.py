"""Kernel K6 (``kernels/tick.py``, ``csrc/tick.{cu,cuh}``) on the CPU: its
tables against the tick and the header, the engine's route, and the
chunk against the live JAX reference.

- the draw-offset table equals the words a recording ``_DrawBlock`` sees a
  plain tick take, at n = 3, 5, 7 under every planted bug;
- the knob table round-trips ``Knobs``, 0-d and [B], bit for bit;
- the leaf table covers every non-metric ``ClusterState`` leaf with its
  dtype and shape, and ``csrc/tick.cuh``'s enums mirror the tables;
- ``engine.tick_route`` picks K6 on a CUDA device for every config, the
  eager tick on the CPU or when asked for;
- ``tick_chunk`` on the CPU (its plain version) over three chunks, the last
  one ragged, equals the JAX reference at every chunk edge, with uniform
  and [B] knobs, under an explicit threefry layout;
- the kernel's device code built for the host (``tests/tick_host_emu.cpp``,
  a warp as 32 threads) equals the plain version, through the wrapper's
  own marshalling: every template instance and the runtime one, both
  threefry layouts, lanes at their own ticks and ticks across the int32
  and u32 wraps; the words it draws equal ``tick_blocks_plain``'s, and it
  picks the instance ``K6.instance`` names.
Tolerance: exact equality."""

import functools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
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
from madraft_tpu.tpusim import config as jcfg
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim.state import init_cluster as jax_init
from madraft_tpu.tpusim.step import step_cluster as jax_step
from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim import state as pstate
from madraft_tpu_torch.tpusim import step as pstep

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADER = ROOT / "madraft_tpu_torch" / "csrc" / "tick.cuh"
LANES, SEED, CHUNK, TICKS = 16, 21, 16, 40  # chunks of 16, 16, 8


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


def knob_rows() -> dict:
    """field -> numpy [LANES] knob row of the reference's dtype: lanes take
    their rows from four storm profiles in turn, the quorum varied too."""
    profiles = ("storm", "gray_storm", "limp", "fsync_stall")
    rows = {}
    for lane in range(LANES):
        kn = jcfg.storm_profiles()[profiles[lane % 4]][0].knobs()
        for f, x in zip(kn._fields, kn):
            rows.setdefault(f, []).append(np.asarray(x))
    rows = {f: np.stack(v) for f, v in rows.items()}
    lane = np.arange(LANES)
    rows["majority"] = np.array([3, 2, 3, 4], np.int32)[lane % 4]
    rows["compact_at_commit"] = lane % 2 == 0
    rows["fsync_every"] = (1 + lane % 3).astype(np.int32)
    return rows


def port_rows(rows: dict) -> pcfg.Knobs:
    return pcfg.Knobs(**{f: torch.from_numpy(v.copy()) for f, v in rows.items()})


def knobs_from_table(f: torch.Tensor, i: torch.Tensor) -> pcfg.Knobs:
    """The inverse of ``K6.knob_table``: [B] rows of the Knobs dtypes."""
    cols = {k: f[:, j] for j, k in enumerate(K6.KNOB_F32)}
    cols.update({k: i[:, j] for j, k in enumerate(K6.KNOB_I32)})
    cols["compact_at_commit"] = cols["compact_at_commit"] != 0
    return pcfg.Knobs(**{k: cols[k].contiguous() for k in pcfg.Knobs._fields})


class Recording(pstep._DrawBlock):
    """A draw block that records each (offset, size) it takes."""

    taken: list = []

    def _take(self, shape):
        out = super()._take(shape)
        Recording.taken.append((self.off - out[0].numel(), out[0].numel()))
        return out


@pytest.mark.parametrize("bug", pcfg.RAFT_BUGS)
@pytest.mark.parametrize("n_nodes", [3, 5, 7])
def test_draw_offsets_follow_the_ticks_draws(monkeypatch, n_nodes, bug):
    cfg = pcfg.storm_profiles()["storm"][0].replace(n_nodes=n_nodes, bug=bug)
    keys = pengine.cluster_keys(3, 2, "cpu")
    monkeypatch.setattr(pstep, "_DrawBlock", Recording)
    Recording.taken = []
    pstep.step_cluster(cfg, pstate.init_cluster(cfg, keys), keys)
    table = K6.draw_offsets(n_nodes)
    assert Recording.taken == [(off, size) for _, off, size in table]
    assert sum(size for _, _, size in table) == pstep._block_total(n_nodes)


@pytest.mark.parametrize("form", ["uniform", "rows"])
def test_knob_table_round_trips_the_knobs(form):
    kn = (pcfg.storm_profiles()["gray_storm"][0].knobs() if form == "uniform"
          else port_rows(knob_rows()))
    f, i = K6.knob_table(kn, LANES)
    assert f.dtype == torch.float32 and f.shape == (LANES, len(K6.KNOB_F32))
    assert i.dtype == torch.int32 and i.shape == (LANES, len(K6.KNOB_I32))
    assert sorted(K6.KNOB_F32 + K6.KNOB_I32) == sorted(pcfg.Knobs._fields)
    back, want = knobs_from_table(f, i), kn.broadcast(LANES)
    for name, a, b in zip(pcfg.Knobs._fields, back, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:  # bit for bit
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n_nodes,cap", [(5, 64), (3, 16)])
def test_leaf_table_covers_every_non_metric_leaf(n_nodes, cap):
    cfg = pcfg.SimConfig(n_nodes=n_nodes, log_cap=cap, compact_every=4,
                         uncommitted_cap=4)
    s = pstate.init_cluster(cfg, pengine.cluster_keys(0, 3, "cpu"))
    names = [name for name, _, _ in K6.LEAVES]
    assert names == list(pstate.ClusterState._fields[:pstate.METRIC_LEAF0])
    shapes = {K6.ONE: (), K6.N: (n_nodes,), K6.NC: (n_nodes, cap),
              K6.NN: (n_nodes, n_nodes), K6.C: (cap,)}
    for name, shape_class, dtype in K6.LEAVES:
        x = getattr(s, name)
        assert x.dtype == dtype and tuple(x.shape) == (3, *shapes[shape_class]), name


def _enum(text: str, name: str) -> list:
    body = re.search(rf"enum {name} \{{(.*?)\}};", text, re.S).group(1)
    return [x.split("=")[0].strip() for x in body.split(",") if x.strip()]


def test_header_enums_mirror_the_tables():
    text = HEADER.read_text()
    leaves = _enum(text, "Leaf")
    assert leaves[:-1] == [f"L_{n.upper()}" for n, _, _ in K6.LEAVES]
    kinds = re.search(r"kLeafKind\[kLeaves\] = \{(.*?)\};", text, re.S).group(1)
    code = {"kOne": K6.ONE, "kN": K6.N, "kNC": K6.NC, "kNN": K6.NN, "kC": K6.C}
    got = [sum(8 if p.strip() == "kBool" else code[p.strip()]
               for p in k.split("|")) for k in kinds.split(",")]
    assert got == [sc + (8 if dt == torch.bool else 0)
                   for _, sc, dt in K6.LEAVES]
    assert _enum(text, "Draw")[:-1] == [f"D_{n.upper()}" for n, _ in K6.DRAWS]
    assert _enum(text, "KnobF")[:-1] == [f"KF_{n.upper()}" for n in K6.KNOB_F32]
    assert _enum(text, "KnobI")[:-1] == [f"KI_{n.upper()}" for n in K6.KNOB_I32]
    bugs = _enum(text, "Bug")
    assert len(bugs) == len(pcfg.RAFT_BUGS)


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,tick,want", [
    (CUDA, "kernel", "kernel"),
    (CUDA, "eager", "eager"),
    (CPU, "kernel", "eager"),
    (CPU, "eager", "eager"),
])
def test_tick_route(device, tick, want):
    assert pengine.tick_route(device, tick) == want


def test_tick_route_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="tick must be"):
        pengine.tick_route(CUDA, "graph")


@functools.lru_cache(maxsize=None)
def _jax_row_programs(static_cfg):
    init = jax.jit(jax.vmap(functools.partial(jax_init, static_cfg),
                            in_axes=(0, 0)))
    step = jax.jit(jax.vmap(functools.partial(jax_step, static_cfg),
                            in_axes=(0, 0, 0)))
    return init, step


def _chunks(pcfg_, keys, kn, state, ticks: int, chunk: int):
    """(tick, state) after each chunk of the port's tick_chunk."""
    done = 0
    while done < ticks:
        m = min(chunk, ticks - done)
        state = K6.tick_chunk(pcfg_, state, keys, kn, m)
        done += m
        yield done, state


@pytest.mark.parametrize("form", ["uniform", "rows"])
def test_tick_chunk_on_the_cpu_matches_the_reference(form):
    with threefry_layout(True):
        if form == "uniform":
            pair = Pair(*configs("storm"), seed=SEED, n_clusters=LANES)
            js, step, jkeys, jkn = pair.js, pair._jstep, pair.jkeys, pair.jkn
            pc, pkeys, pkn, ps = pair.pcfg, pair.pkeys, pair.pkn, pair.ps
        else:
            rows = knob_rows()
            jc, pc = configs("storm")
            jkn = jcfg.Knobs(**{f: jnp.asarray(v) for f, v in rows.items()})
            pkn = port_rows(rows)
            init, step = _jax_row_programs(jc.static_key())
            jkeys = jengine._cluster_keys(jnp.uint32(SEED), LANES)
            pkeys = pengine.cluster_keys(SEED, LANES, "cpu")
            js, ps = init(jkeys, jkn), pstate.init_cluster(pc, pkeys, pkn)
        tick = 0
        for done, ps in _chunks(pc, pkeys, pkn, ps, TICKS, CHUNK):
            while tick < done:
                js = step(js, jkeys, jkn)
                tick += 1
            d = pstate.first_divergence(
                done, jax_host(js), pstate.state_to_numpy(ps))
            assert d is None, d
    final = pstate.state_to_numpy(ps)
    assert int(final["tick"][0]) == TICKS
    assert (final["first_leader_tick"] > 0).any()


class _Lib:
    """A stand-in kernel library that records what tick_launch gets."""

    def __init__(self):
        self.args = None

    def tick_launch(self, *args):
        self.args = args
        return 0


def test_launch_marshals_the_state_and_refuses_what_it_cannot_run():
    cfg = pcfg.storm_profiles()["storm"][0].replace(bug="no_truncate")
    keys = pengine.cluster_keys(5, 4, "cpu")
    s = pstate.init_cluster(cfg, keys)
    lib = _Lib()
    with threefry_layout(False):
        out, launched = K6._launch(cfg, s, keys, cfg.knobs(), 3, lib, None)
    assert launched
    a = lib.args
    assert a[3] == len(K6.LEAVES) and a[8] == len(K6.DRAWS)
    assert a[4] == keys.data_ptr()
    assert a[9:16] == (4, 5, 64, cfg.ae_max, 3,
                       pcfg.RAFT_BUGS.index("no_truncate"), 0)
    assert a[16] is None and a[17] is None  # no metric leaves, no seen-set
    assert a[18] is None and a[19] == 0  # no trace rows
    assert a[20] is None and a[21] == 0  # no kv side (K6-kv's)
    assert len(a) == 23 and a[22] is None  # the stream
    K6._launch(cfg, s, keys, cfg.knobs(), 3, lib, None)
    assert lib.args[15] == int(prng.partitionable())
    # the new state: every leaf a view of one fresh allocation
    base = out.tick.untyped_storage().data_ptr()
    for (name, _, dtype), x, y in zip(K6.LEAVES, s, out):
        assert y.dtype == dtype and y.shape == x.shape, name
        assert y.untyped_storage().data_ptr() == base, name
        assert y.data_ptr() % 16 == 0 and y.data_ptr() != x.data_ptr(), name
    assert out[pstate.METRIC_LEAF0:] == s[pstate.METRIC_LEAF0:]
    with pytest.raises(ValueError, match="metrics plane"):
        K6._launch(cfg.replace(metrics=True), s, keys, cfg.knobs(), 3, lib,
                   None)
    with pytest.raises(ValueError, match="keys are"):
        K6._launch(cfg, s, keys[:2], cfg.knobs(), 3, lib, None)
    with pytest.raises(ValueError, match="n <= 16"):
        K6._check(cfg.replace(n_nodes=17), s, keys)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's device code built for the host with g++."""
    return _tick_host.build(tmp_path_factory.mktemp("tick_host"),
                            ("tick",))["tick"]


def test_instance_table_mirrors_the_header(host_lib):
    for n in range(1, 17):
        for cap in (4, 8, 16, 32, 64, 128, 256):
            for ae_max in (0, 1, 4, 5, 64):
                cfg = types.SimpleNamespace(n_nodes=n, log_cap=cap,
                                            ae_max=ae_max)
                assert K6.instance(cfg) == host_lib.tick_instance(
                    n, cap, ae_max), (n, cap, ae_max)
    assert sorted(K6.instance(types.SimpleNamespace(
        n_nodes=n, log_cap=cap, ae_max=4)) for n, cap in K6.SHAPES) == [
            1, 2, 3, 4, 5, 6]


# lanes whose ticks cross the int32 wrap, the u32 wrap, and neither
WRAP_TICKS = (2**31 - 10, -20, 1000)


@pytest.mark.parametrize("n_nodes", [3, 5, 7, 4])
@pytest.mark.parametrize("partitionable", [True, False])
def test_in_kernel_words_equal_the_plain_draw(host_lib, n_nodes,
                                              partitionable):
    b, m = 6, 40  # 40 ticks: the lanes derive a second batch of tick keys
    keys = pengine.cluster_keys(SEED, b, "cpu")
    t1 = torch.tensor([WRAP_TICKS[i % 3] + i for i in range(b)],
                      dtype=torch.int32)
    total = pstep._block_total(n_nodes)
    want = threefry.tick_blocks_plain(keys, t1, m, total, partitionable)
    for ae_max in (K6.SHAPE_AE, K6.SHAPE_AE + 1):  # instance, runtime one
        got = torch.zeros((m, b, total), dtype=torch.int32)
        assert host_lib.tick_words(keys.data_ptr(), t1.data_ptr(), b, n_nodes,
                                   64, ae_max, m, int(partitionable),
                                   got.data_ptr()) == 0
        assert torch.equal(got.to(torch.int64) & threefry.MASK, want)


_CAP16 = dict(log_cap=16, compact_every=4, uncommitted_cap=4)


@pytest.mark.parametrize("case", [
    "storm", "rows_ragged", "n7_bug", "mixed", "legacy", "wrap", "n3",
    "n3_cap16", "n5_cap16", "n7_cap16", "n4_cap32_runtime",
    "n5_forced_runtime", "rolling", "rolling_wrap", "majority2", "planted"])
def test_device_code_on_the_host_equals_plain(host_lib, case):
    storm = pcfg.storm_profiles()["storm"][0]
    cfg, b, ticks, chunk = storm, 8, 64, 32
    kn = storm.knobs()
    if case == "majority2":  # a broken quorum: every oracle bit fires
        cfg, b, ticks = storm.replace(majority_override=2), 16, 128
        kn = cfg.knobs()
    elif case.startswith("rolling"):  # the rolling wave's schedule
        cfg = pcfg.storm_profiles()["rolling_wave"][0]
        kn = cfg.knobs()
    elif case == "rows_ragged":
        b, chunk = LANES, 7
        kn = port_rows(knob_rows())
    elif case == "n7_bug":
        cfg = storm.replace(n_nodes=7, bug="grant_any_vote")
        kn = cfg.knobs()
    elif case.startswith("n") and case[1].isdigit() and case != "n7_bug":
        shape = _CAP16 if "cap16" in case else (
            dict(log_cap=32, compact_every=8) if "cap32" in case else {})
        cfg = storm.replace(n_nodes=int(case[1]), **shape)
        kn = cfg.knobs()
    if case in ("n3", "legacy"):  # warps of four clusters with tiles left
        b = {"n3": 7, "legacy": 6}[case]
    if case.endswith("forced_runtime"):  # the flagship's shape, one more
        cfg = cfg.replace(ae_max=K6.SHAPE_AE + 1)  # entry a message
        kn = cfg.knobs()
    want_instance = 0 if "runtime" in case else 1 + K6.SHAPES.index(
        (cfg.n_nodes, cfg.log_cap))
    assert K6.instance(cfg) == want_instance
    keys = pengine.cluster_keys(SEED, b, "cpu")
    s = pstate.init_cluster(cfg, keys, kn)
    if case == "mixed":  # lanes at their own ticks, as after a harvest
        later = pengine._advance(cfg, s, keys, kn, 45)
        sel = torch.arange(b) % 3 != 0
        s = pstate.ClusterState(*(
            torch.where(sel.view(-1, *(1,) * (x.dim() - 1)), y, x)
            if x.numel() else x for x, y in zip(s, later)))
    if case == "planted":  # two leaders of one term; two prefix hashes
        h = pstate.state_to_numpy(pengine._advance(cfg, s, keys, kn, 45))
        h["alive"][:] = True
        top = int(h["term"].max()) + 100
        for c in range(0, b, 2):
            h["role"][c, :2] = 2
            h["term"][c, :2] = top
        for c in range(1, b, 2):
            h["base"][c, :2] = max(int(h["base"][c, 0]), 1)
            h["prefix_hash"][c, 1] = h["prefix_hash"][c, 0] ^ 1
        s = pstate.state_from_numpy(h)
    if case.endswith("wrap"):  # ticks that cross the int32 and u32 wraps
        s = s._replace(tick=torch.tensor(
            [WRAP_TICKS[i % 3] for i in range(b)], dtype=torch.int32))
    done = 0
    with threefry_layout(case != "legacy"):
        while done < ticks:
            m = min(chunk, ticks - done)
            got, _ = K6._launch(cfg, s, keys, kn, m, host_lib, None)
            want = K6.tick_chunk_plain(cfg, s, keys, kn, m)
            done += m
            d = pstate.first_divergence(done, pstate.state_to_numpy(want),
                                        pstate.state_to_numpy(got))
            assert d is None, d
            s = want
    final = pstate.state_to_numpy(s)
    assert int(final["msg_count"].sum()) > 0
    if case == "majority2":
        assert np.bitwise_or.reduce(final["violations"]) & 7 == 7
    if case == "planted":
        assert (final["violations"][0::2] & 1).any()
        assert (final["violations"][1::2] & 512).any()
