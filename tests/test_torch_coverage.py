"""The port's coverage-guided pool (``engine.run_pool(coverage=...)``, the
``pool --coverage`` verb) and its pieces against the live JAX package:
``prng.uniform``, the refill's float32 arithmetic over every uniform it can
draw, the abstract-state fingerprint (wide and packed), the seen-set index
and credit rule, ``refill_knobs``, the ground-truth enumerator, the pools
(guided, random, lane ids; metrics off and on) row by row and summary by
summary, the CLI's gates and exit codes, and a mutated row's replay.

``tests/torch_fixtures/coverage_legs.json`` holds the reference's pool legs,
its ground-truth seen counts, the SHA-256 of its refill arithmetic over
the 2^23-value grid and its sweep legs (``tests/test_torch_sweep.py``), for
``chip_smoke.py`` to hold the card to; regenerate it (only after a deliberate change to the reference's semantics) with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_coverage.py

Tolerance: exact equality everywhere (integer codes, f32 bits)."""

import contextlib
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.tpusim import config as jcfg
from madraft_tpu.tpusim import coverage as jcov
from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim import state as jstate
from madraft_tpu_torch.__main__ import _storm
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.tpusim import config as pcfg
from madraft_tpu_torch.tpusim import coverage as pcov
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim import state as pstate

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / "coverage_legs.json"
POOL_SHAPE = {"horizon": 64, "chunk_ticks": 32, "budget_ticks": 192}
# pool legs: the storm profile, with a broken quorum where lanes must
# violate (a violated lane neither writes the seen-set nor earns credit);
# three generations retire, the third born of refilled knob rows
LEGS = {
    "guided": dict(majority_override=0, metrics=False, guided=True,
                   devices=None, lanes=16),
    "random": dict(majority_override=0, metrics=False, guided=False,
                   devices=None, lanes=16),
    "lane": dict(majority_override=2, metrics=False, guided=True, devices=1,
                 lanes=16),
    "guided_metrics": dict(majority_override=2, metrics=True, guided=True,
                           devices=None, lanes=8),
    "random_metrics": dict(majority_override=0, metrics=True, guided=False,
                           devices=None, lanes=8),
    "lane_metrics": dict(majority_override=0, metrics=True, guided=True,
                         devices=1, lanes=8),
}
SEED = 5
# the ground-truth A/B: 16 lanes over ten horizons
GT_LEG = {"seed": 7, "lanes": 16, "budget_ticks": 64 * 10}
WALL = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
        "violations_per_s", "compile_s", "dispatch_gap_s", "device_wait_s",
        "host_overlap_s")


@pytest.fixture(autouse=True)
def _one_thread_default_layout():
    with single_thread(), threefry_layout(True):
        yield


def _deterministic(summary: dict) -> dict:
    out = {k: v for k, v in summary.items() if k not in WALL}
    out["coverage"] = {k: v for k, v in summary["coverage"].items()
                       if k != "new_fingerprints_per_s"}
    return out


def _rows(rows) -> list:
    return [{k: v for k, v in r.items() if k not in WALL} for r in rows]


def _leg_cfg(pkg, leg: dict):
    cfg = pkg.storm_profiles()["storm"][0].replace(metrics=leg["metrics"])
    if leg["majority_override"]:
        cfg = cfg.replace(majority_override=leg["majority_override"])
    return cfg, pkg.CoverageConfig(guided=leg["guided"])


def run_leg(side: str, leg: dict) -> dict:
    """One coverage pool leg: its rows and deterministic summary."""
    rows = []
    kw = dict(chunk_ticks=POOL_SHAPE["chunk_ticks"],
              budget_ticks=POOL_SHAPE["budget_ticks"], devices=leg["devices"],
              on_retired=rows.append)
    shape = (SEED, leg["lanes"], POOL_SHAPE["horizon"])
    if side == "jax":
        cfg, ccfg = _leg_cfg(jcfg, leg)
        s = jengine.run_pool(cfg, *shape, coverage=ccfg, **kw)
    else:
        cfg, ccfg = _leg_cfg(pcfg, leg)
        s = pengine.run_pool(cfg, *shape, coverage=ccfg, device="cpu", **kw)
    return {"rows": _rows(rows), "summary": _deterministic(s)}


def run_ground_truth(side: str) -> dict:
    """Guided and random pools on the ground-truth config: their coverage
    dicts, and the size of the enumerated code space."""
    mod, cov, eng = ((jcfg, jcov, jengine) if side == "jax"
                     else (pcfg, pcov, pengine))
    cfg, ccfg, horizon = mod.coverage_ground_truth()
    out = {"enumerated": len(cov.enumerate_abstract_codes(cfg.n_nodes, ccfg))}
    for name, guided in (("guided", True), ("random", False)):
        kw = {} if side == "jax" else {"device": "cpu"}
        s = eng.run_pool(cfg, GT_LEG["seed"], GT_LEG["lanes"], horizon,
                         budget_ticks=GT_LEG["budget_ticks"],
                         coverage=ccfg.replace(guided=guided), **kw)
        out[name] = _deterministic(s)["coverage"]
    return out


def _jax_grid(ccfg) -> tuple:
    """The reference's refill expressions, jitted as its harvest program
    compiles them, over every uniform k * 2^-23 (k < 2^23)."""
    k = np.arange(1 << 23, dtype=np.uint32)
    u = jnp.asarray((k | 0x3F800000).view(np.float32) - np.float32(1.0))
    span = float(np.log2(ccfg.mut_span))

    @jax.jit
    def grid(u, one):
        mut = one * jnp.exp2((u * 2.0 - 1.0) * span)
        fresh = ccfg.fresh_lo + u * (ccfg.fresh_hi - ccfg.fresh_lo)
        return mut, fresh

    return tuple(np.asarray(x) for x in grid(u, jnp.float32(1.0)))


GRID_CONFIGS = {"default": (jcfg.CoverageConfig(), pcfg.CoverageConfig()),
                "ground_truth": (jcfg.coverage_ground_truth()[1],
                                 pcfg.coverage_ground_truth()[1])}


def record() -> dict:
    from test_torch_sweep import record_sweeps

    with threefry_layout(True):
        grids = {}
        for name, (jc, _) in GRID_CONFIGS.items():
            grids[name] = {"mut_span": jc.mut_span, "fresh_lo": jc.fresh_lo,
                           "fresh_hi": jc.fresh_hi,
                           "sha256": pcov.grid_sha256(_jax_grid(jc))}
        return {
            "_comment": "Coverage pools of the JAX package (CPU, "
                        "jax_threefry_partitionable=True), its ground-truth "
                        "A/B and the SHA-256 of its refill arithmetic over "
                        "every float32 uniform; written by "
                        "tests/test_torch_coverage.py, read by "
                        "chip_smoke.py.",
            "partitionable": True,
            "exp_grid": grids,
            "pool_shape": POOL_SHAPE,
            "seed": SEED,
            "profile": "storm",
            "legs": {name: {**leg, **run_leg("jax", leg)}
                     for name, leg in LEGS.items()},
            "ground_truth": {**GT_LEG, **run_ground_truth("jax")},
            "sweeps": record_sweeps(),
        }


def _fixture() -> dict:
    return json.loads(FIXTURE.read_text())


# ---------------------------------------------------------------- prng.uniform


@pytest.mark.parametrize("partitionable", [True, False])
def test_uniform_matches_jax(partitionable):
    with threefry_layout(partitionable):
        seeds = np.arange(64, dtype=np.int64) * 7919 + 3
        for size in (1, 9, 17):
            want = np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(int(s)), int(s) + 5),
                (size,))) for s in seeds])
            keys = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)),
                                torch.from_numpy(seeds + 5))
            got = prng.uniform(keys, size).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


# ------------------------------------------------------- the refill's float32


@pytest.mark.parametrize("name", list(GRID_CONFIGS))
def test_refill_arithmetic_over_every_uniform(name):
    # the mutation factor (XLA's exp2 as exp(fl32(ln2 x)), its Cephes
    # polynomial of FMAs) and the fresh factor (one FMA), over all 2^23
    # uniforms: bit-equal to the reference; the fixture's hash is theirs
    jc, pc = GRID_CONFIGS[name]
    want = _jax_grid(jc)
    got = [x.numpy() for x in pcov.refill_grid(pc)]
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        bad = np.nonzero(w.view(np.uint32) != g.view(np.uint32))[0]
        assert bad.size == 0, f"{bad.size} inputs differ, first u index {bad[:4]}"
    assert _fixture()["exp_grid"][name]["sha256"] == pcov.grid_sha256(want)
    # torch.exp2 is not XLA's exp2: the reason for xla_exp_f32
    u = torch.from_numpy((np.arange(1 << 23, dtype=np.uint32) | 0x3F800000)
                         .view(np.float32) - np.float32(1.0))
    assert not torch.equal(torch.exp2(u * 2.0 - 1.0),
                           torch.from_numpy(want[0].copy()))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("name", list(GRID_CONFIGS))
def test_refill_knobs_matches_reference_on_planted_parents(name,
                                                           partitionable):
    jc, pc = GRID_CONFIGS[name]
    rng = np.random.default_rng(11)
    n = 64
    base = jcfg.storm_profiles()["gray_storm"][0]
    jbase = base.knobs()
    pbase = pcfg.storm_profiles()["gray_storm"][0].knobs()
    parents = {f: np.asarray(np.broadcast_to(np.asarray(x), (n,))).copy()
               for f, x in zip(jbase._fields, jbase)}
    for f in jcov.MUTABLE_KNOBS:
        parents[f] = rng.random(n, dtype=np.float32)
    parents["p_asym_cut"][:8] = 0.0  # a disabled knob stays 0
    retired = rng.random(n) < 0.6
    productive = retired & (rng.random(n) < 0.5)
    new_ids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    seed = 2**32 - 3
    with threefry_layout(partitionable):
        # jitted, as the reference's harvest program runs it (eager op by
        # op, XLA neither fuses the exp2 nor contracts the FMA)
        jk, jkinds = jax.jit(lambda *a: jcov.refill_knobs(jc, *a))(
            jcfg.Knobs(**{f: jnp.asarray(v) for f, v in parents.items()}),
            jbase, jnp.asarray(retired), jnp.asarray(productive),
            jnp.asarray(new_ids), jnp.asarray(seed, jnp.uint32))
        pk, pkinds = pcov.refill_knobs(
            pc, pcfg.Knobs(**{f: torch.from_numpy(v)
                              for f, v in parents.items()}),
            pbase, torch.from_numpy(retired), torch.from_numpy(productive),
            torch.from_numpy(new_ids), seed)
    for f in jk._fields:
        a, b = np.asarray(getattr(jk, f)), getattr(pk, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    np.testing.assert_array_equal(np.asarray(jkinds), pkinds.numpy())


# --------------------------------------------------------------- fingerprints


def _jax_states(cfg, seed: int, n: int, ticks: int):
    fn = jengine.make_fuzz_fn(cfg, n, ticks)
    return jax.tree.map(np.asarray, fn(seed))


@pytest.mark.parametrize("case", ["storm5", "ground_truth3", "storm7"])
def test_abstract_code_and_index_match_reference(case):
    gt_cfg, gt_ccfg, _ = jcfg.coverage_ground_truth()
    if case == "ground_truth3":
        jc_cfg, ccfgs = gt_cfg, [gt_ccfg, gt_ccfg.replace(bitmap_bits=64)]
    else:
        n = 5 if case == "storm5" else 7
        jc_cfg = jcfg.storm_profiles()["storm"][0].replace(n_nodes=n)
        ccfgs = [jcfg.CoverageConfig(), jcfg.CoverageConfig(bitmap_bits=256)]
    pc_cfg = pcfg.SimConfig(**{f: getattr(jc_cfg, f)
                               for f in jc_cfg.__dataclass_fields__})
    for ticks in (0, 40, 90):
        h = _jax_states(jc_cfg, 3, 32, ticks)
        js = jstate.ClusterState(*(jnp.asarray(x) for x in h))
        ps = pstate.state_from_numpy({k: np.array(v)
                                      for k, v in h._asdict().items()})
        for jc in ccfgs:
            pc = pcfg.CoverageConfig(**{f: getattr(jc, f)
                                        for f in jc.__dataclass_fields__})
            want = np.asarray(jax.vmap(lambda s: jcov.abstract_code(jc, s))(js))
            got = pcov.abstract_code(pc, ps).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))
            packed = pcov.abstract_code_packed(
                pc, pstate.pack_state(pc_cfg, ps)).numpy()
            np.testing.assert_array_equal(packed, got)
            widx = np.asarray(jcov.bitmap_index(jc, jc_cfg.n_nodes,
                                                jnp.asarray(want)))
            pidx = pcov.bitmap_index(pc, jc_cfg.n_nodes, torch.from_numpy(got))
            np.testing.assert_array_equal(pidx.numpy(), widx.astype(np.int64))
            assert pcov.identity_mapped(jc_cfg.n_nodes, pc) \
                == jcov.identity_mapped(jc_cfg.n_nodes, jc)


def test_mix32_and_small_helpers_match_reference():
    x = np.concatenate([np.arange(64, dtype=np.uint32),
                        np.array([2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF],
                                 np.uint32),
                        np.random.default_rng(3).integers(
                            0, 2**32, 256, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jcov._mix32(jnp.asarray(x)))
    got = pcov._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for lanes, shards in ((16, 1), (16, 4), (64, 2)):
        np.testing.assert_array_equal(
            pcov.lane_shards(lanes, shards).numpy(),
            np.asarray(jcov.lane_shards(lanes, shards)))
    assert pcov.MUTABLE_KNOBS == jcov.MUTABLE_KNOBS
    assert pcov._COV_SALT == jcov._COV_SALT
    assert pcov.REFILL_NAMES == jcov.REFILL_NAMES
    for n, cc in ((3, jcfg.coverage_ground_truth()[1]),
                  (5, jcfg.CoverageConfig())):
        pc = pcfg.CoverageConfig(**{f: getattr(cc, f)
                                    for f in cc.__dataclass_fields__})
        assert pcov.node_alphabet(pc) == jcov.node_alphabet(cc)
        assert pcov.code_space(n, pc) == jcov.code_space(n, cc)


def test_enumerate_abstract_codes_matches_reference():
    jc = jcfg.coverage_ground_truth()[1]
    pc = pcfg.coverage_ground_truth()[1]
    for n in (2, 3):
        np.testing.assert_array_equal(pcov.enumerate_abstract_codes(n, pc),
                                      jcov.enumerate_abstract_codes(n, jc))
    with pytest.raises(ValueError):
        pcov.enumerate_abstract_codes(5, pcfg.CoverageConfig())


@pytest.mark.parametrize("bits", [1 << 16, 16])
def test_seen_update_credit_rule_matches_reference(bits):
    # the reference's own expressions on the same codes, tick after tick:
    # nf += ok & ~bm[idx]; bm = bm.at[idx].max(ok). Duplicate indices with
    # differing ok (a violated lane on a new lane's bit) included
    jc, pc = jcfg.CoverageConfig(bitmap_bits=bits), \
        pcfg.CoverageConfig(bitmap_bits=bits)
    role, alive, term, commit, viol = pcov.planted_fingerprint_inputs(5, 96, 4)
    viol[16:24] = torch.where(torch.arange(8) % 2 == 0, 0, 8).int()
    for x in (role, alive, term, commit):
        x[16:24] = x[0].clone()  # violated and clean lanes on one code
    bm = jnp.zeros((bits,), jnp.bool_)
    nf = jnp.zeros((96,), jnp.int32)
    seen = torch.full((1, bits), pcov.UNSEEN, dtype=torch.int32)
    new_fps = torch.zeros(96, dtype=torch.int32)
    for t in range(4):
        h = {"role": role.numpy(), "alive": alive.numpy(),
             "term": term.numpy(), "commit": commit.numpy()}
        code = jax.vmap(lambda r, a, tm, c: jcov._fold_code(
            jc, jcov._combine_node_code(
                jc, r, a.astype(jnp.int32),
                jnp.clip(jnp.sum(tm[None, :] < tm[:, None], axis=1), 0,
                         jc.term_rank_levels - 1),
                jnp.clip(c - jnp.min(c), 0, jc.commit_delta_levels - 1)
            ).astype(jnp.uint32)))(h["role"], h["alive"], h["term"],
                                   h["commit"])
        idx = jcov.bitmap_index(jc, 5, code)
        ok = jnp.asarray(viol.numpy()) == 0
        nf = nf + (ok & ~bm[idx]).astype(jnp.int32)
        bm = bm.at[idx].max(ok)
        pcov.seen_update_plain(pc, role, alive, term, commit, viol, None,
                               seen, new_fps, t)
        np.testing.assert_array_equal(new_fps.numpy(), np.asarray(nf))
        np.testing.assert_array_equal((seen != pcov.UNSEEN)[0].numpy(),
                                      np.asarray(bm))
        term = torch.where(torch.arange(96)[:, None] % 3 == t % 3, term + 1,
                           term)
    assert int(pcov.seen_bits(seen)) == int(np.asarray(bm).sum())


# ---------------------------------------------------------------------- pools


@pytest.mark.parametrize("leg", list(LEGS))
def test_coverage_pool_matches_reference_and_fixture(leg):
    want = run_leg("jax", LEGS[leg])
    got = run_leg("port", LEGS[leg])
    assert got["rows"] == want["rows"]
    assert got["summary"] == want["summary"]
    rec = _fixture()["legs"][leg]
    assert {k: rec[k] for k in LEGS[leg]} == LEGS[leg]
    assert json.loads(json.dumps(want)) == {"rows": rec["rows"],
                                           "summary": rec["summary"]}
    kinds = {r["refill"] for r in got["rows"]}
    cov = got["summary"]["coverage"]
    assert cov["generations"] == POOL_SHAPE["budget_ticks"] \
        // POOL_SHAPE["chunk_ticks"]
    if LEGS[leg]["guided"]:
        assert "mutate" in kinds and cov["refills_mutated"] > 0
    else:
        assert kinds == {"seed"} and cov["refills_mutated"] == 0
    if LEGS[leg]["majority_override"]:
        assert got["summary"]["retired_violating"] > 0


def test_first_generation_equals_the_plain_pool():
    # one generation, no refill: the coverage pool's rows are the plain
    # pool's plus the coverage columns, every lane on the base knob row
    cfg, ccfg, horizon = pcfg.coverage_ground_truth()
    kw = dict(chunk_ticks=horizon, budget_ticks=horizon, device="cpu")
    off, on = [], []
    pengine.run_pool(cfg, 5, 16, horizon, on_retired=off.append, **kw)
    pengine.run_pool(cfg, 5, 16, horizon, on_retired=on.append,
                     coverage=ccfg, **kw)
    base = cfg.knobs()
    assert len(off) == len(on) == 16
    for a, b in zip(_rows(off), _rows(on)):
        assert {k: b[k] for k in a} == a
        assert b["refill"] == "seed" and b["new_fingerprints"] > 0
        assert b["knobs"] == {k: float(getattr(base, k))
                              for k in pcov.MUTABLE_KNOBS}


def test_ground_truth_guided_beats_random_as_the_reference():
    want = run_ground_truth("jax")
    got = run_ground_truth("port")
    assert got == want
    assert json.loads(json.dumps(want)) == {
        k: v for k, v in _fixture()["ground_truth"].items()
        if k not in GT_LEG}
    g, r = got["guided"]["seen_fingerprints"], got["random"]["seen_fingerprints"]
    assert 0 < r < g <= got["enumerated"]


# ------------------------------------------------------------------------ CLI


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_main(argv)
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.strip()]
    return rc, lines


@pytest.mark.parametrize("extra", [
    ["--coverage-random"], ["--coverage-bits", "1024"],
    ["--coverage", "--coverage-bits", "100"],
    ["--coverage", "--coverage-bits", "0"],
    ["--coverage", "--heartbeat", "hb.jsonl"],
    ["--coverage", "--digest-every", "2"],
    ["--coverage", "--devices", "2"],
    ["--coverage", "--mesh"],
])
def test_pool_coverage_usage_errors_exit_2(extra):
    argv = ["pool", "--storm", "--clusters", "4", "--ticks", "8",
            "--platform", "cpu"] + extra
    assert port_main(argv) == 2


def test_mutated_row_replays_through_the_cli():
    rc, lines = _cli(["pool", "--storm", "--coverage", "--clusters", "16",
                      "--ticks", "64", "--chunk-ticks", "32",
                      "--budget-ticks", "192", "--seed", "9",
                      "--platform", "cpu"])
    rows, summary = lines[:-1], lines[-1]
    assert rc == 0 and summary["coverage"]["refills_mutated"] > 0
    mutated = [r for r in rows if r["refill"] == "mutate"]
    base = pcfg.SimConfig().knobs()
    assert mutated and any(
        r["knobs"][k] != float(getattr(base, k))
        for r in mutated for k in r["knobs"])
    for r in mutated[:2]:
        rc, (out,) = _cli(["replay", "--storm", "--seed", "9", "--cluster",
                           str(r["cluster_id"]), "--ticks",
                           str(r["ticks_run"]), "--knobs-json",
                           json.dumps(r["knobs"]), "--platform", "cpu"])
        assert rc == (1 if r["violations"] else 0)
        for k in ("violations", "first_violation_tick", "committed"):
            assert out[k] == r[k], k
        st = pengine.replay_cluster(_storm(pcfg.SimConfig()), 9,
                                    r["cluster_id"], r["ticks_run"],
                                    knobs=r["knobs"], device="cpu")
        assert int(st.msg_count[0]) == r["msg_count"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps(record(), separators=(",", ":")) + "\n")
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
