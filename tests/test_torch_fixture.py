"""The reference fixtures in tests/torch_fixtures/ still equal the live JAX
package's output.

``fuzz_legs.json`` holds per-cluster fuzz report arrays of a few storm legs,
``pool_legs.json`` the retired rows (in retirement order) and the
deterministic summary fields of pool legs under both id schemes, and
``metrics_legs.json`` two legs with the metrics plane on (the storm fuzz
report with its metric rows; the durability + ack_before_fsync pool's rows
and summary), all under the default (partitionable) threefry layout,
recorded from the JAX package on the CPU. ``chip_smoke.py`` holds the port's CUDA runs to them bit for
bit, on a machine with no JAX. Regenerate them (only after a deliberate
change to the reference's semantics) with

    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py

Tolerance: exact equality."""

import json
import pathlib

import numpy as np
import pytest

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / "fuzz_legs.json"
POOL_FIXTURE = FIXTURE.with_name("pool_legs.json")
METRICS_FIXTURE = FIXTURE.with_name("metrics_legs.json")
LEGS = {
    "storm": ("storm", "", 5),
    "durability_ack_before_fsync": ("durability", "ack_before_fsync", 5),
    "fig8": ("fig8", "", 3),
}
N_CLUSTERS, N_TICKS = 64, 300
REPORT_FIELDS = ("violations", "first_violation_tick", "first_leader_tick",
                 "committed", "msg_count", "snap_installs")


def live_report(profile, bug, seed):
    import jax

    from madraft_tpu.tpusim.config import storm_profiles
    from madraft_tpu.tpusim.engine import fuzz

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        cfg = storm_profiles()[profile][0].replace(bug=bug)
        rep = fuzz(cfg, seed, N_CLUSTERS, N_TICKS)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return {f: np.asarray(getattr(rep, f)).astype(int).tolist()
            for f in REPORT_FIELDS}


def record() -> dict:
    legs = {}
    for name, (profile, bug, seed) in LEGS.items():
        legs[name] = {"profile": profile, "bug": bug, "seed": seed,
                      "report": live_report(profile, bug, seed)}
    return {
        "_comment": "Per-cluster fuzz reports of the JAX package (CPU, "
                    "jax_threefry_partitionable=True); written by "
                    "tests/test_torch_fixture.py, read by chip_smoke.py.",
        "partitionable": True,
        "n_clusters": N_CLUSTERS,
        "n_ticks": N_TICKS,
        "legs": legs,
    }


@pytest.mark.parametrize("leg", list(LEGS))
def test_fixture_equals_live_reference(leg):
    doc = json.loads(FIXTURE.read_text())
    assert doc["partitionable"] is True
    assert (doc["n_clusters"], doc["n_ticks"]) == (N_CLUSTERS, N_TICKS)
    rec = doc["legs"][leg]
    assert (rec["profile"], rec["bug"], rec["seed"]) == LEGS[leg]
    live = live_report(*LEGS[leg])
    for f in REPORT_FIELDS:
        assert rec["report"][f] == live[f], f"{leg}: {f} drifted"


# pool legs: (profile, bug, seed, devices); devices None = the monotone id
# scheme, 1 = the lane-partitioned one
POOL_LEGS = {
    "storm_monotone": ("storm", "", 5, None),
    "storm_lane": ("storm", "", 5, 1),
    "durability_ack_before_fsync_monotone": (
        "durability", "ack_before_fsync", 5, None),
    "durability_ack_before_fsync_lane": (
        "durability", "ack_before_fsync", 5, 1),
}
POOL_SHAPE = {"lanes": 64, "horizon": 300, "chunk_ticks": 100,
              "budget_ticks": 600}
ROW_FIELDS = ("cluster_id", "ticks_run", "violations", "first_violation_tick",
              "first_leader_tick", "committed", "msg_count", "snap_installs")
SUMMARY_FIELDS = (
    "lanes", "horizon", "chunk_ticks", "lane_ticks", "ticks_dispatched",
    "retired", "retired_violating", "violating_clusters",
    "violating_clusters_total", "violation_names", "effective_cluster_steps",
    "state_layout", "state_hbm_bytes", "bytes_per_lane", "next_cluster_id",
    "id_scheme", "devices", "id_watermark")


def live_pool(profile, bug, seed, devices):
    import jax

    from madraft_tpu.tpusim.config import storm_profiles
    from madraft_tpu.tpusim.engine import run_pool

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        cfg = storm_profiles()[profile][0].replace(bug=bug)
        rows = []
        s = run_pool(cfg, seed, POOL_SHAPE["lanes"], POOL_SHAPE["horizon"],
                     chunk_ticks=POOL_SHAPE["chunk_ticks"],
                     budget_ticks=POOL_SHAPE["budget_ticks"], devices=devices,
                     on_retired=rows.append)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return {"rows": [[r[f] for f in ROW_FIELDS] for r in rows],
            "summary": {k: s[k] for k in SUMMARY_FIELDS if k in s}}


def record_pool() -> dict:
    legs = {}
    for name, (profile, bug, seed, devices) in POOL_LEGS.items():
        legs[name] = {"profile": profile, "bug": bug, "seed": seed,
                      "devices": devices,
                      **live_pool(profile, bug, seed, devices)}
    return {
        "_comment": "Pool runs of the JAX package (CPU, "
                    "jax_threefry_partitionable=True): retired rows in "
                    "retirement order (row_fields) and the deterministic "
                    "summary fields; written by tests/test_torch_fixture.py, "
                    "read by chip_smoke.py.",
        "partitionable": True,
        **POOL_SHAPE,
        "row_fields": list(ROW_FIELDS),
        "legs": legs,
    }


@pytest.mark.parametrize("leg", list(POOL_LEGS))
def test_pool_fixture_equals_live_reference(leg):
    doc = json.loads(POOL_FIXTURE.read_text())
    assert doc["partitionable"] is True
    assert {k: doc[k] for k in POOL_SHAPE} == POOL_SHAPE
    assert doc["row_fields"] == list(ROW_FIELDS)
    rec = doc["legs"][leg]
    assert (rec["profile"], rec["bug"], rec["seed"],
            rec["devices"]) == POOL_LEGS[leg]
    live = live_pool(*POOL_LEGS[leg])
    assert rec["rows"] == live["rows"], f"{leg}: retired rows drifted"
    assert rec["summary"] == live["summary"], f"{leg}: summary drifted"


# metrics legs: the storm fuzz report (every FuzzReport field, metric rows
# included) and a planted-bug pool's rows and summary with metrics on
METRICS_FUZZ_LEG = {"profile": "storm", "bug": "", "seed": 5,
                    "n_clusters": 64, "n_ticks": 300}
METRICS_POOL_LEG = {"profile": "durability", "bug": "ack_before_fsync",
                    "seed": 5, **POOL_SHAPE}
# run-to-run fields of pool rows and summaries, left out of the fixture
WALL = ("wall_s", "steps_per_sec", "effective_steps_per_sec",
        "violations_per_s", "compile_s", "dispatch_gap_s", "device_wait_s",
        "host_overlap_s")


def live_metrics_legs() -> dict:
    import jax

    from madraft_tpu.tpusim.config import storm_profiles
    from madraft_tpu.tpusim.engine import fuzz, run_pool

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        f, p = METRICS_FUZZ_LEG, METRICS_POOL_LEG
        cfg = storm_profiles()[f["profile"]][0].replace(bug=f["bug"],
                                                        metrics=True)
        rep = fuzz(cfg, f["seed"], f["n_clusters"], f["n_ticks"])
        cfg = storm_profiles()[p["profile"]][0].replace(bug=p["bug"],
                                                        metrics=True)
        rows = []
        s = run_pool(cfg, p["seed"], p["lanes"], p["horizon"],
                     chunk_ticks=p["chunk_ticks"],
                     budget_ticks=p["budget_ticks"], on_retired=rows.append)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return {
        "fuzz": {**f, "report": {k: np.asarray(v).astype(int).tolist()
                                 for k, v in rep._asdict().items()}},
        "pool": {**p,
                 "rows": [{k: v for k, v in r.items() if k not in WALL}
                          for r in rows],
                 "summary": {k: v for k, v in s.items() if k not in WALL}},
    }


def record_metrics() -> dict:
    return {
        "_comment": "Fuzz and pool runs of the JAX package with the metrics "
                    "plane on (CPU, jax_threefry_partitionable=True); "
                    "written by tests/test_torch_fixture.py, read by "
                    "chip_smoke.py.",
        "partitionable": True,
        **live_metrics_legs(),
    }


@pytest.mark.parametrize("leg", ["fuzz", "pool"])
def test_metrics_fixture_equals_live_reference(leg):
    doc = json.loads(METRICS_FIXTURE.read_text())
    assert doc["partitionable"] is True
    live = _live_metrics()[leg]
    rec = doc[leg]
    shape = METRICS_FUZZ_LEG if leg == "fuzz" else METRICS_POOL_LEG
    assert {k: rec[k] for k in shape} == shape
    assert rec == json.loads(json.dumps(live)), f"metrics {leg} leg drifted"
    if leg == "pool":
        assert rec["summary"]["retired_violating"] > 0
        assert rec["summary"]["latency"]["ops"] > 0


_LIVE: dict = {}


def _live_metrics() -> dict:
    if not _LIVE:
        _LIVE.update(live_metrics_legs())
    return _LIVE


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(exist_ok=True)
    for path, doc in ((FIXTURE, record()), (POOL_FIXTURE, record_pool()),
                      (METRICS_FIXTURE, record_metrics())):
        path.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {path}")
