"""The port reproduces the golden legs of tests/golden_fuzz.json (the two
fuzz legs and the pool leg) on the CPU under the legacy threefry layout the
golden file was recorded with (jax_threefry_partitionable=False). Every
recorded report or summary field must match exactly; the port's extra
telemetry keys are ignored, as in the reference's own golden guard. The
pool leg also carries the reference's packed layout and its 2612 bytes per
lane."""

import contextlib
import io
import json
import pathlib

import pytest

from _torch_parity import single_thread
from madraft_tpu_torch.__main__ import main as port_main
from madraft_tpu_torch.tpusim import prng

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden_fuzz.json").read_text())


@pytest.mark.parametrize("leg", ["clean", "bug", "pool"])
def test_golden_leg_reproduces_under_legacy_layout(leg):
    rec = GOLDEN[leg]
    want = rec.get("report") or rec["summary"]
    buf = io.StringIO()
    with single_thread(), prng.layout(False), contextlib.redirect_stdout(buf):
        rc = port_main(rec["argv"] + ["--platform", "cpu"])
    live = json.loads(buf.getvalue().strip().splitlines()[-1])
    found = want.get("violating", want.get("retired_violating"))
    assert rc == (1 if found else 0)
    for key, value in want.items():
        assert live[key] == value, f"{leg}: {key} {live[key]!r} != {value!r}"
    if leg == "pool":
        assert live["state_layout"] == "packed"
        assert live["bytes_per_lane"] == 2612.0
