"""The port's ``stats`` verb against the JAX package's, on the same inputs:
a ``fuzz --metrics`` report, a ``pool --metrics`` JSONL stream with its
summary, both together (with ``--json``), a rows-only stream beside a
summary stream, a metrics-off report, a mixed set, stdin, and a missing
file. The inputs are made by the port's CLI on the CPU (16 clusters).
Standard output, standard error and the exit code must be equal; ``stats
--follow`` exits 2 naming its ROADMAP item. Tolerance: exact equality."""

import contextlib
import io
import json
import sys

import pytest

from _torch_parity import single_thread, threefry_layout
from madraft_tpu.__main__ import main as jax_main
from madraft_tpu_torch.__main__ import main as port_main

def run(main, argv, stdin: str = ""):
    out, err = io.StringIO(), io.StringIO()
    old, sys.stdin = sys.stdin, io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Report files made by the port's CLI on the CPU: name -> path."""
    d = tmp_path_factory.mktemp("stats")
    with single_thread(), threefry_layout(True):
        for name, argv in (
                ("fuzz.json", ["fuzz", "--storm", "--metrics", "--clusters",
                               "16", "--ticks", "120"]),
                ("pool.jsonl", ["pool", "--storm", "--metrics",
                                "--majority-override", "2", "--clusters",
                                "16", "--ticks", "64", "--budget-ticks",
                                "128"]),
                ("off.json", ["fuzz", "--storm", "--clusters", "8",
                              "--ticks", "40"])):
            rc, out, _ = run(port_main, argv + ["--platform", "cpu"])
            assert rc in (0, 1) and out
            (d / name).write_text(out)
    rows = [x for x in (d / "pool.jsonl").read_text().splitlines()
            if "latency_hist" in json.loads(x)]
    (d / "rows.jsonl").write_text("\n".join(rows[:9]) + "\n")
    return {p.name: str(p) for p in d.iterdir()}


CASES = {
    "fuzz": ["fuzz.json"],
    "pool": ["pool.jsonl"],
    "fuzz+pool+json": ["fuzz.json", "pool.jsonl", "--json"],
    "rows+summary": ["rows.jsonl", "pool.jsonl", "--json"],
    "metrics-off": ["off.json"],
    "mixed": ["off.json", "fuzz.json"],
    "missing": ["no_such_file.json"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_stats_equals_the_reference(files, case):
    argv = ["stats"] + [files.get(a, a) for a in CASES[case]]
    want = run(jax_main, argv)
    got = run(port_main, argv)
    assert got == want
    assert got[0] == {"metrics-off": 2, "missing": 2}.get(case, 0)


def test_stats_reads_stdin_like_the_reference(files):
    with open(files["pool.jsonl"]) as f:
        text = f.read()
    want = run(jax_main, ["stats", "-", "--json"], stdin=text)
    got = run(port_main, ["stats", "--json"], stdin=text)
    assert got == want and got[0] == 0
    doc = json.loads(got[1].strip().splitlines()[-1])
    assert doc["latency"]["ops"] == json.loads(
        text.strip().splitlines()[-1])["latency"]["ops"]


def test_stats_follow_is_not_ported_yet(files):
    rc, out, err = run(port_main, ["stats", "--follow", files["pool.jsonl"]])
    assert rc == 2 and not out and "ROADMAP A15" in err
