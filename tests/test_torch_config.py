"""The port's JAX-free config twin against ``madraft_tpu.tpusim.config``:
every SimConfig field and default, the scenario registry, the gate table,
the violation-name decoder, the knob dtypes (float32 probabilities, int32
counts), and CoverageConfig with the coverage ground-truth config.
Tolerance: exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from madraft_tpu.tpusim import config as jcfg
from madraft_tpu_torch.tpusim import config as pcfg


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SimConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pcfg.SimConfig)]
    assert pf == jf
    a, b = jcfg.SimConfig(), pcfg.SimConfig()
    assert (a.flow_cap, a.majority) == (b.flow_cap, b.majority)
    assert dataclasses.asdict(a.static_key()) == dataclasses.asdict(b.static_key())


def test_registry_and_constants_match():
    jp, pp = jcfg.storm_profiles(), pcfg.storm_profiles()
    assert list(pp) == list(jp)
    for name in jp:
        (ja, *jrest), (pa, *prest) = jp[name], pp[name]
        assert dataclasses.asdict(pa) == dataclasses.asdict(ja), name
        assert prest == jrest, name
    assert pcfg.profile_gates() == jcfg.profile_gates()
    assert pcfg.RAFT_BUGS == jcfg.RAFT_BUGS
    assert pcfg.VIOLATION_NAMES == jcfg.VIOLATION_NAMES
    assert pcfg.NOOP_CMD == jcfg.NOOP_CMD
    for bit in ("DUAL_LEADER", "LOG_MATCHING", "COMMIT_SHADOW",
                "PREFIX_DIVERGE"):
        assert getattr(pcfg, f"VIOLATION_{bit}") == getattr(jcfg, f"VIOLATION_{bit}")
    for mask in (0, 1, 7, 512 | 4, 1 << 20 | 2):
        assert pcfg.violation_names(mask) == jcfg.violation_names(mask)
    assert pcfg.metrics_dims(pcfg.SimConfig()) == jcfg.metrics_dims(jcfg.SimConfig())


@pytest.mark.parametrize("profile", ["storm", "gray_storm", "rolling_wave"])
def test_knobs_match_in_value_and_dtype(profile):
    jk = jcfg.storm_profiles()[profile][0].knobs()
    pk = pcfg.storm_profiles()[profile][0].knobs()
    assert pk._fields == jk._fields
    for name, a, b in zip(jk._fields, jk, pk):
        a = np.asarray(a)
        assert b.shape == () and str(b.dtype) == f"torch.{a.dtype}", name
        assert b.item() == a.item(), name
    assert pk.loss_prob.dtype == torch.float32


def test_config_validation_matches():
    for bad in (dict(log_cap=48), dict(bug="nope"), dict(fsync_every=0),
                dict(rolling_period=4, rolling_down=4),
                dict(uncommitted_cap=60)):
        with pytest.raises(ValueError):
            jcfg.SimConfig(**bad)
        with pytest.raises(ValueError):
            pcfg.SimConfig(**bad)


def test_coverage_config_matches_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.CoverageConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pcfg.CoverageConfig)]
    assert pf == jf
    (jc, jcc, jh), (pc, pcc, ph) = (jcfg.coverage_ground_truth(),
                                    pcfg.coverage_ground_truth())
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(pcc) == dataclasses.asdict(jcc) and ph == jh
    assert dataclasses.asdict(pcc.fingerprint_key()) \
        == dataclasses.asdict(jcc.fingerprint_key())
    for bad in (dict(bitmap_bits=100), dict(term_rank_levels=1),
                dict(mut_span=1.0), dict(fresh_lo=3.0, fresh_hi=2.0)):
        with pytest.raises(ValueError):
            jcfg.CoverageConfig(**bad)
        with pytest.raises(ValueError):
            pcfg.CoverageConfig(**bad)
