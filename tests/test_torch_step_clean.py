"""Parity of the port's batched tick with the JAX reference: every
ClusterState leaf at every tick, for every clean storm profile on the
5-node / ae_max=4 shape (one compiled reference program serves all).
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from _torch_parity import Pair, configs, single_thread, threefry_layout

CLEAN_5 = ("storm", "durability", "limp", "skew_storm", "fsync_stall",
           "rolling_wave", "hot_key_openloop", "gray_storm")
N_CLUSTERS, N_TICKS = 16, 200


@pytest.fixture(autouse=True)
def _one_thread():
    with single_thread():
        yield


@pytest.mark.parametrize("profile", CLEAN_5)
def test_step_matches_reference_every_tick(profile):
    with threefry_layout(True):
        pair = Pair(*configs(profile), seed=11, n_clusters=N_CLUSTERS)
        d = pair.run(N_TICKS)
    assert d is None, f"first divergence: {d}"
    # the run did real work: leaders elected, entries committed
    assert (np.asarray(pair.js.first_leader_tick) > 0).any()
    assert int(np.asarray(pair.js.shadow_len).sum()) > 0


@pytest.mark.parametrize("partitionable", [True, False])
def test_draws_by_chunks_match_reference_every_tick(partitionable):
    # the engine's draw: one tick_blocks call per chunk of ticks, sliced per
    # tick; 16 does not divide 50, so the last chunk is short
    with threefry_layout(partitionable):
        pair = Pair(*configs("storm"), seed=3, n_clusters=N_CLUSTERS)
        d = pair.run(50, chunk=16)
    assert d is None, f"first divergence: {d}"
    assert pair.tick == 50
    assert (np.asarray(pair.js.first_leader_tick) > 0).any()


def test_step_refuses_words_of_the_wrong_shape():
    with threefry_layout(True):
        pair = Pair(*configs("storm"), seed=3, n_clusters=2)
        with pytest.raises(ValueError, match="words must be"):
            pair.step(torch.zeros((2, 7), dtype=torch.int64))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", [0, 12345, 2**32 - 1])
def test_init_cluster_leaves_match(seed, partitionable):
    # skew_storm exercises the clock-skew offset on the init timers
    with threefry_layout(partitionable):
        pair = Pair(*configs("skew_storm"), seed=seed, n_clusters=N_CLUSTERS)
        assert pair.divergence() is None, pair.divergence()
