"""Shared drivers for the PyTorch port's parity tests (tests/test_torch_*).

The same config, seed and threefry counter layout go through the JAX
reference (``madraft_tpu``, on the CPU) and the port (``madraft_tpu_torch``,
on the CPU, where each kernel wrapper runs its plain version). The
tolerance is exact equality everywhere: the simulator is integer
arithmetic, exact float32 compares and threefry bits.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madraft_tpu.tpusim import engine as jengine
from madraft_tpu.tpusim.config import storm_profiles as jax_profiles
from madraft_tpu.tpusim.state import ClusterState as JaxState
from madraft_tpu.tpusim.state import init_cluster as jax_init
from madraft_tpu.tpusim.step import step_cluster as jax_step_one
from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.tpusim import engine as pengine
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim import state as pstate
from madraft_tpu_torch.tpusim import step as pstep
from madraft_tpu_torch.tpusim.config import storm_profiles as port_profiles


@contextlib.contextmanager
def threefry_layout(flag: bool):
    """Set the counter layout on both sides, restoring both afterwards."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", bool(flag))
    try:
        with prng.layout(flag):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@contextlib.contextmanager
def single_thread():
    """One intra-op thread for the port's many small CPU ops (the suite
    runs several workers side by side)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def configs(profile: str, bug: str = "", **overrides):
    """(JAX cfg, port cfg) of one storm profile with an optional bug."""
    kw = dict(overrides, bug=bug)
    return (jax_profiles()[profile][0].replace(**kw),
            port_profiles()[profile][0].replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_programs(static_cfg, partitionable: bool):
    # one jitted, vmapped init and step per static key and layout (the
    # layout is read while tracing)
    init = jax.jit(jax.vmap(functools.partial(jax_init, static_cfg),
                            in_axes=(0, None)))
    step = jax.jit(jax.vmap(functools.partial(jax_step_one, static_cfg),
                            in_axes=(0, 0, None)))
    return init, step


def jax_host(s) -> dict:
    return {f: np.asarray(getattr(s, f)) for f in JaxState._fields}


def jax_to_device(h: dict):
    return JaxState(*(jnp.asarray(h[f]) for f in JaxState._fields))


class Pair:
    """The reference and the port stepping the same batch side by side."""

    def __init__(self, jcfg, pcfg, seed: int, n_clusters: int):
        self.jcfg, self.pcfg = jcfg, pcfg
        flag = prng.partitionable()
        assert flag == jax.config.jax_threefry_partitionable
        init, self._jstep = _jax_programs(jcfg.static_key(), flag)
        self.jkn = jcfg.knobs()
        self.jkeys = jengine._cluster_keys(jnp.uint32(seed), n_clusters)
        self.pkn = pcfg.knobs("cpu")
        self.pkeys = pengine.cluster_keys(seed, n_clusters, "cpu")
        self.js = init(self.jkeys, self.jkn)
        self.ps = pstate.init_cluster(pcfg, self.pkeys, self.pkn)
        self.tick = 0

    def divergence(self):
        return pstate.first_divergence(
            self.tick, jax_host(self.js), pstate.state_to_numpy(self.ps))

    def set_state(self, h: dict):
        """Load one host state (field -> array) into both sides."""
        self.js = jax_to_device(h)
        self.ps = pstate.state_from_numpy(h)

    def step(self, words=None):
        self.js = self._jstep(self.js, self.jkeys, self.jkn)
        self.ps = pstep.step_cluster(self.pcfg, self.ps, self.pkeys, self.pkn,
                                     words=words)
        self.tick += 1

    def run(self, n_ticks: int, chunk: int = 0):
        """Step both sides, comparing every leaf at every tick; returns the
        first divergence (tick, leaf, clusters) or None. With ``chunk`` the
        port's draw words come ``chunk`` ticks at a time from one
        ``tick_blocks`` call, as the engine draws them."""
        total = pstep._block_total(self.pcfg.n_nodes)
        d = self.divergence()
        for done in range(0, n_ticks, chunk or 1):
            m = min(chunk, n_ticks - done) if chunk else 1
            words = threefry.tick_blocks(
                self.pkeys, self.ps.tick + 1, m, total,
                prng.partitionable()) if chunk else [None]
            for i in range(m):
                if d is not None:
                    return d
                self.step(words[i])
                d = self.divergence()
        return d
