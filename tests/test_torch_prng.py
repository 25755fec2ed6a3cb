"""The port's threefry2x32 and ``jax.random`` ops against the installed JAX,
under both counter layouts (``jax_threefry_partitionable`` True and False,
set and restored inside each test). Keys and data come from a seeded numpy
generator. Tolerance: exact equality of every u32 word / int32 value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import threefry_layout
from madraft_tpu.tpusim.step import _DrawBlock, _block_total, _entry_mix
from madraft_tpu_torch.kernels import oracle as oracle_k
from madraft_tpu_torch.kernels import threefry
from madraft_tpu_torch.tpusim import prng

LAYOUTS = [True, False]
RNG_SEED = 20261016


def _keys(n=6):
    rng = np.random.default_rng(RNG_SEED)
    return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _port(keys_u32):
    return torch.from_numpy(keys_u32.astype(np.int64))


def _ref(fn, keys_u32):
    return np.asarray(jax.vmap(fn)(jnp.asarray(keys_u32))).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31, 2**32 - 1])
def test_prngkey(seed):
    want = np.asarray(jax.random.PRNGKey(jnp.uint32(seed))).astype(np.int64)
    assert np.array_equal(prng.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("data", [0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1])
def test_fold_in(data, partitionable):
    keys = _keys()
    with threefry_layout(partitionable):
        want = _ref(lambda k: jax.random.fold_in(k, np.uint32(data)), keys)
        got = prng.fold_in(_port(keys), data).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split(num, partitionable):
    keys = _keys()
    with threefry_layout(partitionable):
        want = _ref(lambda k: jax.random.split(k, num), keys)
        got = prng.split(_port(keys), num).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("size", [1, 2, 7, 133, 227])
def test_bits(size, partitionable):
    keys = _keys()
    with threefry_layout(partitionable):
        want = _ref(lambda k: jax.random.bits(k, (size,)), keys)
        got = prng.bits(_port(keys), size).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("lo,hi", [
    (15, 31),                 # the init election-timer span
    (0, 1),                   # span 1
    (5, 5),                   # maxval <= minval -> minval
    (10, 3),
    (-5, 5),
    (0, (1 << 16) + 3),       # span past 2^16: the multiplier wraps to 0
    (-(2**31), 2**31 - 1),    # the widest int32 span, int32 wrap on add
])
def test_randint(lo, hi, partitionable):
    keys = _keys()
    n = 7
    with threefry_layout(partitionable):
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (n,), jnp.int32(lo), jnp.int32(hi), dtype=jnp.int32))(
                jnp.asarray(keys)))
        got = prng.randint(_port(keys), n, torch.tensor(lo, dtype=torch.int32),
                           torch.tensor(hi, dtype=torch.int32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("n_nodes", [5, 7])
def test_tick_block_matches_draw_block(n_nodes, partitionable):
    # the tick's words: _DrawBlock(fold_in(fold_in(key, t), 0), total).bits
    keys = _keys()
    total = _block_total(n_nodes)
    ticks = np.array([1, 2, 300, 2**20, 2**20 + 1, 2**31 - 1], np.int32)
    with threefry_layout(partitionable):
        want = np.asarray(jax.vmap(lambda k, t: _DrawBlock(
            jax.random.fold_in(jax.random.fold_in(k, t), 0), total).bits)(
                jnp.asarray(keys), jnp.asarray(ticks))).astype(np.int64)
        before = threefry.tick_blocks.launches
        got = threefry.tick_block(_port(keys), torch.from_numpy(ticks),
                                  total, prng.partitionable())
    assert got.shape == (len(ticks), total)
    assert np.array_equal(got.numpy(), want)
    # a CPU tensor runs the plain version and launches nothing
    assert threefry.tick_blocks.launches == before


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("n_nodes", [5, 7])
def test_tick_blocks_match_draw_block_every_tick(n_nodes, partitionable):
    # a chunk of n_ticks ticks per cluster, each cluster from its own first
    # tick; the last cluster's chunk crosses 2^31 (ticks wrap as u32)
    keys = _keys()
    total, n_ticks = _block_total(n_nodes), 5
    t0 = np.array([1, 2, 300, 2**20, 2**31 - 3, 2**31 - 1], np.int64)
    ticks = ((t0[None, :] + np.arange(n_ticks)[:, None]) % 2**32).astype(np.uint32)
    with threefry_layout(partitionable):
        want = np.asarray(jax.vmap(lambda k, t: jax.random.bits(
            jax.random.fold_in(jax.random.fold_in(k, t), 0), (total,)))(
                jnp.asarray(np.tile(keys, (n_ticks, 1))),
                jnp.asarray(ticks.reshape(-1)))).astype(np.int64)
        before = threefry.tick_blocks.launches
        got = threefry.tick_blocks(_port(keys), torch.from_numpy(t0.astype(np.int32)),
                                   n_ticks, total, prng.partitionable())
    assert got.shape == (n_ticks, len(t0), total) and got.dtype == torch.int64
    assert np.array_equal(got.reshape(-1, total).numpy(), want)
    assert threefry.tick_blocks.launches == before


def test_int32_multiply_wraps():
    # _entry_mix relies on int32 multiplies wrapping; check torch does and
    # that the port's hash equals the reference's on overflowing inputs
    x = torch.tensor([2**30, -(2**31), 2**31 - 1], dtype=torch.int32)
    assert (x * 4).tolist() == [0, 0, -4]
    rng = np.random.default_rng(RNG_SEED)
    vals = rng.integers(-(2**31), 2**31, size=(3, 64), dtype=np.int64).astype(np.int32)
    want = np.asarray(_entry_mix(*(jnp.asarray(v) for v in vals)))
    got = oracle_k.entry_mix(*(torch.from_numpy(v) for v in vals))
    assert np.array_equal(got.numpy(), want)


def test_layout_setting_follows_jax_env_spelling(monkeypatch):
    for raw, want in (("0", False), ("false", False), ("1", True), ("True", True)):
        monkeypatch.setenv("JAX_THREEFRY_PARTITIONABLE", raw)
        assert prng._env_flag("JAX_THREEFRY_PARTITIONABLE", True) is want
    monkeypatch.delenv("JAX_THREEFRY_PARTITIONABLE")
    assert prng._env_flag("JAX_THREEFRY_PARTITIONABLE", True) is True
    monkeypatch.setenv("JAX_THREEFRY_PARTITIONABLE", "maybe")
    with pytest.raises(ValueError):
        prng._env_flag("JAX_THREEFRY_PARTITIONABLE", True)


@pytest.mark.parametrize("shape", [(), (7, 1), (300, 12)])
def test_hash_on_the_cpu_equals_the_tensor_route(shape):
    """threefry's CPU route (numpy's uint32) gives the int64 tensor
    route's words (the route CUDA tensors take), key and counter words
    spanning the whole u32 range, broadcast."""
    g = torch.Generator().manual_seed(3)

    def words(s):
        return torch.randint(0, 2**32, s, generator=g, dtype=torch.int64)

    k0, k1 = words(shape), words(shape)
    x0 = words(shape[-1:] if shape else ())
    x1 = torch.full_like(x0, 2**32 - 1)
    got = threefry.hash_plain(k0, k1, x0, x1)
    want = threefry._hash_tensors(k0, k1, x0, x1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
