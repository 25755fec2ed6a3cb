"""The ``jax.random`` operations the port calls, on threefry2x32.

Keys are int64 tensors ``[..., 2]`` holding two unsigned 32-bit words, and
every draw is an int64 tensor of u32 words (see ``kernels/threefry.py``).
Each op reproduces the installed JAX's bits exactly, in both counter layouts
(``jax/_src/prng.py``: ``_threefry_split_foldlike`` /
``_threefry_split_original``, ``_threefry_random_bits_partitionable`` /
``_threefry_random_bits_original``; ``jax/_src/random.py`` ``_randint``).

The layout is one process-wide setting, read at import from the variable
JAX reads, ``JAX_THREEFRY_PARTITIONABLE`` (default True, as in JAX 0.9.0).
``set_partitionable`` changes it; ``layout`` scopes a change.
"""

from __future__ import annotations

import contextlib
import os

import torch

from madraft_tpu_torch.kernels import threefry

MASK = threefry.MASK

_TRUE = ("y", "yes", "t", "true", "on", "1")
_FALSE = ("n", "no", "f", "false", "off", "0")


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"invalid truth value {raw!r} for environment {name!r}")


_layout = {"partitionable": _env_flag("JAX_THREEFRY_PARTITIONABLE", True)}


def partitionable() -> bool:
    """True under the partitionable counter layout, False under legacy."""
    return _layout["partitionable"]


def set_partitionable(flag: bool) -> None:
    _layout["partitionable"] = bool(flag)


@contextlib.contextmanager
def layout(flag: bool):
    """Run a block under one counter layout, restoring the previous one."""
    old = partitionable()
    set_partitionable(flag)
    try:
        yield
    finally:
        set_partitionable(old)


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, int):  # a fill on the device, no copy from the host
        return torch.full((), x & MASK, dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of a 32-bit seed: the key (0, seed)."""
    seed = _u32(seed, device)
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def _rows(keys: torch.Tensor):
    lead = keys.shape[:-1]
    return keys.reshape(-1, 2), lead


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per key: threefry(key, (0, data mod 2^32)).
    ``data`` broadcasts against the keys' leading shape."""
    data = _u32(data, keys.device)
    lead = torch.broadcast_shapes(keys.shape[:-1], data.shape)
    k = keys.expand(*lead, 2).reshape(-1, 2)
    d = data.expand(lead).reshape(-1, 1)
    y0, y1 = threefry.hash_pairs(k, torch.zeros_like(d), d)
    return torch.cat([y0, y1], dim=-1).reshape(*lead, 2)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` per key -> [..., num, 2]."""
    k, lead = _rows(keys)
    if partitionable():
        lo = torch.arange(num, dtype=torch.int64, device=keys.device)
        y0, y1 = threefry.hash_pairs(k, torch.zeros_like(lo), lo)
        out = torch.stack([y0, y1], dim=-1)
    else:
        iota = torch.arange(2 * num, dtype=torch.int64, device=keys.device)
        y0, y1 = threefry.hash_pairs(k, iota[:num], iota[num:])
        out = torch.cat([y0, y1], dim=-1).reshape(-1, num, 2)
    return out.reshape(*lead, num, 2)


def bits(keys: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.random.bits(key, (size,))`` (32-bit) per key -> [..., size]."""
    k, lead = _rows(keys)
    flag = partitionable()
    x0, x1 = threefry.block_counters(size, flag, keys.device)
    y0, y1 = threefry.hash_pairs(k, x0, x1)
    return threefry.words_from_pairs(y0, y1, size, flag).reshape(*lead, size)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (XLA's integer convert)."""
    x = x & MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def randint(keys: torch.Tensor, size: int, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (size,), minval, maxval, dtype=int32)``
    per key -> int32 [..., size]. Like JAX it draws two bit streams from
    ``split(key)`` and reduces with u32 ``rem`` (no rejection)."""
    k = split(keys, 2)
    hi = bits(k[..., 0, :], size)
    lo = bits(k[..., 1, :], size)
    minval = torch.as_tensor(minval, device=keys.device).to(torch.int64)
    maxval = torch.as_tensor(maxval, device=keys.device).to(torch.int64)
    span = (maxval - minval) & MASK  # int32 subtract, reinterpreted as u32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = (mult * mult) & MASK
    mult = mult % span
    off = ((hi % span) * mult) & MASK
    off = (off + (lo % span)) & MASK
    off = off % span
    return _wrap_i32(minval + off)


def uniform(keys: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.random.uniform(key, (size,))`` (float32 on [0, 1)) per key ->
    float32 [..., size]: the top 23 bits of each word as the mantissa of a
    float in [1, 2), minus 1, floored at 0 as JAX's ``max(minval, .)``
    does."""
    w = bits(keys, size)
    one = (w >> 9) | 0x3F800000  # < 2^31: exact as int32
    return torch.clamp(one.to(torch.int32).view(torch.float32) - 1.0, min=0.0)


def bernoulli(keys: torch.Tensor, p, size: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (size,))`` per key -> bool [..., size]:
    ``uniform < p`` in float32. ``p`` is a float32 tensor, 0-d or one value
    a key (``[...]``, the keys' leading shape)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=keys.device)
    if p.dim():
        p = p[..., None]
    return uniform(keys, size) < p
