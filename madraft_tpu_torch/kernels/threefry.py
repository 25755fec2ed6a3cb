"""Kernel K1: threefry2x32, the counter-based hash behind every random draw.

Replaces the draw sites of the JAX reference:
``madraft_tpu/tpusim/step.py`` ``_DrawBlock.__init__`` (one ``bits`` call of
the tick's whole budget, under ``fold_in(fold_in(cluster_key, t), 0)``) and
``madraft_tpu/tpusim/engine.py`` ``_cluster_keys`` (``fold_in`` of the seed
key by cluster id). Source: ``csrc/threefry.cu``.

Two entries, each with its plain PyTorch version beside it:

- ``hash_pairs(keys, x0, x1)`` hashes counter pairs under per-row keys; the
  ``prng`` module builds ``fold_in``, ``split`` and ``bits`` on it.
- ``tick_blocks(keys, t0, n_ticks, total, partitionable)`` derives each
  cluster's key at ticks ``t0[b] .. t0[b] + n_ticks - 1`` and writes the
  whole ``[n_ticks, B, total]`` chunk of draw words in one launch.
  ``tick_block`` is its one-tick case.

Words travel as int64 holding an unsigned 32-bit value (masked with
``0xFFFFFFFF``): the CPU's UInt32 tensors lack add, shifts and compares, and
the step code then reads the same int64 words on both devices. The kernels
compute in ``uint32``. ``tick_blocks`` reads the int64 keys and writes the
int64 words itself; ``hash_pairs`` goes through int32 copies.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from madraft_tpu_torch import _build

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ------------------------------------------------------------ plain versions
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def _hash_numpy(k0, k1, x0, x1):
    """hash_plain on CPU inputs, in numpy's uint32 (wrapping adds and
    logical shifts: five array operations a round where the int64 tensors
    take seven, each a fraction of a small tensor operation's cost)."""
    k0, k1, x0, x1 = (
        np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                   dtype=np.int64).astype(np.uint32)
        for v in (k0, k1, x0, x1))
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return (torch.from_numpy(np.asarray(x0, dtype=np.int64)),
            torch.from_numpy(np.asarray(x1, dtype=np.int64)))


def hash_plain(k0, k1, x0, x1):
    """threefry2x32 (20 rounds) on int64-held u32 words; all four inputs
    broadcast. Returns the two output words (on the CPU computed in numpy,
    ``_hash_numpy``; on a device by ``_hash_tensors``)."""
    if all(not isinstance(v, torch.Tensor) or v.device.type == "cpu"
           for v in (k0, k1, x0, x1)):
        return _hash_numpy(k0, k1, x0, x1)
    return _hash_tensors(k0, k1, x0, x1)


def _hash_tensors(k0, k1, x0, x1):
    """hash_plain in int64 tensor operations, on any device."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def hash_pairs_plain(keys, x0, x1):
    """keys [B, 2], counters x0/x1 [B, M] -> (y0, y1) [B, M]."""
    return hash_plain(keys[:, 0:1], keys[:, 1:2], x0, x1)


def _fold_in_plain(keys, data):
    """fold_in(key, data) = threefry(key, (0, data)), per row."""
    y0, y1 = hash_plain(keys[:, 0], keys[:, 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def block_counters(total: int, partitionable: bool, device=None):
    """The counter pairs a ``bits`` draw of ``total`` words hashes, and how
    their outputs become words.

    Partitionable layout: pair j is (0, j) and word j = y0 ^ y1.
    Legacy layout: the counters 0..total-1 (padded with one 0 when total
    is odd) split in halves, pair j = (j, j + h), and the words are the y0
    outputs followed by the y1 outputs, cut to ``total``."""
    if partitionable:
        lo = torch.arange(total, dtype=torch.int64, device=device)
        return torch.zeros_like(lo), lo
    h = (total + 1) // 2
    iota = torch.arange(2 * h, dtype=torch.int64, device=device)
    iota[total:] = 0
    return iota[:h], iota[h:]


def words_from_pairs(y0, y1, total: int, partitionable: bool):
    if partitionable:
        return y0 ^ y1
    return torch.cat([y0, y1], dim=-1)[..., :total]


def tick_blocks_plain(keys, t0, n_ticks: int, total: int, partitionable: bool):
    """keys [B, 2] cluster keys, t0 [B] first ticks -> [n_ticks, B, total]
    draw words; row (i, b) is fold_in(fold_in(keys[b], t0[b] + i), 0)'s
    block (ticks wrap as u32, as JAX's int32 ticks do)."""
    b = keys.shape[0]
    i = torch.arange(n_ticks, dtype=torch.int64, device=keys.device)
    t = (t0.to(torch.int64)[None, :] + i[:, None]) & MASK  # [n_ticks, B]
    k = _fold_in_plain(keys.expand(n_ticks, b, 2).reshape(-1, 2), t.reshape(-1))
    k = _fold_in_plain(k, torch.zeros_like(t.reshape(-1)))
    x0, x1 = block_counters(total, partitionable, keys.device)
    y0, y1 = hash_pairs_plain(k, x0, x1)
    return words_from_pairs(y0, y1, total, partitionable).reshape(
        n_ticks, b, total)


def tick_block_plain(keys, t, total: int, partitionable: bool):
    """keys [B, 2] cluster keys, t [B] ticks -> [B, total] draw words of
    fold_in(fold_in(key, t), 0)."""
    return tick_blocks_plain(keys, t, 1, total, partitionable)[0]


# ------------------------------------------------------------------ kernels
def _lib():
    lib = _build.library("threefry")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.threefry_hash_pairs.argtypes = [p, p, p, p, p, i, i, p]
        lib.threefry_hash_pairs.restype = ctypes.c_int
        lib.threefry_tick_blocks.argtypes = [p, p, p, i, i, i, i, p]
        lib.threefry_tick_blocks.restype = ctypes.c_int
        lib._typed = True
    return lib


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _widen(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK


def _check_cuda(*tensors):
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got one on {x.device}")


def hash_pairs(keys, x0, x1):
    """keys [B, 2], counters x0/x1 broadcastable to [B, M] (int64-held u32)
    -> (y0, y1) [B, M]."""
    if keys.device.type == "cpu":
        return hash_pairs_plain(keys, x0, x1)
    _check_cuda(keys, x0, x1)
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [B, 2], got {tuple(keys.shape)}")
    b = keys.shape[0]
    x0, x1 = torch.broadcast_tensors(x0, x1)
    m = x0.shape[-1]
    x0 = _as_i32(x0.expand(b, m))
    x1 = _as_i32(x1.expand(b, m))
    k = _as_i32(keys)
    y0 = torch.empty((b, m), dtype=torch.int32, device=keys.device)
    y1 = torch.empty_like(y0)
    if b * m:
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        _build.check(_lib().threefry_hash_pairs(
            k.data_ptr(), x0.data_ptr(), x1.data_ptr(), y0.data_ptr(),
            y1.data_ptr(), b, m, stream), "threefry_hash_pairs")
        hash_pairs.launches += 1
    return _widen(y0), _widen(y1)


hash_pairs.launches = 0


def tick_blocks(keys, t0, n_ticks: int, total: int, partitionable: bool):
    """keys [B, 2] cluster keys (int64-held u32), t0 [B] int32 first ticks
    -> the [n_ticks, B, total] int64-held draw words of ticks
    t0 .. t0 + n_ticks - 1, in one launch."""
    if keys.device.type == "cpu":
        return tick_blocks_plain(keys, t0, n_ticks, total, partitionable)
    _check_cuda(keys, t0)
    b = keys.shape[0]
    if (keys.shape != (b, 2) or keys.dtype != torch.int64
            or t0.shape != (b,) or t0.dtype != torch.int32):
        raise ValueError(
            f"tick_blocks wants keys [B, 2] int64 and t0 [B] int32, got "
            f"{tuple(keys.shape)} {keys.dtype} and {tuple(t0.shape)} {t0.dtype}")
    if n_ticks < 1 or total < 1:
        raise ValueError(f"tick_blocks: bad n_ticks={n_ticks} total={total}")
    keys = keys if keys.is_contiguous() else keys.contiguous()
    t0 = t0 if t0.is_contiguous() else t0.contiguous()
    out = torch.empty((n_ticks, b, total), dtype=torch.int64, device=keys.device)
    if b:
        _build.check(_lib().threefry_tick_blocks(
            keys.data_ptr(), t0.data_ptr(), out.data_ptr(), b, n_ticks, total,
            int(bool(partitionable)),
            torch.cuda.current_stream(keys.device).cuda_stream),
            "threefry_tick_blocks")
        tick_blocks.launches += 1
    return out


tick_blocks.launches = 0


def tick_block(keys, t, total: int, partitionable: bool):
    """keys [B, 2] cluster keys (int64-held u32), t [B] int32 ticks -> the
    [B, total] int64-held draw words of the tick: ``tick_blocks`` of one
    tick (its launches count there)."""
    return tick_blocks(keys, t, 1, total, partitionable)[0]
