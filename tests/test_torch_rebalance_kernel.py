"""The shard controller's rebalance as K10 and K11's computed controller
run it (``csrc/ctrler.cuh`` ``rebalance`` and ``min_moves``, built for
the host with g++ through ``tests/ctrler_host_emu.cpp``) against the
plain ``_rebalance`` and ``_min_moves`` of ``tpusim/ctrler.py``:
every member mask of 1 to 10 gids, under several owner tables (every
shard unowned, one owner, a balanced spread, owners past the gids, and
seeded random tables), each tie rotation, plain, greedy and reshuffled.
Skips only where there is no g++. Tolerance: exact equality."""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

import _kernel_host
from madraft_tpu_torch.tpusim import ctrler as pct

SHARDS = pct.N_SHARDS


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = pathlib.Path(tmp_path_factory.mktemp("rebalance_host"))
    out = _kernel_host.build_ctrler(d, False)
    p, i = ctypes.c_void_p, ctypes.c_int
    out.ctrler_rebalance_batch.argtypes = [i, i, p, p, p, i, i, p, p]
    out.ctrler_rebalance_batch.restype = i
    return out


def owner_tables(ng: int) -> np.ndarray:
    """[T, SHARDS] owner tables for ng gids: all unowned, all gid 0, a
    round-robin spread, the last gid and past it, and six seeded random
    tables over [-1, ng + 1]."""
    rng = np.random.default_rng(1000 + ng)
    fixed = [np.full(SHARDS, -1), np.zeros(SHARDS, dtype=np.int64),
             np.arange(SHARDS) % ng,
             np.where(np.arange(SHARDS) % 2 == 0, ng - 1, ng)]
    rand = rng.integers(-1, ng + 2, size=(6, SHARDS))
    return np.concatenate([np.stack(fixed), rand]).astype(np.int32)


@pytest.mark.parametrize("ng", range(1, 11))
def test_rebalance_and_min_moves_equal_plain_for_every_member_mask(lib, ng):
    tables = owner_tables(ng)
    masks = np.arange(1 << ng, dtype=np.int32)
    # every (mask, table, tie rotation) triple
    m = np.repeat(masks, len(tables) * ng)
    own = np.tile(np.repeat(tables, ng, axis=0), (len(masks), 1))
    rot = np.tile(np.arange(ng, dtype=np.int32), len(masks) * len(tables))
    b = len(m)
    member = torch.from_numpy(((m[:, None] >> np.arange(ng)) & 1) > 0)
    owner_t = torch.from_numpy(own)
    want_moves = pct._min_moves(ng, member, owner_t).numpy()
    for greedy, reshuffle in ((False, False), (True, False), (False, True)):
        out = np.empty((b, SHARDS), dtype=np.int32)
        moves = np.empty(b, dtype=np.int32)
        own_c = np.ascontiguousarray(own)
        assert lib.ctrler_rebalance_batch(
            ng, b, m.ctypes.data, own_c.ctypes.data, rot.ctypes.data,
            int(greedy), int(reshuffle), out.ctypes.data,
            moves.ctypes.data) == 0
        want = pct._rebalance(ng, member, owner_t, torch.from_numpy(rot),
                              greedy, reshuffle).numpy()
        bad = np.flatnonzero((out != want).any(-1))
        assert bad.size == 0, (
            f"ng={ng} greedy={greedy} reshuffle={reshuffle}: mask "
            f"{m[bad[0]]:#x} owner {own[bad[0]].tolist()} rot {rot[bad[0]]}:"
            f" {out[bad[0]].tolist()} != {want[bad[0]].tolist()}")
        assert np.array_equal(moves, want_moves), f"min_moves, ng={ng}"
