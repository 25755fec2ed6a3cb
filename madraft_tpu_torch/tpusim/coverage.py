"""Coverage-guided schedule search: abstract-state fingerprints, the
seen-set and the biased knob refill, batch-first.

The twin of ``madraft_tpu/tpusim/coverage.py`` (its docstring explains the
design). A cluster's abstract state is the per-node (role, alive,
term-rank, commit-delta) tuple of ``state.abstract_node_tuple``, folded into
one u32 code a lane a tick; the code picks a bit of a power-of-two seen-set
(the code itself when the whole code space fits, else a murmur3 hash of
it). u32 values travel as int64 masked to 32 bits, as in ``prng``.

The seen-set is kept as a first-tick stamp per bit: int32 ``[rows, bits]``
holding the run-wide tick that first set the bit, ``UNSEEN`` while unset.
The reference's boolean bitmap is ``seen != UNSEEN``. A lane with no
violation earns a new-fingerprint credit when its bit was unset before this
tick (its stamp is >= this tick), so two lanes landing the same new bit in
one tick both earn it, as in the reference, which reads the whole bitmap
before any lane writes. ``seen_update_plain`` is the plain version of
kernel K5 (``kernels/coverage.py``), which computes the code and updates
the stamps in one launch a tick.

``refill_knobs`` reproduces XLA's float32 arithmetic bit for bit: XLA
lowers ``exp2(x)`` to ``exp(fl32(ln2 * x))`` with a Cephes polynomial of
fused multiply-adds (``xla_exp_f32``) and contracts ``lo + u * span`` into
one FMA; ``torch.exp2`` and a separate multiply and add differ from it.
PyTorch has no float32 FMA, so ``fma_f32`` forms each one in float64 and
rounds once (exact for every input the refill can draw, which
``tests/test_torch_coverage.py`` checks over all 2^23 of them).
"""

from __future__ import annotations

import hashlib
import itertools

import numpy as np
import torch

from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import (
    CoverageConfig,
    Knobs,
    pool_lanes_per_shard,
)
from madraft_tpu_torch.tpusim.state import (
    abstract_node_tuple,
    term_rank_commit_delta,
)

I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
MASK = prng.MASK

# The storm knobs the biased refill may mutate (every per-tick Bernoulli
# probability; the reference's comment explains the choice).
MUTABLE_KNOBS = (
    "loss_prob", "p_crash", "p_restart", "p_repartition", "p_heal",
    "p_leader_part", "p_asym_cut", "p_client_cmd", "p_lose_unsynced",
)

# PRNG domain separation of the refill draws: fold_in(PRNGKey(seed ^
# _COV_SALT), new_global_id), disjoint from the cluster streams.
_COV_SALT = 0x434F5647  # "COVG"

# How a lane's knob row was produced (the coverage JSONL ``refill`` column).
REFILL_SEED, REFILL_FRESH, REFILL_MUTATE = 0, 1, 2
REFILL_NAMES = {REFILL_SEED: "seed", REFILL_FRESH: "fresh",
                REFILL_MUTATE: "mutate"}

# The seen-set stamp of a bit no lane has set.
UNSEEN = 2**31 - 1


def node_alphabet(ccfg: CoverageConfig) -> int:
    """Distinct per-node abstract values: role(3) x alive(2) x rank x delta."""
    return 3 * 2 * ccfg.term_rank_levels * ccfg.commit_delta_levels


def code_space(n_nodes: int, ccfg: CoverageConfig) -> int:
    """Size of the full abstract-code space (before reachability filters)."""
    return node_alphabet(ccfg) ** n_nodes


def identity_mapped(n_nodes: int, ccfg: CoverageConfig) -> bool:
    """True when every abstract code owns its own seen-set bit."""
    return code_space(n_nodes, ccfg) <= ccfg.bitmap_bits


def _combine_node_code(ccfg: CoverageConfig, role, alive, rank, delta):
    """The per-node quantized tuple -> one code in [0, node_alphabet)."""
    return (
        ((role * 2 + alive) * ccfg.term_rank_levels + rank)
        * ccfg.commit_delta_levels + delta
    )


def _fold_code(ccfg: CoverageConfig, node_code: torch.Tensor) -> torch.Tensor:
    """Big-endian fold of per-node codes [B, n] by node id, with u32
    wraparound: sum(code_i * a^(n-1-i)) mod 2^32 -> int64 [B]."""
    n = node_code.shape[-1]
    a = node_alphabet(ccfg)
    weights = torch.tensor([pow(a, n - 1 - i, 1 << 32) for i in range(n)],
                           dtype=I64, device=node_code.device)
    # each product is below 2^38 and the sum below 2^42: exact in int64
    return (node_code.to(I64) * weights).sum(-1) & MASK


def _code_from_tuple(ccfg: CoverageConfig, role, alive, rank, delta):
    return _fold_code(ccfg, _combine_node_code(
        ccfg, role.to(I64), alive.to(I64), rank.to(I64), delta.to(I64)))


def abstract_code(ccfg: CoverageConfig, s) -> torch.Tensor:
    """u32 abstract-state code [B] (int64) of each cluster of a wide
    state at its current tick."""
    return _code_from_tuple(ccfg, *abstract_node_tuple(
        s, ccfg.term_rank_levels, ccfg.commit_delta_levels))


def abstract_code_packed(ccfg: CoverageConfig, p) -> torch.Tensor:
    """``abstract_code`` read from the packed schema: role and alive out of
    their bitfield words, term-rank and commit-delta from the narrow term
    and commit arrays (widened: the order and the bounded delta are
    exact). The same code as ``abstract_code`` of the unpacked state."""
    term, commit = p.term.to(I64), p.commit.to(I64)
    idx = torch.arange(term.shape[-1], dtype=I64, device=term.device)
    role = (p.role_bits.to(I64)[:, None] >> (2 * idx)) & 3
    alive = (p.alive_bits.to(I64)[:, None] >> idx) & 1
    rank, delta = term_rank_commit_delta(
        term, commit, ccfg.term_rank_levels, ccfg.commit_delta_levels)
    return _code_from_tuple(ccfg, role, alive, rank, delta)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 x held in int64, without overflowing int64:
    the constant in two 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche u32 -> u32 (int64-held)."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def bitmap_index(ccfg: CoverageConfig, n_nodes: int,
                 code: torch.Tensor) -> torch.Tensor:
    """Seen-set bit of an abstract code (int64): the code itself in
    identity mode, else its avalanche hash masked to the bitmap."""
    if identity_mapped(n_nodes, ccfg):
        return code
    return _mix32(code) & (ccfg.bitmap_bits - 1)


def lane_shards(n_lanes: int, n_shards: int, device=None) -> torch.Tensor:
    """int32 [n_lanes] lane -> shard map of the per-shard seen-set: the
    contiguous-slice layout of ``config.pool_lanes_per_shard``."""
    lps = pool_lanes_per_shard(n_lanes, n_shards)
    return torch.arange(n_lanes, dtype=torch.int32, device=device) // lps


def fingerprint_index(ccfg: CoverageConfig, role, alive, term,
                      commit) -> torch.Tensor:
    """Seen-set bit [B] (int64) of each lane from its node rows [B, n]."""
    rank, delta = term_rank_commit_delta(
        term, commit, ccfg.term_rank_levels, ccfg.commit_delta_levels)
    return bitmap_index(ccfg, role.shape[-1],
                        _code_from_tuple(ccfg, role, alive, rank, delta))


def seen_update_plain(ccfg: CoverageConfig, role, alive, term, commit,
                      violations, rows, seen, new_fps, t: int):
    """K5's plain version: one tick's fingerprints into the seen-set.

    ``role``/``alive``/``term``/``commit`` [B, n] are the post-step node
    rows, ``violations`` [B] the lanes' masks, ``rows`` [B] int32 the
    seen-set row of each lane (None: row 0), ``seen`` int32 [rows, bits]
    the stamps, ``new_fps`` int32 [B] the credits and ``t`` the run-wide
    tick (below ``UNSEEN``, rising). A lane with no violation earns one
    credit when its bit's stamp is >= t (unset before this tick) and
    stamps the bit with min(stamp, t). Updates ``seen`` and ``new_fps`` in
    place and returns them."""
    bits = seen.shape[-1]
    idx = fingerprint_index(ccfg, role, alive, term, commit)
    if rows is not None:
        idx = idx + rows.to(I64) * bits
    flat = seen.view(-1)
    ok = violations == 0
    new_fps += (ok & (flat[idx] >= t)).to(new_fps.dtype)
    hit = idx[ok]
    flat.scatter_reduce_(0, hit, torch.full_like(hit, t, dtype=seen.dtype),
                         "amin")
    return seen, new_fps


def planted_fingerprint_inputs(n_nodes: int, b: int, seed: int) -> tuple:
    """K5's inputs on the CPU for its checks against the plain version:
    (role, alive, term, commit, violations) with the lanes in four groups
    of eight: random node rows; rows copied from one lane (many lanes on
    one code in one tick, the credit rule); a violation mask set (no write,
    no credit); terms and commits at their int32 extremes and ties."""
    g = torch.Generator().manual_seed(seed)

    def draw(hi, shape=(b, n_nodes)):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    role, alive = draw(3), draw(2).bool()
    term, commit = draw(8), draw(12)
    group = torch.arange(b) % 32 // 8
    same = group == 1
    for x in (role, alive, term, commit):
        x[same] = x[0].clone()
    violations = torch.where(group == 2, draw(1 << 10, (b,)) | 1, 0)
    edge = group == 3
    term[edge] = torch.where(draw(2)[edge].bool(), 2**31 - 1, 0).int()
    commit[edge] = torch.where(draw(2)[edge].bool(), 2**30, 0).int()
    return role, alive, term, commit, violations.to(torch.int32)


def seen_bits(seen: torch.Tensor) -> torch.Tensor:
    """Popcount of the union of the seen-set rows (the reference's
    ``seen_bits``), an int32 0-d tensor."""
    return (seen != UNSEEN).any(0).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# The biased refill, in XLA's float32 arithmetic.
# ---------------------------------------------------------------------------


def _f32(v: float) -> float:
    """A Python float rounded to float32 (the value a float32 constant
    holds), so that an operation with a tensor takes it as a scalar
    argument and the card gets no host-built tensor."""
    return float(np.float32(v))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fl32(a * b + c) for float32 operands (tensors or float32-exact
    Python floats): the product of two float32 values is exact in
    float64, the sum is rounded there and then once more to float32
    (equal to a true FMA unless the float64 sum lands on a float32
    rounding midpoint)."""
    a64 = a.to(F64)
    b64 = b.to(F64) if isinstance(b, torch.Tensor) else b
    c64 = c.to(F64) if isinstance(c, torch.Tensor) else c
    return (a64 * b64 + c64).to(F32)


# Cephes expf, as XLA's CPU backend evaluates it
_LOG2E = 1.44269504088896341
_C1, _C2 = -0.693359375, 2.12194440e-4
_P0 = 1.9875691500e-4
_POLY = (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)
_LN2_F32 = 0.693147182
# the float32 constants of xla_exp_f32 and xla_exp2_f32 in the order K7
# takes them (csrc/harvest.cuh Consts): log2e, C1, C2, P0, the polynomial,
# ln2
EXP_CONSTANTS = tuple(_f32(v) for v in (_LOG2E, _C1, _C2, _P0, *_POLY,
                                        _LN2_F32))


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` (CPU): m = floor(x log2e + 1/2), the reduced
    argument in two steps, a degree-6 polynomial by FMAs, times 2^m. Valid
    for |x| < 87 (the refill's arguments stay within +-ln2 * log2(mut_span))."""
    log2e, c1, c2, p0, *poly, _ = EXP_CONSTANTS
    m = torch.floor(fma_f32(x, log2e, 0.5))
    r = fma_f32(m, c1, x)
    r = fma_f32(m, c2, r)
    p = torch.full_like(x, p0)
    for c in poly:
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((m.to(torch.int32) + 127) << 23).view(F32)  # 2^m, exact
    return y * scale


def xla_exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as XLA lowers it: exp(fl32(ln2 * x))."""
    return xla_exp_f32(x * EXP_CONSTANTS[-1])


def refill_constants(ccfg: CoverageConfig) -> tuple:
    """(span, fresh_lo, fresh_hi - fresh_lo) as the float32 constants the
    reference's expressions weakly type them to (each taken in Python
    double first, as there), as float32-exact Python floats."""
    return (_f32(np.log2(ccfg.mut_span)), _f32(ccfg.fresh_lo),
            _f32(ccfg.fresh_hi - ccfg.fresh_lo))


def _mutation_factor(u: torch.Tensor, span: float) -> torch.Tensor:
    return xla_exp2_f32((u * 2.0 - 1.0) * span)


def refill_grid(ccfg: CoverageConfig, device=None) -> tuple:
    """The refill's two float32 factors over every uniform it can draw (the
    2^23 values k * 2^-23): the mutation factor exp2((2u - 1) span) and the
    fresh factor fresh_lo + u (fresh_hi - fresh_lo), in u order."""
    k = torch.arange(1 << 23, dtype=torch.int32, device=device)
    u = (k | 0x3F800000).view(F32) - 1.0
    span, lo, width = refill_constants(ccfg)
    return _mutation_factor(u, span), fma_f32(u, width, lo)


def grid_sha256(arrays) -> str:
    """SHA-256 of float32 arrays' little-endian bytes, concatenated."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype="<f4")).tobytes())
    return h.hexdigest()


def refill_knobs(ccfg: CoverageConfig, kn_lanes: Knobs, base_kn: Knobs,
                 retired, productive, new_ids, seed: int) -> tuple:
    """Per-lane knob rows and refill kinds after a harvest (the reference's
    ``refill_knobs``; its docstring gives the policy). Kept lanes keep their
    rows; a retired productive lane's child jitters each mutable knob by
    2^((2u - 1) log2(mut_span)), an unproductive one redraws it as
    base * (fresh_lo + u (fresh_hi - fresh_lo)); clipped to [0, 1]. The
    draws are ``uniform(fold_in(PRNGKey(seed ^ _COV_SALT), new_id), 9)``."""
    base = prng.PRNGKey((int(seed) & MASK) ^ _COV_SALT, new_ids.device)
    u = prng.uniform(prng.fold_in(base, new_ids), len(MUTABLE_KNOBS))
    span, lo, width = refill_constants(ccfg)
    updates = {}
    for j, name in enumerate(MUTABLE_KNOBS):
        parent = getattr(kn_lanes, name)
        b = getattr(base_kn, name)
        uj = u[:, j]
        fresh = b * fma_f32(uj, width, lo)
        mut = parent * _mutation_factor(uj, span)
        child = torch.clamp(torch.where(productive, mut, fresh), 0.0, 1.0)
        updates[name] = torch.where(retired, child, parent).to(parent.dtype)
    kinds = torch.where(productive, REFILL_MUTATE, REFILL_FRESH).to(torch.int32)
    return kn_lanes._replace(**updates), kinds


def enumerate_abstract_codes(n_nodes: int, ccfg: CoverageConfig) -> np.ndarray:
    """Every structurally-valid abstract code, sorted (the reference's
    offline ground truth; its docstring gives the filters). For tiny
    configs only."""
    space = code_space(n_nodes, ccfg)
    if space > 1 << 20:
        raise ValueError(
            f"abstract code space {space} too large to enumerate — this is "
            "the offline ground-truth harness for tiny configs "
            "(config.coverage_ground_truth), not a general counter"
        )
    levels_r, levels_c = ccfg.term_rank_levels, ccfg.commit_delta_levels
    per_node = list(itertools.product(
        range(3), range(2), range(levels_r), range(levels_c)
    ))
    codes = []
    for combo in itertools.product(per_node, repeat=n_nodes):
        ranks = [c[2] for c in combo]
        deltas = [c[3] for c in combo]
        if min(ranks) != 0 or min(deltas) != 0:
            continue
        if any(
            sum(r2 < r for r2 in ranks) != r
            for r in ranks if 0 < r < levels_r - 1
        ):
            continue
        code = 0
        for role, alive, rank, delta in combo:
            code = code * node_alphabet(ccfg) + _combine_node_code(
                ccfg, role, alive, rank, delta
            )
        codes.append(code)
    return np.asarray(sorted(codes), np.uint32)
