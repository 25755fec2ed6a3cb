"""Kernel K2: the per-tick safety oracle.

Replaces the oracle block of the JAX reference's tick,
``madraft_tpu/tpusim/step.py`` ``step_cluster`` lines 961-1081: election
safety (two live leaders in one term), log matching over the ``[n, n,
cap]`` ring overlap, the commit-durability shadow walk, the prefix-hash
checks, and the block's tail: ``violations |= viol``,
``first_violation_tick`` and ``first_leader_tick``. Source:
``csrc/oracle.cu``.

With the metrics plane on, the caller also passes ``log_tick`` [B, n, cap]
(the entries' submit stamps) and gets a tenth output, ``shadow_sub`` [B,
cap]: this tick's scratch, 0 except on the lanes the walk newly records,
which copy the recording node's stamp (ref step.py:1008-1023). That is the
same kernel's metrics instance, a template flag; without ``log_tick`` the
kernel computes what it computed before.

Inputs are the state after commit advance, the pre-tick shadow, the
pre-tick violation record and the tick ``t``; outputs are the tick's
violation bits (1, 2, 4, 512), the new shadow and the new violation record.
``base`` cannot change between the reference's ``abs_arr`` (step.py:584)
and its oracle (compaction runs after), so the lane indices are rebuilt
from ``base`` here.

On a CPU tensor ``oracle`` runs ``oracle_plain``; on a CUDA tensor it
launches the kernel or raises. ``oracle.launches`` counts launches, and
``oracle.metrics_launches`` those of them that ran the metrics instance.
"""

from __future__ import annotations

import ctypes

import torch

from madraft_tpu_torch import _build

LEADER = 2
VIOLATION_DUAL_LEADER = 1
VIOLATION_LOG_MATCHING = 2
VIOLATION_COMMIT_SHADOW = 4
VIOLATION_PREFIX_DIVERGE = 512
BIG = 1 << 30  # sentinel above any absolute log index
MAX_NODES = 16
MAX_CAP = 256  # the kernel gives each ring lane one thread of a 256-thread block

FIELDS_IN = (
    "alive", "role", "term", "log_term", "log_val", "log_len", "base",
    "commit", "prefix_hash", "shadow_term", "shadow_val", "shadow_base",
    "shadow_len", "shadow_prefix_hash", "violations",
    "first_violation_tick", "first_leader_tick", "t",
)


def lane_abs(base: torch.Tensor, cap: int) -> torch.Tensor:
    """Absolute index each ring lane holds for a window anchored at
    ``base`` [...]: the a in (base, base + cap] with (a - 1) mod cap ==
    lane. Returns [..., cap] int32."""
    k = torch.arange(cap, dtype=torch.int32, device=base.device)
    b = base[..., None]
    return b + ((k - b) & (cap - 1)) + 1


def entry_mix(term, val, abs_idx):
    """Position-sensitive entry hash whose XOR-fold is order-free; int32
    multiplies wrap, as in the reference."""
    h = (val ^ (abs_idx * -1640531527)) * -2048144789
    return h ^ (term * -1028477387)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two long) by halving."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def oracle_plain(alive, role, term, log_term, log_val, log_len, base, commit,
                 prefix_hash, shadow_term, shadow_val, shadow_base,
                 shadow_len, shadow_prefix_hash, violations,
                 first_violation_tick, first_leader_tick, t, log_tick=None):
    """The reference's oracle block on a batch. Shapes: per-node [B, n],
    logs [B, n, cap], shadow [B, cap], scalars [B] (``t`` is the tick).
    Returns (viol [B], shadow_term, shadow_val, shadow_base, shadow_len,
    shadow_prefix_hash, violations, first_violation_tick,
    first_leader_tick), and ``shadow_sub`` [B, cap] after them when
    ``log_tick`` is given."""
    n, cap = log_term.shape[-2], log_term.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=alive.device)
    zero = torch.zeros_like(shadow_base)
    abs_arr = lane_abs(base, cap)  # [B, n, cap]
    # election safety
    is_lead = alive & (role == LEADER)
    dual = (is_lead[:, :, None] & is_lead[:, None, :] & ~eye
            & (term[:, :, None] == term[:, None, :]))
    viol = torch.where(dual.any(-1).any(-1), VIOLATION_DUAL_LEADER, zero)
    # log matching over each pair's ring overlap
    live = abs_arr <= log_len[..., None]
    overlap = ((abs_arr[:, :, None, :] == abs_arr[:, None, :, :])
               & live[:, :, None, :] & live[:, None, :, :])
    t_eq = log_term[:, :, None, :] == log_term[:, None, :, :]
    v_eq = log_val[:, :, None, :] == log_val[:, None, :, :]
    tmatch = overlap & t_eq
    bad = overlap & ~(t_eq & v_eq)
    a4 = abs_arr[:, :, None, :]
    min_bad = torch.where(bad, a4, BIG).amin(-1)
    max_tm = torch.where(tmatch, a4, 0).amax(-1)
    viol = viol | torch.where(
        (min_bad <= max_tm).any(-1).any(-1), VIOLATION_LOG_MATCHING, zero)
    # commit durability: slide the shadow window, fold what slid out
    need = torch.where(alive, commit, 0).amax(-1)
    new_base = torch.maximum(shadow_base, need - cap)
    old_abs = lane_abs(shadow_base, cap)
    slide = old_abs <= torch.minimum(new_base, shadow_len)[:, None]
    new_hash = shadow_prefix_hash ^ xor_reduce(torch.where(
        slide, entry_mix(shadow_term, shadow_val, old_abs), 0))
    sh_abs = lane_abs(new_base, cap)
    st, sv, sl = shadow_term, shadow_val, shadow_len
    ss = None if log_tick is None else torch.zeros_like(shadow_term)
    for i in range(n):  # sequential in node order
        c = commit[:, i]
        agree = sh_abs == abs_arr[:, i]
        known = agree & (sh_abs <= torch.minimum(c, sl)[:, None])
        differ = known & ((st != log_term[:, i]) | (sv != log_val[:, i]))
        viol = viol | torch.where(
            differ.any(-1), VIOLATION_COMMIT_SHADOW, zero)
        new = agree & (sh_abs > sl[:, None]) & (sh_abs <= c[:, None])
        st = torch.where(new, log_term[:, i], st)
        sv = torch.where(new, log_val[:, i], sv)
        if ss is not None:
            ss = torch.where(new, log_tick[:, i], ss)
        sl = torch.maximum(sl, c)
    # prefix durability: equal boundaries must mean equal prefix hashes
    same_base = ((base[:, :, None] == base[:, None, :]) & (base[:, :, None] > 0)
                 & ~eye & alive[:, :, None] & alive[:, None, :])
    viol = viol | torch.where(
        (same_base & (prefix_hash[:, :, None] != prefix_hash[:, None, :]))
        .any(-1).any(-1), VIOLATION_PREFIX_DIVERGE, zero)
    vs_shadow = (alive & (base == shadow_base[:, None]) & (base > 0)
                 & (prefix_hash != shadow_prefix_hash[:, None]))
    viol = viol | torch.where(
        vs_shadow.any(-1), VIOLATION_PREFIX_DIVERGE, zero)
    # the block's tail: the run's violation record
    first_violation_tick = torch.where(
        (first_violation_tick < 0) & (viol != 0), t, first_violation_tick)
    first_leader_tick = torch.where(
        (first_leader_tick < 0) & is_lead.any(-1), t, first_leader_tick)
    outs = (viol, st, sv, new_base, sl, new_hash, violations | viol,
            first_violation_tick, first_leader_tick)
    return outs if ss is None else outs + (ss,)


def _lib():
    lib = _build.library("oracle")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.oracle_launch.argtypes = [p] * 19 + [p] * 10 + [i, i, i, p]
        lib.oracle_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _want(b: int, n: int, cap: int) -> dict:
    """(shape, dtype) of each input, by name."""
    want = {"alive": ((b, n), torch.bool),
            "log_term": ((b, n, cap), torch.int32),
            "log_val": ((b, n, cap), torch.int32),
            "shadow_term": ((b, cap), torch.int32),
            "shadow_val": ((b, cap), torch.int32)}
    for name in ("role", "term", "log_len", "base", "commit", "prefix_hash"):
        want[name] = ((b, n), torch.int32)
    for name in FIELDS_IN[11:]:
        want[name] = ((b,), torch.int32)
    return want


_WANT: dict = {}


def oracle(alive, role, term, log_term, log_val, log_len, base, commit,
           prefix_hash, shadow_term, shadow_val, shadow_base, shadow_len,
           shadow_prefix_hash, violations, first_violation_tick,
           first_leader_tick, t, log_tick=None):
    """The oracle block: plain version on the CPU, kernel K2 on CUDA (its
    metrics instance when ``log_tick`` is given)."""
    args = (alive, role, term, log_term, log_val, log_len, base, commit,
            prefix_hash, shadow_term, shadow_val, shadow_base, shadow_len,
            shadow_prefix_hash, violations, first_violation_tick,
            first_leader_tick, t)
    if alive.device.type == "cpu":
        return oracle_plain(*args, log_tick=log_tick)
    b, n, cap = log_term.shape
    key = (b, n, cap)
    if key not in _WANT:
        if n > MAX_NODES or cap > MAX_CAP:
            raise ValueError(
                f"oracle kernel takes n <= {MAX_NODES} and cap <= {MAX_CAP}, "
                f"got n={n} cap={cap}")
        _WANT[key] = tuple(_want(b, n, cap)[f] for f in FIELDS_IN)
    dev = alive.device
    names, wants = FIELDS_IN, _WANT[key]
    metrics = log_tick is not None
    if metrics:
        args += (log_tick,)
        names += ("log_tick",)
        wants += (wants[3],)  # log_term's shape and dtype
    for name, x, (shape, dtype) in zip(names, args, wants):
        if x.device != dev or x.shape != shape or x.dtype != dtype:
            raise ValueError(
                f"oracle: {name} is {tuple(x.shape)} {x.dtype} on {x.device},"
                f" expected {shape} {dtype} on {dev}")
    ins = [x if x.is_contiguous() else x.contiguous() for x in args]
    # the outputs are views of one allocation: st, sv (and shadow_sub),
    # then seven [B]
    rows = 3 if metrics else 2
    out = torch.empty((rows * b * cap + 7 * b,), dtype=torch.int32,
                      device=dev)
    st, sv, *ss = out[:rows * b * cap].view(rows, b, cap).unbind(0)
    viol, sb, sl, sh, vio, fvt, flt = out[rows * b * cap:].view(7, b).unbind(0)
    outs = (viol, st, sv, sb, sl, sh, vio, fvt, flt, *ss)
    if b:
        ptr = [x.data_ptr() for x in ins]
        optr = [x.data_ptr() for x in outs]
        _build.check(_lib().oracle_launch(
            *ptr[:18], ptr[18] if metrics else None, *optr[:9],
            optr[9] if metrics else None, b, n, cap,
            torch.cuda.current_stream(dev).cuda_stream),
            "oracle_launch")
        oracle.launches += 1
        oracle.metrics_launches += int(metrics)
    return outs


oracle.launches = 0
oracle.metrics_launches = 0
