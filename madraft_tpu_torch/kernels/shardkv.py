"""The shardkv service tick on the card: K6-shardkv, a chunk of shardkv
ticks in one launch (``shardkv_chunk``), and K11, one service tick a
launch (``shardkv_tick``), in any of the three config modes (the
schedule, the live controller, the computed controller).

``shardkv_chunk(cfg, kcfg, st, keys, kn, skn, m)`` runs m deployment ticks
(the groups' and, in a controller mode, the controller's raft ticks, then
the service tick) of every deployment: on CPU tensors its plain version
``shardkv_chunk_plain`` (``tpusim.shardkv.shardkv_step``'s eager route, a
tick after another); on CUDA tensors the K6-shardkv build of
``csrc/tick.cu`` (``chunk_variant``: ``-DMADRAFT_K6_SHARDKV``, with
``-DMADRAFT_K6_METRICS`` for ``cfg.metrics``), a deployment a block,
which runs K11's service tick (``csrc/shardkv.cuh``, its phases and its
mode as K11's) after its clusters' raft ticks, or raises.
``shardkv_chunk.launches`` counts its launches, ``metrics_launches`` those
of K6-metrics-shardkv, ``live_launches`` / ``computed_launches`` those in
a controller mode (``live_metrics_launches`` / ``computed_metrics_launches``
K6-metrics-shardkv's there); a shardkv run on the card makes no
``tick_chunk`` and no ``shardkv_tick`` launch. The wrapper checks the
leaves and builds the launch's arguments once a launch and returns the
new ``ShardKvState`` (the schedule mode's placeholder controller passes
through).

K11 (below) is the per-tick design K6-shardkv is held against, with its
own tests and ``chip_smoke.py`` phases: one launch a tick. K11's device
code is K6-shardkv's service tick. K11 replaces the JAX reference's
service tick (B9, and its controller branches, B9-rest),
``madraft_tpu/tpusim/shardkv.py``
``_shardkv_service_tick`` (907-2140), with the 4A rebalance of the
computed controller (``ctrler.py`` ``_rebalance`` 270-343, through
``csrc/ctrler.cuh``'s ``rebalance``), and with the metrics plane
(K11-metrics, the build ``variant`` names) the clerks' latency folds inside
it (shardkv.py 1768-2118 with ``metrics.py`` ``fold_latencies``,
``fold_latencies_by``, ``fold_phases``, ``update_worst`` and
``_shardkv_phase_matrix`` 678-695). Sources: ``csrc/shardkv.cu`` (the
kernel, its launch and the note on its bound and design) and
``csrc/shardkv.cuh`` (the device code), with ``csrc/stage.cuh`` (the
staging K10 shares). The mode is a field of the launch's descriptor that
picks one of the kernel's three instances inside each build, so the builds
stay two.

``shardkv_tick(cfg, kcfg, st, pre_alive, pre_base, s, keys, kn, skn,
ctrl=...)`` is the service share of one deployment tick: ``st`` the
pre-tick shardkv state, ``s`` its group rafts after the raft tick ([B, G,
...]), the pre-tick views the rafts before it, ``ctrl`` in a controller
mode the controller cluster after its raft tick. On CPU tensors, or with
``plain=True`` (the eager route's baseline on the card), it returns the
plain version's result (``tpusim.shardkv._shardkv_service_tick``); on
CUDA tensors it launches K11 or raises. The kernel writes a new state
(the inputs stay as they were; the leaves the tick leaves alone in the
mode are passed through) and hashes the tick's draws itself.
``shardkv_tick.launches`` counts its launches,
``shardkv_tick.metrics_launches`` those of K11-metrics,
``live_launches`` / ``computed_launches`` those in a controller mode,
``live_metrics_launches`` / ``computed_metrics_launches`` K11-metrics'
there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from madraft_tpu_torch import _build
from madraft_tpu_torch.kernels import tick as K6
from madraft_tpu_torch.tpusim import prng
from madraft_tpu_torch.tpusim.config import RAFT_BUGS, SimConfig

I32, BOOL = torch.int32, torch.bool

# csrc/shardkv.cuh limits
MAX_GROUPS = 8
MAX_NODES = 16
MAX_CAP = 256
MAX_SHARDS = 32
MAX_CLIENTS = 32
MAX_CONFIGS = 64

# The service leaves every mode's tick writes (the order of
# csrc/shardkv.cuh Leaf), the controller modes' service leaves, then the
# group raft leaves it writes and the controller cluster's
SERVICE_WRITES = (
    "node_src", "snap_src", "applied", "node_cfg", "phase", "key_hash",
    "key_count", "last_seq", "snap_cfg", "snap_phase", "snap_hash",
    "snap_count", "snap_last_seq", "staged_cfg", "staged_hash",
    "staged_count", "staged_last_seq", "pull_req_t", "pull_req_cfg",
    "pull_rsp_t", "pull_rsp_cfg", "pull_rsp_hash", "pull_rsp_count",
    "pull_rsp_last_seq", "gcq_req_t", "gcq_req_cfg", "gcq_rsp_t",
    "gcq_rsp_cfg", "clerk_seq", "clerk_out", "clerk_shard", "clerk_kind",
    "clerk_cfg", "clerk_wrong", "clerk_acked", "clerk_get_lo",
    "clerk_get_obs", "gets_done", "open_arr", "open_srv", "open_drop",
    "open_stamp", "clerk_sub", "lat_hist", "clerk_app", "clerk_cmt",
    "clerk_apl", "clerk_mig", "client_retries", "phase_hist", "phase_ticks",
    "lat_ticks", "worst_lat", "worst_phases", "worst_key", "worst_client",
    "worst_sub", "key_lat_hist", "client_lat_hist", "w_frontier", "w_cfg",
    "w_phase", "w_hash", "w_count", "w_last_seq", "frz_cfg", "frz_hash",
    "frz_count", "frz_last_seq", "truth_count", "w_clerk_acked",
    "installs_done", "deletes_done", "max_cfg_lag", "violations",
    "first_violation_tick",
)
# the controller modes' service leaves; COMPUTED_ONLY are written in
# computed mode only
CTRL_WRITES = (
    "ctrl_w_frontier", "ctrl_w_stalled", "win_var", "slot_tick", "cmem",
    "ctrl_node_owner", "ctrl_maps", "cfg_owner", "w_src", "cq_req_t",
    "cq_req_node", "cq_req_j", "cq_rsp_t", "cq_rsp_j", "cq_rsp_found",
    "cq_rsp_var",
)
COMPUTED_ONLY = ("slot_tick", "cmem", "ctrl_node_owner", "ctrl_maps",
                 "cfg_owner", "w_src")
RAFT_WRITES = ("log_term", "log_val", "log_len", "durable_len",
               "compact_floor")
CTRL_RAFT_WRITES = ("log_term", "log_val", "log_len", "durable_len")
# every leaf, as (where, name): "st" a service leaf, "s" a group raft
# leaf, "ctrl" a controller cluster leaf
LEAVES = (tuple(("st", f) for f in SERVICE_WRITES + CTRL_WRITES)
          + tuple(("s", f) for f in RAFT_WRITES)
          + tuple(("ctrl", f) for f in CTRL_RAFT_WRITES))
MODES = ("schedule", "live", "computed")
# The stepped group rafts' leaves the kernel reads (csrc/shardkv.cuh
# Read), then come the pre-tick views, the schedule, the keys and the knob
# table
RAFT_READS = ("tick", "term", "role", "alive", "base", "commit",
              "snap_installed_src", "shadow_val", "shadow_base",
              "shadow_len")
# the stepped controller cluster's leaves the kernel reads, after them
CTRL_READS = ("term", "role", "alive", "base", "commit", "shadow_val",
              "shadow_base", "shadow_len")

# The knob table's columns: the shardkv layer's float32 knobs, then its
# int32 ones (bools as 0 / 1) with the raft knob flow_cap last
KNOB_F32 = ("p_op", "p_get", "p_put", "p_retry", "p_cfg_learn", "p_pull",
            "p_ack", "pull_loss", "open_rate", "zipf_a", "p_announce",
            "p_phantom")
KNOB_I32 = ("pull_delay_min", "pull_delay_max", "bug_skip_freeze",
            "bug_drop_dup_table", "bug_serve_frozen", "requery_wrong_group",
            "open_queue_cap", "bug_stale_ctrler_read", "bug_rotate_tiebreak")


# The tick's phases (csrc/shardkv.cuh Phase), in order: the profile build
# (``_build.VARIANTS`` shardkv_profile) times each, and the truth walker's
# own cycles inside the apply phase ("walker")
PHASES = ("stage", "ctrl_walk", "ctrl_apply", "restore", "apply", "oracle",
          "mailbox", "clerks", "append_log", "landed", "write_back")


def variant(metrics: bool) -> str:
    """The build of csrc/shardkv.cu for a run (``_build.VARIANTS``)."""
    return "shardkv_metrics" if metrics else "shardkv"


def mode(kcfg) -> int:
    """kcfg's config mode, the descriptor's (csrc/shardkv.cuh Mode)."""
    return (MODES.index("computed") if kcfg.computed_ctrler
            else MODES.index("live") if kcfg.live_ctrler else 0)


def writes(kcfg) -> tuple:
    """The leaves of LEAVES the tick writes in kcfg's mode (the others
    pass through)."""
    m = MODES[mode(kcfg)]
    return tuple(
        (w, f) for w, f in LEAVES
        if (w == "st" and (f in SERVICE_WRITES or m == "computed"
                           or (m == "live" and f not in COMPUTED_ONLY)))
        or w == "s" or (w == "ctrl" and m != "schedule"))


def knob_table(kn, skn, b: int) -> tuple:
    """The knobs as per-deployment rows: (float32 [B, 12], int32 [B, 10]),
    columns in KNOB_F32 / KNOB_I32 order then flow_cap; 0-d knobs are
    broadcast. A caller running many ticks builds it once."""
    f = torch.stack([getattr(skn, k).to(torch.float32).expand(b)
                     for k in KNOB_F32], dim=1).contiguous()
    cols = [getattr(skn, k).to(I32).expand(b) for k in KNOB_I32]
    cols.append(kn.flow_cap.to(I32).to(f.device).expand(b))
    return f, torch.stack(cols, dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def leaf_shapes(cfg: SimConfig, kcfg) -> dict:
    """name -> (per-deployment shape, dtype) of every leaf the kernel
    writes or reads from the state, as ``init_shardkv_cluster`` makes them
    for (cfg, kcfg)."""
    from madraft_tpu_torch.tpusim.shardkv import init_shardkv_cluster

    st = init_shardkv_cluster(cfg, kcfg, torch.zeros((1, 2),
                                                     dtype=torch.int64))
    out = {("st", f): (tuple(getattr(st, f).shape[1:]), getattr(st, f).dtype)
           for f in SERVICE_WRITES + CTRL_WRITES + ("cfg_tick", "flip_a",
                                                     "flip_b")}
    for w, x, names in (("s", st.rafts, RAFT_WRITES + RAFT_READS),
                        ("ctrl", st.ctrl, CTRL_RAFT_WRITES + CTRL_READS)):
        out.update({(w, f): (tuple(getattr(x, f).shape[1:]),
                             getattr(x, f).dtype) for f in names})
    return out


def _lib(name: str):
    lib = _build.library(name)
    if not getattr(lib, "_typed", False):
        lib.shardkv_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.shardkv_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if (x.device != dev or tuple(x.shape) != shape or x.dtype != dtype
            or not x.is_contiguous()):
        raise ValueError(
            f"shardkv_tick: {name} is {tuple(x.shape)} {x.dtype} on "
            f"{x.device}, expected contiguous {shape} {dtype} on {dev}")


def check_shape(cfg: SimConfig, kcfg) -> None:
    """Refuse a shape past what csrc/shardkv.cuh takes, naming the
    limit (the kernel never hands a shape to the plain version)."""
    g, n, cap = kcfg.n_groups, cfg.n_nodes, cfg.log_cap
    ns, nc, ncfg = kcfg.n_shards, kcfg.n_clients, kcfg.n_configs
    if (not 1 <= g <= MAX_GROUPS or not 1 <= n <= MAX_NODES
            or cap > MAX_CAP or cap & (cap - 1)
            or not 1 <= ns <= MAX_SHARDS or not 1 <= nc <= MAX_CLIENTS
            or not 1 <= ncfg <= MAX_CONFIGS):
        raise ValueError(
            f"shardkv_tick takes n_groups <= {MAX_GROUPS}, n <= "
            f"{MAX_NODES}, a power-of-two cap <= {MAX_CAP}, n_shards <= "
            f"{MAX_SHARDS}, n_clients <= {MAX_CLIENTS} and n_configs <= "
            f"{MAX_CONFIGS}, got n_groups={g} n={n} cap={cap} n_shards={ns} "
            f"n_clients={nc} n_configs={ncfg}")
    if kcfg.computed_ctrler and (ns != 10 or g > 10):
        raise ValueError(
            "shardkv_tick's computed controller runs csrc/ctrler.cuh's "
            f"rebalance: n_shards 10 and n_groups <= 10, got n_shards={ns} "
            f"n_groups={g}")


def _descriptor(cfg: SimConfig, kcfg, st, pre_alive, pre_base, s, keys,
                table, ctrl=None):
    """Check the inputs and allocate the new state: (the launch's
    descriptor, the new ShardKvState). ``ctrl`` is the stepped controller
    cluster in a controller mode (None: ``st.ctrl``, the schedule mode's
    placeholder, which the kernel then never reads)."""
    check_shape(cfg, kcfg)
    if ctrl is None:
        ctrl = st.ctrl
    g, n, cap = kcfg.n_groups, cfg.n_nodes, cfg.log_cap
    dev, b = s.tick.device, s.tick.shape[0]
    if b == 0:
        raise ValueError("shardkv_tick: an empty batch")
    shapes = leaf_shapes(cfg, kcfg)
    src = {"st": st, "s": s, "ctrl": ctrl}
    for w, f in writes(kcfg):
        lane, dtype = shapes[(w, f)]
        _check(f"{w}.{f}", getattr(src[w], f), (b, *lane), dtype, dev)
    for w, names in (("s", RAFT_READS), ("ctrl", CTRL_READS)):
        for f in names:
            if w == "ctrl" and mode(kcfg) == 0:
                continue
            lane, dtype = shapes[(w, f)]
            _check(f"{w}.{f}", getattr(src[w], f), (b, *lane), dtype, dev)
    for f in ("cfg_tick", "cfg_owner", "flip_a", "flip_b"):
        lane, dtype = shapes[("st", f)]
        _check(f, getattr(st, f), (b, *lane), dtype, dev)
    _check("pre_alive", pre_alive, (b, g, n), BOOL, dev)
    _check("pre_base", pre_base, (b, g, n), I32, dev)
    _check("keys", keys, (b, 2), torch.int64, dev)
    kf, ki = table
    _check("knob table (float32)", kf, (b, len(KNOB_F32)), torch.float32, dev)
    _check("knob table (int32)", ki, (b, len(KNOB_I32) + 1), I32, dev)
    # the new state: one allocation, each written leaf a 16-byte aligned
    # view
    ins = {k: getattr(src[k[0]], k[1]) for k in LEAVES}
    offs, nbytes = {}, 0
    for k in writes(kcfg):
        offs[k] = nbytes
        nbytes += -(-ins[k].numel() * ins[k].element_size() // 16) * 16
    buf = torch.empty((max(nbytes, 16),), dtype=torch.uint8, device=dev)
    outs = {k: buf[at:at + ins[k].numel() * ins[k].element_size()]
            .view(ins[k].dtype).view(ins[k].shape) for k, at in offs.items()}
    reads = ([getattr(s, f).data_ptr() for f in RAFT_READS]
             + [getattr(ctrl, f).data_ptr() for f in CTRL_READS]
             + [pre_alive.data_ptr(), pre_base.data_ptr(),
                st.cfg_tick.data_ptr(), st.cfg_owner.data_ptr(),
                st.flip_a.data_ptr(), st.flip_b.data_ptr(), keys.data_ptr(),
                kf.data_ptr(), ki.data_ptr()])
    hb = st.lat_hist.shape[1] if cfg.metrics else 0
    head = [b, g, n, cap, kcfg.n_shards, kcfg.n_clients, kcfg.n_configs,
            kcfg.apply_max, kcfg.walk_max, hb, int(prng.partitionable()),
            int(cfg.metrics), mode(kcfg)]
    leaves = []
    for k, x in ins.items():
        # a leaf the mode leaves alone: count 0, never touched
        y = outs.get(k, x)
        leaves += [x.data_ptr(), y.data_ptr(), x[0].numel() if k in outs
                   else 0, x.element_size()]
    desc = np.asarray(head + reads + leaves, dtype=np.int64)
    new = {w: {f: y for (w2, f), y in outs.items() if w2 == w}
           for w in src}
    out = st._replace(rafts=s._replace(**new["s"]), **new["st"])
    if mode(kcfg):
        out = out._replace(ctrl=ctrl._replace(**new["ctrl"]))
    return desc, out


def _launch(cfg: SimConfig, kcfg, st, pre_alive, pre_base, s, keys, table,
            lib, stream, ctrl=None):
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``shardkv_launch`` (``ctrl`` as ``_descriptor`` takes it). Returns the
    new ShardKvState."""
    desc, out = _descriptor(cfg, kcfg, st, pre_alive, pre_base, s, keys,
                            table, ctrl)
    _build.check(lib.shardkv_launch(desc.ctypes.data, len(desc), stream),
                 "shardkv_launch")
    return out


def grid(cfg: SimConfig, kcfg, st, pre_alive, pre_base, s, keys, table, lib,
         ctrl=None) -> dict:
    """How ``lib`` lays a launch of these inputs out on the card
    (``shardkv_grid``): threads and deployments a block, shared bytes a
    block and the blocks an SM holds."""
    desc, _ = _descriptor(cfg, kcfg, st, pre_alive, pre_base, s, keys, table,
                          ctrl)
    lib.shardkv_grid.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.shardkv_grid.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.check(lib.shardkv_grid(desc.ctypes.data, len(desc), out),
                 "shardkv_grid")
    return dict(zip(("threads_a_block", "deployments_a_block",
                     "shared_bytes", "blocks_an_sm"), out))


def shardkv_tick(cfg: SimConfig, kcfg, st, pre_alive: torch.Tensor,
                 pre_base: torch.Tensor, s, keys, kn, skn, table=None,
                 plain: bool = False, ctrl=None):
    """The service share of one deployment tick: the plain version on the
    CPU (or with ``plain``), kernel K11's build for ``cfg.metrics`` on
    CUDA. ``table`` is ``knob_table(kn, skn, B)`` on the device when the
    caller has it; ``ctrl`` the stepped controller cluster in a controller
    mode."""
    dev = s.tick.device
    if dev.type == "cpu" or plain:
        from madraft_tpu_torch.tpusim.shardkv import _shardkv_service_tick

        return _shardkv_service_tick(cfg, kcfg, st, pre_alive, pre_base, s,
                                     keys, kn, skn, ctrl)
    if dev.type != "cuda":
        raise ValueError(
            f"shardkv_tick: expected CPU or CUDA tensors, got {dev}")
    if table is None:
        table = knob_table(kn.to(dev), skn.to(dev), s.tick.shape[0])
    if (ctrl is None) != (mode(kcfg) == 0):
        raise ValueError("shardkv_tick: a controller mode takes the stepped "
                         "controller cluster (ctrl=), the schedule mode none")
    out = _launch(cfg, kcfg, st, pre_alive, pre_base, s, keys, table,
                  _lib(variant(cfg.metrics)),
                  torch.cuda.current_stream(dev).cuda_stream, ctrl)
    shardkv_tick.launches += 1
    shardkv_tick.metrics_launches += int(cfg.metrics)
    shardkv_tick.live_launches += int(kcfg.live_ctrler)
    shardkv_tick.computed_launches += int(kcfg.computed_ctrler)
    shardkv_tick.live_metrics_launches += int(kcfg.live_ctrler
                                              and cfg.metrics)
    shardkv_tick.computed_metrics_launches += int(kcfg.computed_ctrler
                                                  and cfg.metrics)
    return out


shardkv_tick.launches = 0
shardkv_tick.metrics_launches = 0
shardkv_tick.live_launches = 0
shardkv_tick.computed_launches = 0
shardkv_tick.live_metrics_launches = 0
shardkv_tick.computed_metrics_launches = 0


# ------------------------------------------------------------ K6-shardkv
# (n, cap) of K6-shardkv's template instance (csrc/tick.cuh
# shardkv_instance), for ae_max <= kernels.tick.SHAPE_AE; every other
# shape runs the runtime instance
CHUNK_SHAPES = ((5, 64),)


def chunk_instance(cfg: SimConfig) -> int:
    """The K6-shardkv instance that runs cfg's clusters: 1 + its index in
    CHUNK_SHAPES, or 0 for the runtime one."""
    shape = (cfg.n_nodes, cfg.log_cap)
    if cfg.ae_max > K6.SHAPE_AE or shape not in CHUNK_SHAPES:
        return 0
    return 1 + CHUNK_SHAPES.index(shape)


def chunk_variant(metrics: bool) -> str:
    """The K6-shardkv build of csrc/tick.cu for a run (``_build.VARIANTS``)."""
    return "tick_metrics_shardkv" if metrics else "tick_shardkv"


def chunk_lib(name: str):
    """The loaded K6-shardkv library ``name`` (built first if needed),
    its entries typed."""
    return typed_chunk_lib(_build.library(name))


def typed_chunk_lib(lib):
    """``lib`` (a K6-shardkv build, on the card or the host's) with
    ``shardkv_chunk_launch`` and ``shardkv_chunk_grid`` typed."""
    if not getattr(lib, "_typed_chunk", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, p, p, i, p, i, i, i, i, i, i, i, i, i, p, i]
        lib.shardkv_chunk_launch.argtypes = head + [p, p, p]
        lib.shardkv_chunk_launch.restype = i
        if hasattr(lib, "shardkv_chunk_grid"):
            lib.shardkv_chunk_grid.argtypes = head + [p]
            lib.shardkv_chunk_grid.restype = i
        lib._typed_chunk = True
    return lib


def chunk_tables(cfg: SimConfig, kcfg, kn, skn, b: int) -> tuple:
    """The knob tables of a K6-shardkv launch of b deployments on kn's
    device: (the group clusters' K6 table [B x G], the controller
    clusters' [B], K11's). A caller running many chunks builds them once."""
    from madraft_tpu_torch.tpusim.shardkv import _group_knobs

    g = kcfg.n_groups
    return (K6.knob_table(_group_knobs(kn, g), b * g), K6.knob_table(kn, b),
            knob_table(kn, skn, b))


def _chunk_args(cfg: SimConfig, kcfg, st, keys, m: int, tables) -> tuple:
    """Check the inputs and allocate the new state of a K6-shardkv launch:
    (the arguments of ``shardkv_chunk_launch`` before the scratch, the new
    ShardKvState, what must stay alive until the launch). The service
    leaves the mode writes come out in a fresh allocation (the kernel
    copies them there first, then ticks them in place); the clusters'
    raft leaves in K6's (``kernels.tick.cluster_args``), where K11's
    descriptor points both their input and output."""
    from madraft_tpu_torch.tpusim.shardkv import (
        _flat,
        _unflat,
        ctrl_keys,
        group_keys,
    )

    check_shape(cfg, kcfg)
    g, n, cap = kcfg.n_groups, cfg.n_nodes, cfg.log_cap
    dev, b = keys.device, keys.shape[0]
    if b == 0:
        raise ValueError("shardkv_chunk: an empty batch")
    gtable, ctable, (kf, ki) = tables
    shapes = leaf_shapes(cfg, kcfg)
    gkeys = group_keys(keys, g).reshape(-1, 2)
    gnew, ga, gin = K6.cluster_args(cfg, _flat(st.rafts), gkeys, m, gtable)
    rafts = _unflat(gnew, b)
    ctrl_on = mode(kcfg) != 0
    ckeys = ctrl_keys(keys)
    ctrl, ca, cin = (K6.cluster_args(cfg, st.ctrl, ckeys, m, ctable)
                     if ctrl_on else (st.ctrl, None, None))
    written = writes(kcfg)
    for w, f in written:
        if w == "st":
            lane, dtype = shapes[(w, f)]
            _check(f"st.{f}", getattr(st, f), (b, *lane), dtype, dev)
    for f in ("cfg_tick", "cfg_owner", "flip_a", "flip_b"):
        lane, dtype = shapes[("st", f)]
        _check(f, getattr(st, f), (b, *lane), dtype, dev)
    _check("keys", keys, (b, 2), torch.int64, dev)
    _check("knob table (float32)", kf, (b, len(KNOB_F32)), torch.float32, dev)
    _check("knob table (int32)", ki, (b, len(KNOB_I32) + 1), I32, dev)
    # the service leaves' new rows: one allocation, each a 16-byte aligned
    # view
    svc = [f for w, f in written if w == "st"]
    offs, nbytes = {}, 0
    for f in svc:
        x = getattr(st, f)
        offs[f] = nbytes
        nbytes += -(-x.numel() * x.element_size() // 16) * 16
    buf = torch.empty((max(nbytes, 16),), dtype=torch.uint8, device=dev)
    outs = {}
    for f, at in offs.items():
        x = getattr(st, f)
        outs[f] = (buf[at:at + x.numel() * x.element_size()].view(x.dtype)
                   .view(x.shape))
    src = {"st": st, "s": rafts, "ctrl": ctrl}
    reads = ([getattr(rafts, f).data_ptr() for f in RAFT_READS]
             + [getattr(ctrl, f).data_ptr() if ctrl_on else 0
                for f in CTRL_READS]
             + [0, 0,  # the pre-tick views: the kernel's scratch rows
                st.cfg_tick.data_ptr(), st.cfg_owner.data_ptr(),
                st.flip_a.data_ptr(), st.flip_b.data_ptr(), keys.data_ptr(),
                kf.data_ptr(), ki.data_ptr()])
    hb = st.lat_hist.shape[1] if cfg.metrics else 0
    head = [b, g, n, cap, kcfg.n_shards, kcfg.n_clients, kcfg.n_configs,
            kcfg.apply_max, kcfg.walk_max, hb, int(prng.partitionable()),
            int(cfg.metrics), mode(kcfg)]
    leaves = []
    for k in LEAVES:
        x = getattr(src[k[0]], k[1])
        if k not in written:  # the mode leaves it alone: count 0
            leaves += [x.data_ptr(), x.data_ptr(), 0, x.element_size()]
            continue
        y = outs[k[1]] if k[0] == "st" else x
        leaves += [x.data_ptr(), y.data_ptr(), x[0].numel(), x.element_size()]
    desc = np.asarray(head + reads + leaves, dtype=np.int64)
    kinds, draws = K6.leaf_tables(n)
    args = (ga.ctypes.data, None if ca is None else ca.ctypes.data,
            kinds.ctypes.data, len(kinds), draws.ctypes.data, len(draws), b,
            g, n, cap, cfg.ae_max, m, RAFT_BUGS.index(cfg.bug),
            int(prng.partitionable()), desc.ctypes.data, len(desc))
    new = st._replace(rafts=rafts, ctrl=ctrl, **outs)
    return args, new, (ga, ca, kinds, draws, desc, gin, cin)


def _chunk_launch(cfg: SimConfig, kcfg, st, keys, m: int, tables, lib,
                  stream):
    """Check the inputs, allocate the new state and launch ``lib``'s
    ``shardkv_chunk_launch`` (its scratch sized by a first call that
    launches nothing). Returns the new ShardKvState."""
    args, new, keep = _chunk_args(cfg, kcfg, st, keys, m, tables)
    nbytes = ctypes.c_int64(0)
    _build.check(lib.shardkv_chunk_launch(*args, None, ctypes.byref(nbytes),
                                          stream), "shardkv_chunk_launch")
    scratch = torch.empty((nbytes.value,), dtype=torch.uint8,
                          device=keys.device)
    _build.check(lib.shardkv_chunk_launch(*args, scratch.data_ptr(),
                                          ctypes.byref(nbytes), stream),
                 "shardkv_chunk_launch")
    del keep
    return new


def chunk_grid(cfg: SimConfig, kcfg, st, keys, m: int, tables, lib) -> dict:
    """How ``lib`` lays a K6-shardkv launch of these inputs out on the card
    (``shardkv_chunk_grid``): threads and deployments a block, dynamic
    shared bytes a block, the blocks an SM holds and whether the clusters'
    blocks sit in shared memory."""
    args, _, keep = _chunk_args(cfg, kcfg, st, keys, m, tables)
    out = (ctypes.c_int * 5)()
    _build.check(lib.shardkv_chunk_grid(*args, out), "shardkv_chunk_grid")
    del keep
    return dict(zip(("threads_a_block", "deployments_a_block",
                     "shared_bytes", "blocks_an_sm", "blocks_in_shared"),
                    out))


def shardkv_chunk_plain(cfg: SimConfig, kcfg, st, keys, kn, skn, m: int):
    """K6-shardkv's plain version: m ticks of
    ``tpusim.shardkv.shardkv_step``'s eager route (the groups' and the
    controller's ``step_cluster``, then K11's plain version)."""
    from madraft_tpu_torch.tpusim.shardkv import shardkv_step

    for _ in range(m):
        st = shardkv_step(cfg, kcfg, st, keys, kn, skn, tick="eager")
    return st


def shardkv_chunk(cfg: SimConfig, kcfg, st, keys, kn, skn, m: int,
                  tables=None):
    """m deployment ticks of every deployment: the plain version on the
    CPU, K6-shardkv's build for ``cfg.metrics`` on CUDA (one launch).
    ``tables`` is ``chunk_tables(cfg, kcfg, kn, skn, B)`` on the device
    when the caller has it."""
    dev = st.rafts.tick.device
    if dev.type == "cpu":
        return shardkv_chunk_plain(cfg, kcfg, st, keys, kn, skn, m)
    if dev.type != "cuda":
        raise ValueError(
            f"shardkv_chunk: expected CPU or CUDA tensors, got {dev}")
    if m < 1:
        raise ValueError(f"shardkv_chunk: m must be >= 1, got {m}")
    if tables is None:
        tables = chunk_tables(cfg, kcfg, kn.to(dev), skn.to(dev),
                              keys.shape[0])
    out = _chunk_launch(cfg, kcfg, st, keys, m, tables,
                        chunk_lib(chunk_variant(cfg.metrics)),
                        torch.cuda.current_stream(dev).cuda_stream)
    shardkv_chunk.launches += 1
    shardkv_chunk.metrics_launches += int(cfg.metrics)
    shardkv_chunk.live_launches += int(kcfg.live_ctrler)
    shardkv_chunk.computed_launches += int(kcfg.computed_ctrler)
    shardkv_chunk.live_metrics_launches += int(kcfg.live_ctrler
                                               and cfg.metrics)
    shardkv_chunk.computed_metrics_launches += int(kcfg.computed_ctrler
                                                   and cfg.metrics)
    return out


shardkv_chunk.launches = 0
shardkv_chunk.metrics_launches = 0
shardkv_chunk.live_launches = 0
shardkv_chunk.computed_launches = 0
shardkv_chunk.live_metrics_launches = 0
shardkv_chunk.computed_metrics_launches = 0
