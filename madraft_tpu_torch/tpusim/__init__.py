"""The batched lockstep Raft simulator in PyTorch (twin of
``madraft_tpu.tpusim``: the raw-raft fuzz/replay/pool/sweep paths, the
kv service layer, ``tpusim.kv``, the shard controller,
``tpusim.ctrler``, and the sharded kv with its schedule, live-controller
and computed-controller modes, ``tpusim.shardkv``)."""

from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.ctrler import (
    CtrlerConfig,
    CtrlerFuzzReport,
    CtrlerState,
    ctrler_fuzz,
    ctrler_replay_cluster,
    make_ctrler_fuzz_fn,
    make_ctrler_sweep_fn,
)
from madraft_tpu_torch.tpusim.engine import (
    FuzzReport,
    fuzz,
    make_fuzz_fn,
    replay_cluster,
    run_pool,
)
from madraft_tpu_torch.tpusim.shardkv import (
    ShardKvConfig,
    ShardKvFuzzReport,
    ShardKvState,
    make_shardkv_fuzz_fn,
    make_shardkv_sweep_fn,
    shardkv_fuzz,
)
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    PackedClusterState,
    init_cluster,
)
from madraft_tpu_torch.tpusim.step import step_cluster

__all__ = [
    "ClusterState", "CtrlerConfig", "CtrlerFuzzReport", "CtrlerState",
    "FuzzReport", "PackedClusterState", "SimConfig", "ctrler_fuzz",
    "ctrler_replay_cluster", "fuzz", "init_cluster", "make_ctrler_fuzz_fn",
    "make_ctrler_sweep_fn", "make_fuzz_fn", "make_shardkv_fuzz_fn",
    "make_shardkv_sweep_fn", "replay_cluster", "run_pool", "ShardKvConfig",
    "ShardKvFuzzReport", "ShardKvState", "shardkv_fuzz", "step_cluster",
]
