"""The batched lockstep Raft simulator in PyTorch (twin of
``madraft_tpu.tpusim``: the raw-raft fuzz/replay/pool/sweep paths and the
kv service layer, ``tpusim.kv``)."""

from madraft_tpu_torch.tpusim.config import SimConfig
from madraft_tpu_torch.tpusim.engine import (
    FuzzReport,
    fuzz,
    make_fuzz_fn,
    replay_cluster,
    run_pool,
)
from madraft_tpu_torch.tpusim.state import (
    ClusterState,
    PackedClusterState,
    init_cluster,
)
from madraft_tpu_torch.tpusim.step import step_cluster

__all__ = [
    "ClusterState", "FuzzReport", "PackedClusterState", "SimConfig", "fuzz",
    "init_cluster", "make_fuzz_fn", "replay_cluster", "run_pool",
    "step_cluster",
]
