"""madtpu's PyTorch port: the batched lockstep Raft fuzzer on PyTorch and
CUDA, held bit for bit against the JAX package ``madraft_tpu``.

- ``madraft_tpu_torch.tpusim``: config, PRNG, state (wide and packed), the
  batched tick, the metrics plane, coverage, the fuzz/replay/pool/sweep
  engine, the flight recorder and the kv, shard-controller and sharded-kv
  service layers.
- ``madraft_tpu_torch.kernels``: the hand-written CUDA kernels of the hot
  path (threefry draws, safety oracle, packed-carry pack/unpack, latency
  fold, coverage fingerprint / seen-set, the raft tick, the pool harvest,
  the trace row, the kv, ctrler and shardkv service ticks), each with its
  plain PyTorch version.
- ``python -m madraft_tpu_torch fuzz|pool|sweep|replay|explain|kv-fuzz|
  ctrler-fuzz|shardkv-fuzz|stats``: the CLI.

This package imports no JAX and nothing of ``madraft_tpu``.
"""

__version__ = "0.1.0"
