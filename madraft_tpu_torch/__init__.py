"""madtpu's PyTorch port: the batched lockstep Raft fuzzer on PyTorch and
CUDA, held bit for bit against the JAX package ``madraft_tpu``.

- ``madraft_tpu_torch.tpusim``: config, PRNG, state (wide and packed), the
  batched tick, and the fuzz/replay/pool engine.
- ``madraft_tpu_torch.kernels``: the hand-written CUDA kernels of the hot
  path (threefry draws, safety oracle, packed-carry pack/unpack), each with
  its plain PyTorch version.
- ``python -m madraft_tpu_torch fuzz|pool|replay``: the CLI.

This package imports no JAX and nothing of ``madraft_tpu``.
"""

__version__ = "0.1.0"
