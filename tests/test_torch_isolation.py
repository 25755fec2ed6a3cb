"""The port stands alone: no file of ``madraft_tpu_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package (an AST scan), importing
the port leaves JAX out of ``sys.modules``, and without a CUDA card the
default platform raises instead of running on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "madraft_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "madraft_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, madraft_tpu_torch.__main__, "
            "madraft_tpu_torch.tpusim.engine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'madraft_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_platform_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform runs there")
    from madraft_tpu_torch.tpusim import config, engine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.fuzz(config.SimConfig(), 0, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.replay_cluster(config.SimConfig(), 0, 0, 2)
    from madraft_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fuzz", "--clusters", "2", "--ticks", "2"])


def test_kernel_wrappers_refuse_non_cuda_inputs_only_by_device():
    # a CPU tensor takes the plain version and counts no launch
    from madraft_tpu_torch.kernels import oracle, threefry

    before = (threefry.hash_pairs.launches, threefry.tick_blocks.launches,
              oracle.oracle.launches)
    keys = torch.zeros((2, 2), dtype=torch.int64)
    threefry.hash_pairs(keys, torch.zeros(3, dtype=torch.int64),
                        torch.arange(3, dtype=torch.int64))
    threefry.tick_block(keys, torch.ones(2, dtype=torch.int32), 133, True)
    threefry.tick_blocks(keys, torch.ones(2, dtype=torch.int32), 3, 133, True)
    after = (threefry.hash_pairs.launches, threefry.tick_blocks.launches,
             oracle.oracle.launches)
    assert after == before
