"""The PyTorch port stands alone: it imports with ``jax`` and ``raft_tpu``
blocked, its sources import neither (nor ``cv2``), and its entry points
run on CUDA unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "raft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_with_jax_and_raft_tpu_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['raft_tpu'] = None\n"
            "import raft_tpu_torch\n"
            "import raft_tpu_torch.ops.corr_cuda, raft_tpu_torch.ops.gru_cuda\n"
            "import raft_tpu_torch._build\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_raft_tpu(path):
    """Nor OpenCV: the card's machine has no cv2 (the warm start's fill
    is scipy's)."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "raft_tpu", "cv2"), (path, name)


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1)
    if torch.cuda.is_available():
        assert rt.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.make_inference_fn(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.init_raft_torch(cfg)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = np.random.RandomState(0).rand(2, 1, 16, 24, 3).astype(np.float32)
    flow = rt.make_inference_fn(cfg, device="cpu")(model, im[0], im[1])
    assert flow.device.type == "cpu" and tuple(flow.shape) == (1, 16, 24, 2)
    assert bool(torch.isfinite(flow).all())
