"""The PyTorch port stands alone: it imports with ``jax``, ``raft_tpu`` and
``cv2`` blocked, its sources import none of them and load nothing under
``native/`` (the JAX package's I/O library), and its entry points run on
CUDA unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt

torch.set_num_threads(2)   # several test workers share the host's cores

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "raft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
TOOLS = ("serve_bench", "tlm", "bench_train", "profile_breakdown",
         "envelope_check", "warmstart_bench", "train_chaos",
         "make_qualitative", "raftlint")
BLOCK = ("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['raft_tpu'] = None\n"
         "sys.modules['cv2'] = None\n"
         "sys.modules['bench'] = None\n")


def test_imports_with_jax_and_raft_tpu_blocked():
    code = (BLOCK +
            "import raft_tpu_torch\n"
            "import raft_tpu_torch.ops.corr_cuda, raft_tpu_torch.ops.gru_cuda\n"
            "import raft_tpu_torch._build\n"
            "import raft_tpu_torch.serving, raft_tpu_torch.serving.__main__\n"
            "import raft_tpu_torch.telemetry, raft_tpu_torch.lint\n"
            "import raft_tpu_torch.lint.budget, raft_tpu_torch.lint.concurrency\n"
            "import raft_tpu_torch.lint.contracts, raft_tpu_torch.lint.engine\n"
            "import raft_tpu_torch.lint.rules\n"
            "import raft_tpu_torch.training, raft_tpu_torch.training.__main__\n"
            "import raft_tpu_torch.training.loop, raft_tpu_torch.training.faults\n"
            "import raft_tpu_torch.data.synthetic, raft_tpu_torch.data.datasets\n"
            "import raft_tpu_torch.imageio, raft_tpu_torch.data.augment\n"
            "import raft_tpu_torch.data.augment_device\n"
            "import raft_tpu_torch.data.mp_loader, raft_tpu_torch.data.fabricate\n"
            "import raft_tpu_torch.data.loader_bench\n"
            "import raft_tpu_torch.utils.flow_io, raft_tpu_torch.utils.flow_viz\n"
            "import raft_tpu_torch.utils.frame_utils\n"
            "import raft_tpu_torch.training.evaluate\n"
            "import raft_tpu_torch.cli, raft_tpu_torch.convert\n"
            "import raft_tpu_torch.utils.profiling\n"
            "import raft_tpu_torch.telemetry.watchdogs\n"
            "import raft_tpu_torch.parallel, raft_tpu_torch.parallel.launch\n"
            "import raft_tpu_torch.parallel.distributed, raft_tpu_torch.ops.spmd\n"
            "import raft_tpu_torch.serving.aot_cache, raft_tpu_torch.fleet\n"
            "import raft_tpu_torch.fleet.manager, raft_tpu_torch.fleet.router\n"
            "import raft_tpu_torch.fleet.controller, raft_tpu_torch.fleet.launch\n"
            + "".join(f"import raft_tpu_torch.tools.{m}\n" for m in TOOLS) +
            "assert raft_tpu_torch.cli.build_parser().parse_args([]).mode == 'test'\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_codec_and_classical_flow_run_with_jax_raft_tpu_and_cv2_blocked():
    """The JPEG codec and calc_flow (DIS + guided filter) are the port's
    own: they build and run with jax, raft_tpu and cv2 blocked, and their
    C++ sources include no OpenCV and no libjpeg header."""
    code = (BLOCK +
            "import numpy as np\n"
            "from raft_tpu_torch import imageio\n"
            "from raft_tpu_torch.utils import frame_utils\n"
            "import raft_tpu_torch.data.augment as A\n"
            "rng = np.random.RandomState(0)\n"
            "im = rng.randint(0, 256, (40, 48, 3), np.uint8)\n"
            "back = imageio.decode_image(imageio.encode_jpeg(im, 90))\n"
            "assert back.shape == im.shape and back.dtype == np.uint8\n"
            "f = frame_utils.calc_flow(im, np.roll(im, 2, axis=1))\n"
            "assert f.shape == (40, 48, 2) and np.isfinite(f).all()\n"
            "A._apply_jpeg(im.astype(np.float32), 80)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'raft_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for src in ("jpeg.cpp", "dis_flow.cpp"):
        text = (REPO / "raft_tpu_torch" / "csrc" / src).read_text()
        includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
        assert includes and not any(
            k in ln for ln in includes for k in ("opencv", "jpeglib", "turbojpeg")), src


def test_every_tool_runs_help_with_jax_and_raft_tpu_blocked():
    """``python -m raft_tpu_torch.tools.<name> --help`` for every tool, with
    jax, raft_tpu, cv2 and the root ``bench.py`` blocked."""
    code = (BLOCK + "import runpy\n"
            "for name in sys.argv[1:]:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('raft_tpu_torch.tools.' + name,\n"
            "                         run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code in (0, None), (name, e.code)\n"
            "    else:\n"
            "        raise AssertionError(name + ' --help did not exit')\n"
            "    print('HELP-OK', name)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, *TOOLS], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("HELP-OK") == len(TOOLS), proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_raft_tpu(path):
    """Nor OpenCV: the card's machine has no cv2 (the warm start's fill
    is scipy's); nor the root ``bench.py``, which is the JAX package's."""
    tree = ast.parse(path.read_text())
    # a function returning the format name 'native' (convert.detect_format,
    # as the JAX package names its params npz) names no path
    returned = {id(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Constant)}
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "raft_tpu", "cv2",
                               "native", "bench"), (path, name)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "libraftio" not in node.value, (path, node.value)
            assert (node.value != "native" or id(node) in returned) and \
                not node.value.startswith(
                ("native/", "native\\")), (path, node.value)


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1)
    if torch.cuda.is_available():
        assert rt.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.make_inference_fn(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.init_raft_torch(cfg)
        from raft_tpu_torch.training.__main__ import main as train_main
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main(["--small", "--iters", "1", "--num-steps", "1"])
        from raft_tpu_torch.cli import main as cli_main
        for mode in ("test", "flops", "export", "val", "serve"):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli_main(["-m", mode, "--small", "--iters", "1",
                          "--run-log", "none"])
    model = rt.init_raft_torch(cfg, device="cpu")
    im = np.random.RandomState(0).rand(2, 1, 16, 24, 3).astype(np.float32)
    flow = rt.make_inference_fn(cfg, device="cpu")(model, im[0], im[1])
    assert flow.device.type == "cpu" and tuple(flow.shape) == (1, 16, 24, 2)
    assert bool(torch.isfinite(flow).all())
