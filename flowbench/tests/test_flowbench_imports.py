"""Nothing the benchmark runs loads JAX or the JAX package.  A process of
its own imports the harness, every driver and every per-layer reader,
runs one tiny cell of each driver on the CPU (the tests' rehearsal path)
and lists the top-level names of its modules, compared whole:
``raft_tpu_torch`` is the program, ``raft_tpu`` the JAX package.  And the
command itself, with no card, exits non-zero and prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}

SCRIPT = r"""
import glob, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
torch.set_num_threads(2)
from flowbench import harness
from flowbench.tests.conftest import TINY
import flowbench.drivers.serve, flowbench.drivers.train, flowbench.calibrate
for path in sorted(glob.glob("flowbench/metrics/*.py")):
    harness.load_reader(os.path.basename(path)[:-3])
for cell in ("things-serve-closed8", "things-train-chairs"):
    line = harness.run_cell(harness.Run(
        cell=harness.load_cell(cell), seed=3, seconds=0.5, trace=True,
        device="cpu", t_process=time.time(), overrides=TINY))
    assert line["device"]["platform"] == "cpu"
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "raft_tpu_torch" in loaded and "flowbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "flowbench/run.py", "--workload",
         "things-serve-closed8", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_harness_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and flowbench/ (no program)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "flowbench"), tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
