"""Shared by the port tools' CPU smoke tests: run ``python -m
raft_tpu_torch.tools.<name> --cpu ...`` in a subprocess from the repo
root, with two threads for torch and a time limit of its own."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_tool(name, *argv, timeout=120):
    """(returncode, stdout, stderr) of the tool run on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", f"raft_tpu_torch.tools.{name}", "--cpu",
         *map(str, argv)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def records(path):
    """The JSON lines a tool appended to ``path``."""
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()
            if ln.strip()]
