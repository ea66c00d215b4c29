"""``python -m raft_tpu_torch.training`` on the CPU (``--cpu``), raft-small
at 32x48 on the synthetic dataset: a run with periodic checkpoints and
retention, a rerun that resumes from the newest checkpoint, and an
external SIGTERM that finishes the step in flight, writes a readable
emergency checkpoint and exits 17.  Each
process is waited for with a timeout and killed if it overruns.  Also:
a checkpoint that cannot load raises, a file stage without its root
raises, and the preemption guard gives back the handlers it replaced."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from raft_tpu_torch.training.__main__ import main
from raft_tpu_torch.training.checkpoint import (checkpoint_readable,
                                                list_checkpoints)
from raft_tpu_torch.training.resilience import PREEMPT_EXIT_CODE, PreemptionGuard

import torch

torch.set_num_threads(2)   # several test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--cpu", "--small", "--iters", "2", "--batch", "2",
        "--train-size", "32", "48", "--log-every", "1"]


def _cmd(out, *extra):
    return [sys.executable, "-m", "raft_tpu_torch.training", *ARGS,
            "--out", str(out), *extra]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(cmd, timeout=120):
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out


def _records(ckpt_dir):
    lines = (ckpt_dir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in lines if ln.strip()]


def test_cli_trains_checkpoints_retains_and_resumes(tmp_path):
    rc, out = _run(_cmd(tmp_path, "--num-steps", "4", "--ckpt-every", "2",
                        "--keep-checkpoints", "1"))
    assert rc == 0, out
    ckpt = tmp_path / "checkpoints"
    assert [s for s, _ in list_checkpoints(ckpt)] == [4], out
    steps = [r["step"] for r in _records(ckpt) if "step" in r]
    assert steps == [0, 1, 2, 3]
    assert np.isfinite([r["loss"] for r in _records(ckpt) if "step" in r]).all()
    rc, out = _run(_cmd(tmp_path, "--num-steps", "6", "--ckpt-every", "2",
                        "--keep-checkpoints", "1"))
    assert rc == 0, out
    assert "resumed from" in out and "at step 4" in out, out
    assert [s for s, _ in list_checkpoints(ckpt)] == [6]
    recs = _records(ckpt)
    assert [r["step"] for r in recs if "step" in r] == [0, 1, 2, 3, 4, 5]
    assert sum(r.get("event") == "manifest" for r in recs) == 2


def test_cli_sigterm_exits_17_with_a_readable_checkpoint(tmp_path):
    proc = subprocess.Popen(_cmd(tmp_path, "--num-steps", "1000",
                                 "--ckpt-every", "1000"),
                            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "[train] step 1 " in line:
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    out = "".join(lines) + rest
    assert proc.returncode == PREEMPT_EXIT_CODE, out
    ckpts = list_checkpoints(tmp_path / "checkpoints")
    assert len(ckpts) == 1 and checkpoint_readable(ckpts[0][1]), out
    assert ckpts[0][0] >= 2 and "PREEMPTED" in out


def test_unported_stages_and_formats_raise(tmp_path):
    """The file stages are ported (they need their root), every checkpoint
    format loads (a missing file raises), a positional training checkpoint
    raises as in the JAX package, and flags out of range exit 2."""
    with pytest.raises(ValueError, match="--data"):
        main([*ARGS, "--dataset", "chairs", "--out", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        main([*ARGS, "--load", str(tmp_path / "weights.pth"),
              "--out", str(tmp_path)])
    old = tmp_path / "old.npz"
    np.savez(old, leaf_0=np.zeros(2))
    with pytest.raises(ValueError, match="positional"):
        main([*ARGS, "--load", str(old), "--out", str(tmp_path)])
    assert main([*ARGS, "--ckpt-every", "0", "--out", str(tmp_path)]) == 2
    assert main([*ARGS, "--workers", "-1", "--out", str(tmp_path)]) == 2


def test_preemption_guard_restores_the_handlers():
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    guard = PreemptionGuard().install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not guard.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.requested and guard.signum == signal.SIGTERM
    finally:
        guard.remove()
    assert {s: signal.getsignal(s) for s in before} == before
