"""What the port's tools share: the device they run on, the card's name
and power limit for every record, the default output path, CUDA-event
timing, and one JSON line out."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Optional

import torch

#: The repository root (the checkout this package sits in).
ROOT = Path(__file__).resolve().parents[2]
#: Where the tools write their records unless ``--out`` says otherwise.
OUT_DIR = ROOT / "build" / "port_tools"


def default_out(name: str) -> str:
    """``build/port_tools/<name>`` under the checkout."""
    return str(OUT_DIR / name)


def resolve_device(cpu: bool) -> torch.device:
    """The CPU when ``--cpu`` is given, else the first card; no card and
    no ``--cpu`` is an error (no fallback)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass --cpu to run on "
                           "the CPU")
    return torch.device("cuda", 0)


def device_kind(device: torch.device) -> str:
    """The budget analyzer's device kind (``lint/budget.py::
    DEVICE_BUDGETS``) for ``device``: "cpu", or "h100-80gb" on an H100 with
    80 GB; any other card is refused, not guessed."""
    if device.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    if "H100" in name and "80GB" in name.replace(" ", ""):
        return "h100-80gb"
    raise ValueError(f"no device budget for {name!r}: the analyzer knows "
                     f"'h100-80gb' and 'cpu'")


def card(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card (the line
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints), None
    on the CPU."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi rc {out.returncode}"


def emit(rec: dict, out: Optional[str]) -> None:
    """Print ``rec`` as one JSON line and append it to ``out`` (if any)."""
    line = json.dumps(rec, default=str)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], object], device: torch.device,
            warmup: int = 3, reps: int = 10) -> float:
    """Median ms of ``fn()`` over ``reps`` calls after ``warmup``: CUDA
    events around each call on the card, the host clock on the CPU."""
    import time
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def seeded_model(config, device: torch.device, seed: int = 0):
    """The port's model with seeded random weights on ``device``."""
    from ..models.raft import init_raft_torch
    return init_raft_torch(config, torch.Generator().manual_seed(seed),
                           device=device)
