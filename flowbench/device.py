"""The device: its description in the result line, the TF32 switches,
the card's power limit, and the no-result rule for a missing card."""

from __future__ import annotations

import contextlib
import subprocess
import sys
from typing import Optional

import torch

from . import counts


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS's and cuDNN's TF32 switches for the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def describe(device: str, trace: Optional[dict]) -> dict:
    """The result line's ``device``: the platform, the card's name, the
    cards used, the peak of the memory the process's allocator held
    (reserved: the weights, the graphs' pools, the activations) since the
    window opened and, traced, the busy seconds and the traced window."""
    if device == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_reserved())}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def reset_peak(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def cudnn_mode(device: str, mode: str) -> None:
    """cuDNN's algorithm choice for the process: 'benchmark' times the
    candidates of each new shape (set before any convolution runs)."""
    if device == "cuda":
        torch.backends.cudnn.benchmark = mode == "benchmark"


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def print_peaks(device: str) -> None:
    """The data-sheet figures the shares derive from, and the card's
    power limit (a card set below 700 W runs slower under load)."""
    limit = "not read"
    if device == "cuda":
        try:
            limit = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip().replace("\n", "; ") or "not read"
        except (OSError, subprocess.SubprocessError):
            pass
    d = counts.DATASHEET
    print(f"flowbench peaks: data sheet (H100 SXM, dense, 700 W) TF32 "
          f"{d['tf32_tflops']:g} TFLOP/s, BF16 {d['bf16_tflops']:g}, FP32 "
          f"{d['fp32_tflops']:g}, HBM {d['hbm_tb_s']:g} TB/s; derived f32 x "
          f"f32 (3xTF32) {counts.PEAK_F32 / 1e12:g} TFLOP/s, the peak of "
          f"mfu and of the products in each roofline; card: {limit}",
          file=sys.stderr, flush=True)
