"""What the per-layer readers in ``metrics/`` share.  Each returns None
when its run has nothing for it to read (no device trace, no call of its
kernel), and the harness then leaves the metric out of the line.

``readings`` is a driver's (``Outcome.readings``) with the reduced device
trace under ``trace``: the serving driver's request spans
(``queue_wait_s``, ``device_calls``: per ``execute`` span the batch's real
and padded rows and its seconds), the train driver's steps, and for both
the window, the model FLOPs of one pair or sample and each kernel's
roofline bound per call (per row of a call, for serving)."""

from __future__ import annotations

from typing import Optional

from . import counts
from .trace import kernel_time

# Kernel names in the device trace (csrc/corr_lookup.cu, csrc/sep_conv_gru.cu)
# and how many launches make one call of each.
B1_KERNEL, B1_LAUNCHES = "corr_lookup_kernel", 1
B2_KERNEL, B2_LAUNCHES = "gru_gemm", 4


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def roofline(readings: dict, kernel: str, launches_per_call: int,
             bound_key: str) -> Optional[float]:
    """100 x the bound time of the calls over their device time.  A
    serving bound is per row: each call is priced at the mean padded rows
    of the window's device calls."""
    trace, bound = readings.get("trace"), readings.get(bound_key)
    if trace is None or bound is None:
        return None
    launches, secs = kernel_time(trace, kernel)
    if launches == 0 or secs <= 0:
        return None
    if "device_calls" in readings:
        rows = mean(c[1] for c in readings["device_calls"])
        if rows is None:
            return None
        bound = bound * rows
    return 100.0 * (launches / launches_per_call) * bound / secs


def idle_share(readings: dict) -> Optional[float]:
    trace = readings.get("trace")
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(readings: dict, count_key: str, flops_key: str) -> Optional[float]:
    """100 x the model FLOPs completed per second over the card's f32 peak
    (a share of a GPU's peak: None for a run on any other platform)."""
    if readings.get("platform") != "gpu":
        return None
    if not readings.get(count_key) or readings.get("window_s", 0) <= 0:
        return None
    return (100.0 * readings[count_key] * readings[flops_key]
            / readings["window_s"] / counts.PEAK_F32)
