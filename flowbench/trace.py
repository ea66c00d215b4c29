"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over the whole window, reduced to what the per-layer readers take.

The profiler's session opens before the window's traffic starts and
closes after its last request or step has returned, so no CUDA graph
replay is in flight when CUPTI switches its collection on or off.  The
reduction keeps, for the device: every kernel, copy and set's interval;
their union (the busy time); the span from the first to the last (the
traced window); device time and count by name; and the idle gaps, each
labelled by the host operation that overlaps it most (the host's CPU
events, on any thread), or ``host (no op recorded)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TOP = 10


class DeviceTrace:
    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> Optional[dict]:
        """Close the session and reduce it; None when no device operation
        was recorded."""
        import torch
        self._prof.stop()
        device, host = [], []
        for e in self._prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    # (an annotation is a host range's span on the device)
                    device.append((tr.start, tr.end, e.name))
            elif tr.end > tr.start:
                host.append((tr.start, tr.end, e.name))
        self._prof = None
        return reduce_trace(device, host)


def _union(intervals: List[Tuple[float, float, str]]):
    merged: List[List[float]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(gap: Tuple[float, float], host) -> str:
    best, best_overlap = "host (no op recorded)", 0.0
    for s, e, name in host:
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > best_overlap:
            best, best_overlap = name, ov
    return best


def reduce_trace(device, host) -> Optional[dict]:
    """``device``/``host``: (start us, end us, name) intervals."""
    if not device:
        return None
    merged = _union(device)
    busy_us = sum(e - s for s, e in merged)
    window_us = merged[-1][1] - merged[0][0]
    by_name: Dict[str, List[float]] = {}
    for s, e, name in device:
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) * 1e-6
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:TOP]
    host = sorted(host)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "kernels": {k: (int(v[0]), v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k[:160], v[1]] for k, v in top_ops],
            "idle_gaps": [[_label(g, host)[:160], (g[1] - g[0]) * 1e-6]
                          for g in gaps],
        },
    }


def kernel_time(trace: dict, part: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds ``part``."""
    n, t = 0, 0.0
    for name, (count, secs) in trace["kernels"].items():
        if part in name:
            n += count
            t += secs
    return n, t
