"""Optical-flow visualization: the standard Middlebury color wheel
(Baker et al., ICCV 2007), as in reference flow_utils.py:6-121.  The
port's copy of the JAX package's ``utils/flow_viz.py`` (numpy only).

Implemented vectorized over the whole image (single fancy-indexing pass over
the wheel instead of the reference's per-channel Python loop).
"""

from __future__ import annotations

import numpy as np

_SEGMENTS = ((15, 0, 1, False),   # RY: R=255, G ramps up
             (6, 0, 1, True),     # YG: R ramps down, G=255
             (4, 1, 2, False),    # GC: G=255, B ramps up
             (11, 1, 2, True),    # CB: G ramps down, B=255
             (13, 2, 0, False),   # BM: B=255, R ramps up
             (6, 2, 0, True))     # MR: B ramps down, R=255


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB color wheel."""
    ncols = sum(s[0] for s in _SEGMENTS)
    wheel = np.zeros((ncols, 3))
    col = 0
    for n, full_ch, ramp_ch, down in _SEGMENTS:
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, full_ch] = 255
        wheel[col:col + n, ramp_ch] = 255 - ramp if down else ramp
        col += n
    return wheel


def flow_compute_color(u: np.ndarray, v: np.ndarray,
                       convert_to_bgr: bool = False) -> np.ndarray:
    """Color an already max-normalized flow (|uv| <= 1 in-range)."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]

    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi                     # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1) + 1.0
    k0 = np.minimum(np.floor(fk).astype(np.int32), ncols - 2)
    k1 = k0 + 1
    k1[k1 == ncols] = 1
    f = (fk - k0)[..., None]

    # divide-first order matters: it keeps floor(255*col) bit-identical to the
    # canonical Middlebury implementation at exact-255 edges
    col = (1.0 - f) * (wheel[k0] / 255.0) + f * (wheel[k1] / 255.0)   # [H, W, 3]
    in_range = (rad <= 1.0)[..., None]
    col = np.where(in_range, 1.0 - rad[..., None] * (1.0 - col), col * 0.75)

    img = np.floor(255.0 * col).astype(np.uint8)
    return img[..., ::-1] if convert_to_bgr else img


def flow_to_color(flow_uv: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 color image, normalized by max radius."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, flow_uv.shape
    flow = np.asarray(flow_uv, dtype=np.float64)
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad_max = float(np.sqrt(u ** 2 + v ** 2).max(initial=0.0))
    eps = 1e-5
    return flow_compute_color(u / (rad_max + eps), v / (rad_max + eps), convert_to_bgr)
