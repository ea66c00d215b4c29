"""Warm-start flow seeding for sequential (video) inference, host side.

The port's copy of the JAX package's ``ops/warmstart.py::warm_start_seed``
and of what it runs (``utils/frame_utils.py``: ``forward_interpolate``,
``_splat_average``): frame t's low-resolution flow, projected forward along
itself, seeds frame t+1's recurrence (the official Sintel warm start);
zeros on a cold start.

numpy, with scipy for the fill, as the JAX package keeps it on the host:
the caller holds the previous flow_lr that a stream step returned, the
grid is the 1/8 one (a few thousand pixels), and the splat is a scatter
with conflict averaging that ``np.add.at`` computes in the same order as
the JAX package, so the splat is bitwise the same.  The nearest-hit fill
differs by design: the JAX package takes OpenCV's
``distanceTransformWithLabels`` (``DIST_L2`` with a 3x3 mask, an
approximate distance); the port takes scipy's exact Euclidean
``distance_transform_edt(..., return_indices=True)``, with no OpenCV.
Where OpenCV's pick is an exact nearest hit the two agree, up to ties
(pixels equally near two hits may take either); elsewhere the port's
pick is the nearer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _splat_average(flow: np.ndarray, values: np.ndarray):
    """Scatter-average ``values`` [H, W, C] at each pixel's rounded flow
    target, conflicts averaged; a pixel whose unrounded target leaves the
    frame (``0 < x < w``, ``0 < y < h`` strictly) is dropped, as the
    official warm start's mask drops it (the JAX package's
    ``oob='discard'``).  Returns (averaged [H, W, C] float64, hit mask
    [H, W] bool)."""
    h, w = flow.shape[:2]
    tx = flow[:, :, 0] + np.arange(w)
    ty = flow[:, :, 1] + np.arange(h)[:, None]
    keep = (tx > 0) & (tx < w) & (ty > 0) & (ty < h)
    txi = np.clip(np.rint(tx), 0, w - 1).astype(np.int64)
    tyi = np.clip(np.rint(ty), 0, h - 1).astype(np.int64)
    flat_idx = (tyi * w + txi)[keep]
    acc = np.zeros((h * w, values.shape[-1]), np.float64)
    count = np.zeros(h * w, np.float64)
    np.add.at(acc, flat_idx, values[keep])
    np.add.at(count, flat_idx, 1.0)
    hit = count > 1e-7
    acc[hit] /= count[hit, None]
    return acc.reshape(h, w, -1), hit.reshape(h, w)


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-project a flow field [H, W, 2] along itself: each source
    pixel carries its flow value to its rounded target (conflicts
    averaged, exits dropped), and each pixel no source hit takes the value
    of its nearest hit (exact Euclidean distance).  float32 out; zeros
    when nothing was hit."""
    f = flow.astype(np.float64)
    out, hit = _splat_average(f, f)
    if not hit.any():
        return np.zeros_like(flow, dtype=np.float32)
    empty = ~hit
    if empty.any():
        _, (rows, cols) = ndimage.distance_transform_edt(empty,
                                                         return_indices=True)
        out[empty] = out[rows[empty], cols[empty]]
    return out.astype(np.float32)


def warm_start_seed(prev_flow_lr: Optional[np.ndarray],
                    grid_hw: Tuple[int, int],
                    reset: bool = False) -> np.ndarray:
    """The ``flow_init`` seed of a sequence's next frame, [1, h, w, 2]
    float32: zeros for a cold start (``reset``, no previous flow, or a
    previous flow on another grid), else ``prev_flow_lr`` ([1, h, w, 2] or
    [h, w, 2], the previous step's 1/8-resolution flow) forward-projected
    along itself.  ``grid_hw`` is the next frame's 1/8 grid (h, w)."""
    h, w = grid_hw
    if (reset or prev_flow_lr is None
            or tuple(prev_flow_lr.shape[-3:-1]) != (h, w)):
        return np.zeros((1, h, w, 2), np.float32)
    prev = np.asarray(prev_flow_lr, np.float32)
    if prev.ndim == 3:
        prev = prev[None]
    return forward_interpolate(prev[0])[None]
