"""Host-side classical-flow and image tools, without OpenCV.

The port's copy of the JAX package's ``utils/frame_utils.py`` (the
reference's side utilities, flow_utils.py:123-274): contrast and
unsharp-mask augmentation, static-region masking, rectangular erosion and
forward-to-backward flow reversal by splatting; ``forward_interpolate`` is
the warm start's (``ops/warmstart.py``).  Where the JAX package calls
OpenCV the port computes the same in numpy and scipy:

* :func:`aug_img` blurs with a Gaussian of OpenCV's kernel size for a
  uint8 image (``round(6 sigma + 1) | 1`` taps), mirrored at the border
  without repeating the edge (OpenCV's default ``BORDER_REFLECT_101``),
  rounds the blur to uint8 as OpenCV does, then weighs and saturates as
  ``cv2.addWeighted``.  OpenCV's uint8 blur runs in fixed point, so a
  pixel may differ from it by a level of 255;
* :func:`erode_mask` is ``scipy.ndimage.grey_erosion`` over an r x r
  rectangle anchored as OpenCV anchors it (``r // 2``); past the border
  the nearest pixel repeats, which for a minimum is OpenCV's border (it
  ignores pixels outside the image).

``calc_flow`` is OpenCV's DIS optical flow and has no equivalent here: it
raises naming ROADMAP item 8b.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy import ndimage

from ..ops.warmstart import forward_interpolate

__all__ = ["aug_img", "calc_flow", "set_static_flow", "erode_mask",
           "ReversedFlow", "reverse_flow", "forward_interpolate"]


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` for sigma > 0 (float64)."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian of [H, W(, C)] along x then y, float64 out, the
    border mirrored without repeating the edge (``BORDER_REFLECT_101``)."""
    k = _gaussian_kernel(ksize, sigma)
    r = ksize // 2
    out = img.astype(np.float64)
    for axis in (1, 0):
        width = [(0, 0)] * out.ndim
        width[axis] = (r, r)
        padded = np.pad(out, width, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for i, w in enumerate(k):
            acc += w * np.take(padded, np.arange(i, i + n), axis=axis)
        out = acc
    return out


def aug_img(im: np.ndarray, contrast: float = 1.5, bias: float = 0.0,
            usm_sigma: float = 5.0) -> np.ndarray:
    """Contrast stretch + unsharp-mask sharpening (reference
    flow_utils.py:123-135): ``1.5 im - 0.5 blur(im)``, saturated to uint8."""
    im = np.uint8(np.clip(contrast * im + bias, 0, 255))
    ksize = int(np.rint(usm_sigma * 6 + 1)) | 1
    blur = np.clip(np.rint(gaussian_blur(im, ksize, usm_sigma)), 0, 255)
    out = 1.5 * im.astype(np.float64) - 0.5 * blur
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def calc_flow(im0: np.ndarray, im1: np.ndarray,
              use_yuv: bool = False) -> np.ndarray:
    """The JAX package's classical baseline is OpenCV's DIS optical flow
    with a guided filter; the port has no OpenCV."""
    raise NotImplementedError(
        "calc_flow is OpenCV's DIS optical flow, which the port does not "
        "have: ROADMAP item 8b")


def set_static_flow(flow01: np.ndarray, im0: np.ndarray, bg: np.ndarray,
                    thresh: float = 5.0) -> np.ndarray:
    """Zero flow where im0 matches the static background plate
    (reference flow_utils.py:155-159)."""
    static = np.prod(np.abs(bg.astype(np.float64) - im0) < thresh,
                     axis=-1, keepdims=True)
    return np.where(static, 0.0, flow01)


def erode_mask(mask: np.ndarray, r: int = 5) -> np.ndarray:
    """Rectangular r x r erosion of [H, W] or [H, W, C] (reference
    flow_utils.py:161-163), each channel alone."""
    size = (r, r) + (1,) * (mask.ndim - 2)
    return ndimage.grey_erosion(mask, size=size, mode="nearest")


class ReversedFlow(NamedTuple):
    flow10: np.ndarray          # [H, W, 2] backward flow
    empty: np.ndarray           # uint8 [H, W] pixels with no projection
    conflict: np.ndarray        # uint8 [H, W] pixels hit more than once
    static_mask: np.ndarray     # [H, W, 1] static-region mask (or zeros)
    empty_before_fill: np.ndarray


def _nearest_fill(values: np.ndarray, empty: np.ndarray) -> np.ndarray:
    """For each empty pixel, average the nearest non-empty value looking
    up / down / left / right (the reference's fiil_ind semantics,
    flow_utils.py:229-262), by directional index propagation; the four
    scans read only the ORIGINAL non-empty pixels."""
    h, w = empty.shape
    valid = ~empty.astype(bool)

    def propagate(along_cols: bool, reverse: bool):
        v = valid.T if along_cols else valid
        n = v.shape[1]
        idx = np.broadcast_to(np.arange(n), v.shape)
        if reverse:
            v = v[:, ::-1]
        filled = np.maximum.accumulate(np.where(v, idx, -1), axis=1)
        if reverse:
            filled = np.where(filled[:, ::-1] >= 0,
                              (n - 1) - filled[:, ::-1], -1)
        has = filled >= 0
        if along_cols:
            return filled.T, has.T
        return filled, has

    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    acc = np.zeros(values.shape, np.float64)
    cnt = np.zeros((h, w), np.float64)
    for along_cols in (False, True):
        for reverse in (False, True):
            filled, has = propagate(along_cols, reverse)
            if along_cols:
                src = values[np.clip(filled, 0, h - 1), cols]
            else:
                src = values[rows, np.clip(filled, 0, w - 1)]
            acc += np.where(has[..., None], src, 0.0)
            cnt += has
    out = values.copy()
    fill = empty.astype(bool)
    out[fill] = (acc / np.maximum(cnt, 1.0)[..., None])[fill]
    return out


def reverse_flow(flow01: np.ndarray, bg: Optional[np.ndarray] = None,
                 im0: Optional[np.ndarray] = None, time_step: float = 1.0,
                 static_thresh: float = 10.0) -> ReversedFlow:
    """Forward flow -> backward flow: each source pixel goes to its
    rounded target (pinned to the border), -flow accumulates with
    conflicts averaged, holes fill with the nearest-neighbour average
    (reference flow_utils.py:166-274, FLOW_PROJECTION_ROUND=True).
    Static pixels (im0 == bg) are skipped."""
    h, w = flow01.shape[:2]
    flow = flow01.astype(np.float64) * time_step
    if bg is not None and im0 is not None:
        diff = np.abs(bg.astype(np.float64) - im0)
        static_mask = np.prod(diff < static_thresh, axis=-1, keepdims=True)
        skip = static_mask[:, :, 0].astype(bool)
    else:
        static_mask = np.zeros((h, w, 1))
        skip = np.zeros((h, w), bool)
    tx = flow[:, :, 0] + np.arange(w)
    ty = flow[:, :, 1] + np.arange(h)[:, None]
    txi = np.clip(np.rint(tx), 0, w - 1).astype(np.int64)
    tyi = np.clip(np.rint(ty), 0, h - 1).astype(np.int64)
    flat_idx = (tyi * w + txi)[~skip]
    acc = np.zeros((h * w, 2), np.float64)
    count = np.zeros(h * w, np.float64)
    np.add.at(acc, flat_idx, -flow[~skip])
    np.add.at(count, flat_idx, 1.0)
    hit = count > 1e-7
    acc[hit] /= count[hit, None]
    empty = np.uint8(~hit.reshape(h, w))
    empty_before_fill = empty.copy()
    flow10 = _nearest_fill(acc.reshape(h, w, 2), empty)
    return ReversedFlow(flow10.astype(np.float32), empty,
                        np.uint8(count.reshape(h, w) > 1), static_mask,
                        empty_before_fill)
