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

* :func:`calc_flow`, the classical baseline, is OpenCV's DIS optical flow
  at ``PRESET_MEDIUM`` followed by a guided filter.  The DIS is the port's
  own C++ (``csrc/dis_flow.cpp``, built by ``_build.py`` with the host
  compiler), which replays OpenCV's float arithmetic stage by stage; the
  grey frames are ``cv2.cvtColor``'s fixed point, bitwise
  (``COLOR_BGR2GRAY``, or the Y of ``COLOR_BGR2YUV``).  The guided filter
  (:func:`_guided_filter`) is He et al.'s colour-guide filter in numpy,
  with the conventions its docstring states.  Where OpenCV lacks
  ``ximgproc`` the JAX function returns the raw DIS flow; the port always
  filters, as the reference's code intends.
"""

from __future__ import annotations

import ctypes
import threading
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


# DIS at OpenCV's PRESET_MEDIUM: finest scale 1, the coarsest from the
# frame size, 8x8 patches at stride 3, 25 gradient-descent iterations, 5
# variational-refinement iterations (alpha 20, gamma 10, delta 5, epsilon
# 0.01), mean normalisation and spatial propagation on
_DIS_MEDIUM = dict(finest_scale=1, coarsest_scale=-1, patch_size=8,
                   patch_stride=3, grad_descent_iter=25, var_iter=5,
                   mean_normalization=True, spatial_propagation=True,
                   alpha=20.0, gamma=10.0, delta=5.0, epsilon=0.01)
_ERRLEN = 256
_dis_lib: Optional[ctypes.CDLL] = None
_dis_lock = threading.Lock()


def _dis() -> ctypes.CDLL:
    """The DIS library, built and loaded at the first call."""
    global _dis_lib
    with _dis_lock:
        if _dis_lib is None:
            from .. import _build
            lib = _build.load("dis_flow.cpp")
            p, i32 = ctypes.c_void_p, ctypes.c_int32
            lib.rt_dis_flow.argtypes = [p, p, i32, i32, p, p, p,
                                        ctypes.c_char_p, ctypes.c_int]
            lib.rt_dis_flow.restype = ctypes.c_int
            lib.rt_variational_refinement.argtypes = [
                p, p, i32, i32, p, p, p, p, ctypes.c_char_p, ctypes.c_int]
            lib.rt_variational_refinement.restype = ctypes.c_int
            _dis_lib = lib
        return _dis_lib


def _gray(im: np.ndarray, use_yuv: bool = False) -> np.ndarray:
    """[H, W, 3] uint8 BGR -> [H, W] uint8, bitwise ``cv2.cvtColor``:
    ``COLOR_BGR2GRAY`` (15-bit fixed point) or the Y of ``COLOR_BGR2YUV``
    (14-bit)."""
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"calc_flow takes [H, W, 3] uint8 BGR frames, got "
                         f"{im.dtype}{list(im.shape)}")
    b, g, r = (im[:, :, c].astype(np.int32) for c in range(3))
    if use_yuv:
        y = (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14
    else:
        y = (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15
    return y.astype(np.uint8)


def _dis_flow(g0: np.ndarray, g1: np.ndarray, **knobs) -> np.ndarray:
    """DIS optical flow of two [H, W] uint8 frames -> [H, W, 2] float32,
    what ``cv2.DISOpticalFlow_create(PRESET_MEDIUM).calc`` returns; the
    knobs (``_DIS_MEDIUM``'s names) are its setters, for holding each
    stage against OpenCV."""
    unknown = set(knobs) - set(_DIS_MEDIUM)
    if unknown:
        raise TypeError(f"unknown DIS knobs {sorted(unknown)}")
    k = {**_DIS_MEDIUM, **knobs}
    if g0.shape != g1.shape or g0.ndim != 2:
        raise ValueError(f"DIS takes two [H, W] frames of one size, got "
                         f"{g0.shape} and {g1.shape}")
    g0 = np.ascontiguousarray(g0, np.uint8)
    g1 = np.ascontiguousarray(g1, np.uint8)
    h, w = g0.shape
    params = np.array([k["finest_scale"], k["coarsest_scale"],
                       k["patch_size"], k["patch_stride"],
                       k["grad_descent_iter"], k["var_iter"],
                       int(k["mean_normalization"]),
                       int(k["spatial_propagation"])], np.int32)
    fparams = np.array([k["alpha"], k["gamma"], k["delta"], k["epsilon"]],
                       np.float32)
    flow = np.empty((h, w, 2), np.float32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _dis().rt_dis_flow(g0.ctypes.data, g1.ctypes.data, h, w,
                          params.ctypes.data, fparams.ctypes.data,
                          flow.ctypes.data, err, _ERRLEN):
        raise ValueError(f"DIS: {err.value.decode(errors='replace')}")
    return flow


def _variational_refinement(g0: np.ndarray, g1: np.ndarray, u: np.ndarray,
                            v: np.ndarray, alpha: float = 20.0,
                            gamma: float = 10.0, delta: float = 5.0,
                            epsilon: float = 0.001, omega: float = 1.6,
                            fixed_point_iters: int = 5,
                            sor_iters: int = 5):
    """DIS's variational refinement alone: what
    ``cv2.VariationalRefinement.calcUV`` returns for [H, W] uint8 frames
    and float32 flow components (its defaults)."""
    g0 = np.ascontiguousarray(g0, np.uint8)
    g1 = np.ascontiguousarray(g1, np.uint8)
    u = np.array(u, np.float32, order="C")
    v = np.array(v, np.float32, order="C")
    if g0.ndim != 2 or not g0.shape == g1.shape == u.shape == v.shape:
        raise ValueError(f"the frames and the flow components are [H, W] of "
                         f"one size, got {g0.shape}, {g1.shape}, {u.shape}, "
                         f"{v.shape}")
    h, w = g0.shape
    fparams = np.array([alpha, gamma, delta, epsilon, omega], np.float32)
    iters = np.array([fixed_point_iters, sor_iters], np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _dis().rt_variational_refinement(
            g0.ctypes.data, g1.ctypes.data, h, w, u.ctypes.data,
            v.ctypes.data, fparams.ctypes.data, iters.ctypes.data, err,
            _ERRLEN):
        raise ValueError(f"variational refinement: "
                         f"{err.value.decode(errors='replace')}")
    return u, v


def _box_mean(x: np.ndarray, r: int) -> np.ndarray:
    """Mean over the (2r+1)^2 window of each channel of [H, W] or
    [H, W, C] (float64), the border mirrored without repeating the edge
    (``BORDER_REFLECT_101``, scipy's "mirror")."""
    size = (2 * r + 1, 2 * r + 1) + (1,) * (x.ndim - 2)
    return ndimage.uniform_filter(x, size=size, mode="mirror")


def _guided_filter(guide: np.ndarray, src: np.ndarray, radius: int = 9,
                   eps: float = 2.0) -> np.ndarray:
    """He et al.'s guided filter (ECCV 2010, eq. 19-21) with a 3-channel
    guide, applied to each channel of ``src`` ([H, W] or [H, W, C]);
    float32 out.

    Conventions (``cv2.ximgproc.guidedFilter``, which the JAX
    ``calc_flow`` calls, is missing from OpenCV on both machines the port
    is checked on, so they could not be held to it bitwise): box means
    over (2 radius + 1)^2 windows with the border mirrored without
    repeating the edge (``BORDER_REFLECT_101``); the guide in its own
    units (0-255 for uint8, no rescaling); ``eps`` added as is, not
    squared, to the diagonal of each window's 3x3 covariance of the guide;
    float64 arithmetic."""
    I = np.asarray(guide, np.float64)
    if I.ndim != 3 or I.shape[2] != 3:
        raise ValueError(f"the guide is [H, W, 3], got {list(I.shape)}")
    p = np.asarray(src, np.float64)
    squeeze = p.ndim == 2
    if squeeze:
        p = p[:, :, None]
    if p.shape[:2] != I.shape[:2]:
        raise ValueError(f"guide {I.shape[:2]} and source {p.shape[:2]} "
                         f"differ in size")
    r = radius
    mean_I = _box_mean(I, r)                                    # [H, W, 3]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    prods = np.stack([I[:, :, i] * I[:, :, j] for i, j in pairs], -1)
    corr = _box_mean(prods, r)
    s = {ij: corr[:, :, k] - mean_I[:, :, ij[0]] * mean_I[:, :, ij[1]]
         + (eps if ij[0] == ij[1] else 0.0) for k, ij in enumerate(pairs)}
    # the inverse of the symmetric 3x3 covariance by its adjugate
    c00 = s[1, 1] * s[2, 2] - s[1, 2] * s[1, 2]
    c01 = s[0, 2] * s[1, 2] - s[0, 1] * s[2, 2]
    c02 = s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]
    c11 = s[0, 0] * s[2, 2] - s[0, 2] * s[0, 2]
    c12 = s[0, 2] * s[0, 1] - s[0, 0] * s[1, 2]
    c22 = s[0, 0] * s[1, 1] - s[0, 1] * s[0, 1]
    det = s[0, 0] * c00 + s[0, 1] * c01 + s[0, 2] * c02
    inv = [[c00, c01, c02], [c01, c11, c12], [c02, c12, c22]]
    out = np.empty(p.shape, np.float32)
    for c in range(p.shape[2]):
        pc = p[:, :, c]
        mean_p = _box_mean(pc, r)
        cov_Ip = _box_mean(I * pc[:, :, None], r) - mean_I * mean_p[:, :, None]
        a = np.stack([sum(inv[i][j] * cov_Ip[:, :, j] for j in range(3))
                      for i in range(3)], -1) / det[:, :, None]
        b = mean_p - (a * mean_I).sum(-1)
        q = (_box_mean(a, r) * I).sum(-1) + _box_mean(b, r)
        out[:, :, c] = q.astype(np.float32)
    return out[:, :, 0] if squeeze else out


def calc_flow(im0: np.ndarray, im1: np.ndarray,
              use_yuv: bool = False) -> np.ndarray:
    """Classical DIS optical-flow baseline with guided-filter
    post-processing (reference flow_utils.py:137-153): [H, W, 3] uint8 BGR
    frames -> [H, W, 2] float32 flow from im0 to im1.  DIS at OpenCV's
    PRESET_MEDIUM on the grey frames (the Y of YUV with ``use_yuv``), then
    :func:`_guided_filter` with im0 as the guide, radius 9, eps 2."""
    flow = _dis_flow(_gray(im0, use_yuv), _gray(im1, use_yuv))
    return _guided_filter(im0, flow, radius=9, eps=2.0)


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
