"""Procedural optical-flow dataset with exact ground truth, without OpenCV.

The JAX package's ``data/synthetic.py``: each sample is one multi-octave
noise canvas; frame 2 is a central crop, frame 1 the canvas resampled at
``x + flow(x)``, so ``im1(x) == im2(x + flow(x))`` up to bilinear
interpolation.  The flow is a random affine (translation, rotation,
log-scale) plus a smooth low-frequency displacement, bounded by
``max_flow`` (and so by the canvas margin); the valid mask is all ones.
Deterministic per ``(seed, index)``: the same numpy draws in the same
order as the JAX package's.

The JAX package resamples with OpenCV, which the port does not use:

* resizes (:func:`resize_linear`, :func:`resize_cubic`) compute what
  ``cv2.resize`` computes on float32 images: half-pixel centres, no
  antialias, linear taps clamped to the border; cubic with a = -0.75 and
  its four taps clamped to the border;
* :func:`remap_linear` samples bilinearly at the exact position, where
  ``cv2.remap`` first quantizes it to 1/32 px (and blends uint8 pixels in
  fixed point).  Frame 1 therefore differs from the JAX package's by at
  most what a shift of 1/64 px in x and in y makes of the canvas, plus
  the rounding of both to uint8: per pixel at most ``(max |dI/dx| + max
  |dI/dy|) / 64 + 1`` levels of 255, the derivatives over neighbouring
  canvas pixels (the bound ``tests/test_torch_port_train_data.py`` holds).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from .datasets import FlowDataset


@lru_cache(maxsize=8)
def _pixel_grid(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ys.setflags(write=False)
    xs.setflags(write=False)
    return ys, xs


def _src_positions(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Half-pixel-centre source positions of ``dst`` outputs over ``src``
    inputs: (floor index int64, fraction float32), as OpenCV computes
    them (the scale in double, the position rounded to float)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(np.float32)


def _linear_taps(src: int, dst: int):
    s, f = _src_positions(src, dst)
    lo, hi = s < 0, s >= src - 1
    f[lo | hi] = 0.0
    s[lo] = 0
    s[hi] = src - 1
    return [(s, 1.0 - f), (np.minimum(s + 1, src - 1), f)]


def _cubic_taps(src: int, dst: int, a: float = -0.75):
    s, x = _src_positions(src, dst)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    return [(np.clip(s + k - 1, 0, src - 1), c.astype(np.float32))
            for k, c in enumerate((c0, c1, c2, c3))]


def _separable(img: np.ndarray, taps_x, taps_y) -> np.ndarray:
    """Rows then columns, each output the taps' weighted sum (float32)."""
    tmp = sum(img[:, i] * w[None, :, None] for i, w in taps_x)
    return sum(tmp[i] * w[:, None, None] for i, w in taps_y).astype(np.float32)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] float32 -> [h, w, C], ``size = (w, h)`` as OpenCV takes
    it: ``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``."""
    w, h = size
    return _separable(img, _linear_taps(img.shape[1], w),
                      _linear_taps(img.shape[0], h))


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8, ``size = (w, h)``: bitwise
    ``cv2.resize(img, size)`` (INTER_LINEAR on 8-bit images), which works
    in fixed point: weights rounded to 11 bits, each row pass exact in
    int32, the column pass in OpenCV's vector form (16-bit multiply-high of
    the row sums shifted right by 4, then a rounding shift by 2).  Source
    rows outside the image are clamped with their weights kept; columns
    outside it take the edge column at full weight."""
    w, h = size
    H, W, _ = img.shape
    sx, fx = _src_positions(W, w)
    edge = (sx < 0) | (sx >= W - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, W - 1)
    one = np.float32(2048)
    a0 = np.rint((np.float32(1) - fx) * one).astype(np.int32)
    a1 = np.rint(fx * one).astype(np.int32)
    src = img.astype(np.int32)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, W - 1)] * a1[None, :, None])
    sy, fy = _src_positions(H, h)
    b0 = np.rint((np.float32(1) - fy) * one).astype(np.int32)
    b1 = np.rint(fy * one).astype(np.int32)
    t0 = ((rows[np.clip(sy, 0, H - 1)] >> 4) * b0[:, None, None]) >> 16
    t1 = ((rows[np.clip(sy + 1, 0, H - 1)] >> 4) * b1[:, None, None]) >> 16
    return np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)


def resize_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """As :func:`resize_linear` with ``cv2.INTER_CUBIC`` (a = -0.75)."""
    w, h = size
    return _separable(img, _cubic_taps(img.shape[1], w),
                      _cubic_taps(img.shape[0], h))


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] sampled bilinearly at (map_x, map_y) [h, w] (every
    position inside the image), rounded to uint8."""
    H, W, C = img.shape
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0).astype(np.float32).reshape(-1, 1)
    fy = (map_y - y0).astype(np.float32).reshape(-1, 1)
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    x0, y0 = np.clip(x0, 0, W - 1), np.clip(y0, 0, H - 1)
    flat = img.reshape(-1, C).astype(np.float32)

    def at(y, x):
        return np.take(flat, (y * W + x).reshape(-1), axis=0)
    top = at(y0, x0) + fx * (at(y0, x1) - at(y0, x0))
    bottom = at(y1, x0) + fx * (at(y1, x1) - at(y1, x0))
    out = top + fy * (bottom - top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(
        map_x.shape + (C,))


def _noise_texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Multi-octave colour noise, accumulated coarse to fine at octave
    resolution, then resized to [h, w] and truncated to uint8."""
    octaves = (4, 8, 16, 32, 64)          # finest -> coarsest grid divisor
    amps = [0.6 ** k for k in range(len(octaves))]
    canvas = None
    for octave, amp in zip(reversed(octaves), reversed(amps)):
        gh, gw = max(h // octave, 2), max(w // octave, 2)
        layer = rng.rand(gh, gw, 3).astype(np.float32) * amp
        canvas = layer if canvas is None else \
            resize_linear(canvas, (gw, gh)) + layer
    canvas = resize_linear(canvas, (w, h))
    np.multiply(canvas, 255.0 / sum(amps), out=canvas)
    return np.clip(canvas, 0, 255, out=canvas).astype(np.uint8)


def _smooth_field(rng: np.random.RandomState, h: int, w: int,
                  cells: int, scale: float) -> np.ndarray:
    """[H, W, 2] low-frequency displacement in about [-scale, scale]."""
    grid = (rng.rand(cells, cells, 2).astype(np.float32) * 2 - 1) * scale
    return resize_cubic(grid, (w, h))


class SyntheticFlowDataset(FlowDataset):
    """Endless-by-index procedural (im1, im2, flow, valid) samples."""

    def __init__(self, size: Tuple[int, int] = (96, 128), length: int = 1000,
                 max_flow: float = 6.0, seed: int = 0, augmentor=None):
        super().__init__(augmentor)
        self.size = tuple(size)
        self.length = int(length)
        self.max_flow = float(max_flow)
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.length

    @property
    def has_gt(self) -> bool:
        return True

    def _load(self, idx):
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % (2**31))
        h, w = self.size
        margin = int(np.ceil(self.max_flow)) + 2
        ch, cw = h + 2 * margin, w + 2 * margin
        canvas = _noise_texture(rng, ch, cw)

        angle = rng.uniform(-0.03, 0.03)
        log_scale = rng.uniform(-0.04, 0.04)
        tx, ty = rng.uniform(-0.5, 0.5, 2) * self.max_flow
        ys, xs = _pixel_grid(h, w)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        dx, dy = xs - cx, ys - cy
        s = np.exp(log_scale)
        fx = (s * (np.cos(angle) * dx - np.sin(angle) * dy) - dx) + tx
        fy = (s * (np.sin(angle) * dx + np.cos(angle) * dy) - dy) + ty
        bump = _smooth_field(rng, h, w, cells=4, scale=0.35 * self.max_flow)
        flow = np.stack([fx, fy], -1) + bump
        limit = self.max_flow
        mag = np.sqrt(np.einsum("hwc,hwc->hw", flow, flow))[..., None]
        flow = (flow * (limit / np.maximum(mag, limit))).astype(np.float32)

        im2 = canvas[margin:margin + h, margin:margin + w]
        map_x = (xs + margin) + flow[..., 0]
        map_y = (ys + margin) + flow[..., 1]
        im1 = remap_linear(canvas, map_x, map_y)
        return im1, im2, flow, None
