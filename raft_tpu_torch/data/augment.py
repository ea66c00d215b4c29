"""Data augmentation for optical-flow training, on the host (numpy).

The port's copy of the JAX package's ``data/augment.py``:

* ``PairAugmentor`` — the reference's FlowDataProcess semantics (reference
  dataflow/test_dataflow.py:13-99): paired photometric transforms with
  the same parameters on both frames, random frame-order swap, horizontal
  flip, random crop, test-mode resize.  Image pairs only.
* ``FlowAugmentor`` — the flow-aware recipe of a real training run:
  random scale/stretch with the flow values rescaled, flips with the flow
  signs flipped, random crop, an occlusion eraser on frame 2.  Split into
  :meth:`~FlowAugmentor.sample_params` (every ``RandomState`` draw, the
  JAX package's draws in the JAX package's order, so one seed gives the
  same parameters in both) and :meth:`~FlowAugmentor.apply_params`.
* ``SparseFlowAugmentor`` — KITTI's sparse ground truth, resampled by
  scatter (:func:`resample_sparse_flow`).

Without OpenCV: resizes are ``data/synthetic.py::resize_linear`` (what
``cv2.resize`` computes with ``INTER_LINEAR`` on float32, up to float32
rounding); the blur is a separable Gaussian in numpy with OpenCV's border
(``utils/frame_utils.py::gaussian_blur``); the JPEG round trip of
``PairAugmentor(rgb_augmentation=True)`` runs through the port's own JPEG
codec (``imageio.py``), which writes and reads the bytes OpenCV does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Official-curriculum scale ranges per training stage (min_scale, max_scale),
# shared by the host FlowAugmentor (datasets.make_training_dataset) and the
# device augmentor (augment_device.make_device_augmentor).
STAGE_SCALES = {
    "chairs": (-0.1, 1.0),
    "things": (-0.4, 0.8),
    "sintel": (-0.2, 0.6),
    "synthetic": (-0.2, 0.5),
}


def _resize(im: np.ndarray, nw: int, nh: int) -> np.ndarray:
    from .synthetic import resize_linear     # synthetic imports datasets
    return resize_linear(np.ascontiguousarray(im, np.float32), (nw, nh))


def _apply_contrast(im: np.ndarray, factor: float) -> np.ndarray:
    mean = im.mean()
    return np.clip((im - mean) * factor + mean, 0, 255)


def _apply_gamma(im: np.ndarray, gamma_exp: float) -> np.ndarray:
    # tensorpack imgaug.Gamma: lut = (x/255)^(1+gamma) * 255
    lut = ((np.arange(256) / 255.0) ** (1.0 + gamma_exp) * 255.0)
    return lut[im.astype(np.uint8).clip(0, 255)].astype(np.float32)


def _apply_blur(im: np.ndarray, size: int, sigma: float) -> np.ndarray:
    if size <= 0:
        return im
    from ..utils.frame_utils import gaussian_blur
    return gaussian_blur(im, 2 * size + 1, sigma).astype(np.float32)


def _apply_jpeg(im: np.ndarray, quality: int) -> np.ndarray:
    from ..imageio import decode_jpeg, encode_jpeg
    enc = encode_jpeg(im.astype(np.uint8), int(quality))
    return decode_jpeg(enc).astype(np.float32)


def _paired_color(rng: np.random.RandomState, im1: np.ndarray,
                  im2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Contrast/gamma/brightness with the SAME draw applied to both frames
    (shared by the dense and sparse flow augmentors)."""
    contrast = rng.uniform(0.8, 1.2)
    gamma = rng.uniform(-0.2, 0.2)
    brightness = rng.uniform(-20, 20)
    for f in ((lambda x: _apply_contrast(x, contrast)),
              (lambda x: _apply_gamma(x, gamma)),
              (lambda x: np.clip(x + brightness, 0, 255))):
        im1, im2 = f(im1), f(im2)
    return im1, im2


def _occlusion_eraser(rng: np.random.RandomState, im2: np.ndarray,
                      prob: float) -> np.ndarray:
    """With probability ``prob``, paint 1-2 random mean-color rectangles onto
    frame 2 (synthetic occlusions; shared by both flow augmentors)."""
    if rng.rand() < prob:
        h, w = im2.shape[:2]
        mean = im2.reshape(-1, 3).mean(0)
        for _ in range(rng.randint(1, 3)):
            x0 = rng.randint(0, w)
            y0 = rng.randint(0, h)
            dx = rng.randint(50, 100)
            dy = rng.randint(50, 100)
            im2[y0:y0 + dy, x0:x0 + dx] = mean
    return im2


class PairAugmentor:
    """Reference FlowDataProcess semantics (paired params, no flow)."""

    def __init__(self, input_size: Tuple[int, int],
                 general_augmentation: bool = False,
                 rgb_augmentation: bool = False,
                 random_crop: bool = False, test_mode: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        if len(input_size) != 2:
            raise ValueError(f"input_size is (h, w), got {input_size}")
        self.input_size = tuple(input_size)
        self.general = general_augmentation
        self.rgb = rgb_augmentation
        self.random_crop = random_crop
        self.test_mode = test_mode
        self.rng = rng or np.random.RandomState()

    def __call__(self, im1: np.ndarray, im2: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        rng = self.rng
        im1 = im1.astype(np.float32)
        im2 = im2.astype(np.float32)

        if self.general and rng.choice([0, 1]) > 0:   # frame-order swap
            im1, im2 = im2, im1

        if self.rgb:   # same params to both frames (reference :71-73)
            contrast = rng.uniform(0.8, 1.2)
            gamma = rng.uniform(-0.3, 0.3)
            blur_size = rng.randint(0, 3)
            blur_sigma = rng.uniform(0.2, 0.5)
            quality = rng.randint(70, 100)
            for f in ((lambda x: _apply_contrast(x, contrast)),
                      (lambda x: _apply_gamma(x, gamma)),
                      (lambda x: _apply_blur(x, blur_size, blur_sigma)),
                      (lambda x: _apply_jpeg(x, quality))):
                im1, im2 = f(im1), f(im2)

        if self.general and rng.choice([0, 1]) > 0:   # paired horizontal flip
            im1, im2 = im1[:, ::-1], im2[:, ::-1]

        h, w = self.input_size
        if self.random_crop:
            y0 = rng.randint(0, max(im1.shape[0] - h, 0) + 1)
            x0 = rng.randint(0, max(im1.shape[1] - w, 0) + 1)
            im1 = im1[y0:y0 + h, x0:x0 + w]
            im2 = im2[y0:y0 + h, x0:x0 + w]
        elif self.test_mode:
            im1 = _resize(im1, w, h)
            im2 = _resize(im2, w, h)
        else:   # eval: top-left crop (reference :91-92)
            im1 = im1[:h, :w]
            im2 = im2[:h, :w]

        return im1 / 255.0, im2 / 255.0


def resample_sparse_flow(flow: np.ndarray, valid: np.ndarray,
                         sx: float, sy: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Valid-aware resampling of a sparse flow map to scale (sx, sy): each
    VALID sample moves to (round(x*sx), round(y*sy)) with its flow scaled
    by (sx, sy); output pixels no sample reaches stay invalid; collisions
    keep the last write (official RAFT ``resize_sparse_flow_map``)."""
    h, w = flow.shape[:2]
    nh, nw = int(round(h * sy)), int(round(w * sx))
    ys, xs = np.nonzero(valid >= 0.5)
    x1 = np.round(xs * sx).astype(np.int64)
    y1 = np.round(ys * sy).astype(np.int64)
    keep = (x1 >= 0) & (x1 < nw) & (y1 >= 0) & (y1 < nh)
    out_flow = np.zeros((nh, nw, 2), np.float32)
    out_valid = np.zeros((nh, nw), np.float32)
    out_flow[y1[keep], x1[keep], 0] = flow[ys[keep], xs[keep], 0] * sx
    out_flow[y1[keep], x1[keep], 1] = flow[ys[keep], xs[keep], 1] * sy
    out_valid[y1[keep], x1[keep]] = 1.0
    return out_flow, out_valid


class SparseFlowAugmentor:
    """Augmentation for sparse ground truth (KITTI): paired photometric,
    random scale (valid-aware scatter, :func:`resample_sparse_flow`),
    horizontal flip, random crop, occlusion eraser — the official RAFT
    KITTI-finetune recipe (no stretch).  Pads with replicate if a frame is
    smaller than the crop."""

    accepts_valid = True

    def __init__(self, crop_size: Tuple[int, int], do_flip: bool = True,
                 min_scale: float = -0.2, max_scale: float = 0.4,
                 spatial_prob: float = 0.8, photometric: bool = True,
                 eraser_prob: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.crop_size = tuple(crop_size)
        self.do_flip = do_flip
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_prob = spatial_prob
        self.photometric = photometric
        self.eraser_prob = eraser_prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, im1, im2, flow, valid):
        rng = self.rng
        ch, cw = self.crop_size
        im1 = im1.astype(np.float32)
        im2 = im2.astype(np.float32)
        flow = flow.astype(np.float32)
        valid = valid.astype(np.float32)

        if self.photometric:
            im1, im2 = _paired_color(rng, im1, im2)

        # random scale: images resize densely, flow+valid scatter sparsely;
        # clamped so the scaled frame still contains the crop window
        h, w = im1.shape[:2]
        scale_floor = max((ch + 1) / float(h), (cw + 1) / float(w))
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        scale = max(scale, scale_floor)
        if rng.rand() < self.spatial_prob and scale != 1.0:
            nh, nw = int(round(h * scale)), int(round(w * scale))
            im1 = _resize(im1, nw, nh)
            im2 = _resize(im2, nw, nh)
            flow, valid = resample_sparse_flow(flow, valid, scale, scale)

        ph = max(ch - im1.shape[0], 0)
        pw = max(cw - im1.shape[1], 0)
        if ph or pw:
            im1 = np.pad(im1, ((0, ph), (0, pw), (0, 0)), mode="edge")
            im2 = np.pad(im2, ((0, ph), (0, pw), (0, 0)), mode="edge")
            flow = np.pad(flow, ((0, ph), (0, pw), (0, 0)))
            valid = np.pad(valid, ((0, ph), (0, pw)))   # padded area invalid

        if self.do_flip and rng.rand() < 0.5:
            im1 = im1[:, ::-1]
            im2 = im2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        y0 = rng.randint(0, im1.shape[0] - ch + 1)
        x0 = rng.randint(0, im1.shape[1] - cw + 1)
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        im2c = _occlusion_eraser(rng, np.ascontiguousarray(im2[sl]),
                                 self.eraser_prob)
        return (np.ascontiguousarray(im1[sl]) / 255.0,
                im2c / 255.0,
                np.ascontiguousarray(flow[sl]),
                np.ascontiguousarray(valid[sl]))


class FlowAugmentor:
    """Flow-aware training augmentation (official-RAFT-style recipe):
    :meth:`sample_params` draws, :meth:`apply_params` transforms,
    ``__call__`` composes the two."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 spatial_prob: float = 0.8, stretch_prob: float = 0.8,
                 max_stretch: float = 0.2, eraser_prob: float = 0.5,
                 photometric: bool = True,
                 rng: Optional[np.random.RandomState] = None):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.spatial_prob = spatial_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.eraser_prob = eraser_prob
        self.photometric = photometric
        self.rng = rng or np.random.RandomState()

    def sample_params(self, h: int, w: int) -> dict:
        """Draw every random decision for one (h, w) sample, in the JAX
        package's ``RandomState`` call order (photometric, scale/stretch,
        spatial coin, flips, crop origin, eraser): the order is the
        determinism contract of seed-per-index workers."""
        rng = self.rng
        ch, cw = self.crop_size
        p = {"crop": (ch, cw)}
        if self.photometric:
            p["contrast"] = float(rng.uniform(0.8, 1.2))
            p["gamma"] = float(rng.uniform(-0.2, 0.2))
            p["brightness"] = float(rng.uniform(-20, 20))
        min_scale = max((ch + 8) / float(h), (cw + 8) / float(w))
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.rand() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx = max(sx, min_scale)
        sy = max(sy, min_scale)
        if rng.rand() < self.spatial_prob:
            p["nh"], p["nw"] = int(round(h * sy)), int(round(w * sx))
        else:   # no resample: flow keeps its original scale
            p["nh"], p["nw"] = h, w
        p["hflip"] = bool(self.do_flip and rng.rand() < 0.5)
        p["vflip"] = bool(self.do_flip and rng.rand() < 0.1)
        p["y0"] = int(rng.randint(0, p["nh"] - ch + 1))
        p["x0"] = int(rng.randint(0, p["nw"] - cw + 1))
        rects = []
        if rng.rand() < self.eraser_prob:
            for _ in range(rng.randint(1, 3)):
                rects.append((int(rng.randint(0, cw)), int(rng.randint(0, ch)),
                              int(rng.randint(50, 100)),
                              int(rng.randint(50, 100))))
        p["erase_rects"] = rects
        return p

    def apply_params(self, im1: np.ndarray, im2: np.ndarray, flow: np.ndarray,
                     p: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Deterministic transform for pre-sampled params ``p`` — the numpy
        oracle the device augmentor is held to."""
        ch, cw = p["crop"]
        im1 = im1.astype(np.float32)
        im2 = im2.astype(np.float32)
        flow = flow.astype(np.float32)
        h, w = im1.shape[:2]
        if self.photometric:
            for f in ((lambda x: _apply_contrast(x, p["contrast"])),
                      (lambda x: _apply_gamma(x, p["gamma"])),
                      (lambda x: np.clip(x + p["brightness"], 0, 255))):
                im1, im2 = f(im1), f(im2)
        nh, nw = p["nh"], p["nw"]
        if (nh, nw) != (h, w):
            im1 = _resize(im1, nw, nh)
            im2 = _resize(im2, nw, nh)
            flow = _resize(flow, nw, nh)
            flow = flow * [nw / float(w), nh / float(h)]
        if p["hflip"]:
            im1 = im1[:, ::-1]
            im2 = im2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if p["vflip"]:
            im1 = im1[::-1]
            im2 = im2[::-1]
            flow = flow[::-1] * [1.0, -1.0]
        y0, x0 = p["y0"], p["x0"]
        im1 = im1[y0:y0 + ch, x0:x0 + cw]
        im2 = np.ascontiguousarray(im2[y0:y0 + ch, x0:x0 + cw])
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        if p["erase_rects"]:
            mean = im2.reshape(-1, 3).mean(0)
            for ex, ey, dx, dy in p["erase_rects"]:
                im2[ey:ey + dy, ex:ex + dx] = mean
        im1 = np.ascontiguousarray(im1) / 255.0
        im2 = im2 / 255.0
        flow = np.ascontiguousarray(flow)
        valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return im1, im2, flow, valid.astype(np.float32)

    def __call__(self, im1: np.ndarray, im2: np.ndarray, flow: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """uint8 images + [H,W,2] flow -> cropped float [0,1] pair, flow, valid."""
        h, w = im1.shape[:2]
        return self.apply_params(im1, im2, flow, self.sample_params(h, w))
