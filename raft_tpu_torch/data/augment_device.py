"""Device-side flow augmentation: the FlowAugmentor recipe as PyTorch ops
on the batch's device.

The port's counterpart of the JAX package's ``data/augment_device.py``:
worker processes only decode (uint8 frames + float flow,
:class:`DecodeOnlyDataset`) and the augmentation runs on the card, on
``data/pipeline.py::PrefetchLoader``'s side stream right after the batch's
copy (``augment_fn``).  Stock PyTorch ops (no hand-written kernel: the
JAX module is XLA, not Pallas), batched over the leading axis.

Numerical contract: given the same sampled parameters,
:meth:`DeviceFlowAugmentor.apply_params` computes what the numpy
augmentor's :meth:`~raft_tpu_torch.data.augment.FlowAugmentor.apply_params`
and the JAX package's device augmentor compute, up to float32 rounding:

* photometric — contrast about the frame's mean (summed in float64, so
  the card and the CPU agree on it), the gamma LUT's floor index
  (``lut[uint8(x)]``), the brightness clip; one draw for both frames.  The
  JAX package sums the mean in float32 in another order, so a value within
  rounding of an integer may floor the other way there: that pixel then
  differs by one step of the gamma curve;
* spatial — resize, flip and crop folded into one inverse bilinear gather
  with ``cv2.resize``'s ``INTER_LINEAR`` convention ``src = (dst + 0.5) *
  size / nsize - 0.5``, the floor and remainder taken on the exact integer
  numerator, the border replicated by clamping, so the resized frame is
  never made;
* flow values scale by the rounded ``(nw / w, nh / h)`` and flip signs;
* the occlusion eraser paints mean-colour rectangles on frame 2, the mean
  taken before any rectangle.

Sampling (:meth:`DeviceFlowAugmentor.sample_params`) draws from an
explicit ``torch.Generator`` on the batch's device, the counterpart of the
JAX package's ``jax.random`` keys: its draws differ from JAX's (and from
the host augmentor's ``RandomState``), with the same distributions, so
each pipeline is reproducible on its own but not identical to another.
Parity with JAX is held through :func:`params_from_host`: the same
parameters go through both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .augment import STAGE_SCALES
from .datasets import FlowDataset


class AugParams(NamedTuple):
    """Per-sample augmentation draws, each field a tensor of shape [B]
    (``erase_rects`` [B, 2, 4]).

    ``contrast=1, gamma=0, brightness=0`` encode "photometric off";
    ``erase_count=0`` "eraser off"; ``nh == h, nw == w`` "no resample"."""

    contrast: torch.Tensor      # float32
    gamma: torch.Tensor         # float32
    brightness: torch.Tensor    # float32
    nh: torch.Tensor            # int64 resized height
    nw: torch.Tensor            # int64 resized width
    hflip: torch.Tensor         # bool
    vflip: torch.Tensor         # bool
    y0: torch.Tensor            # int64 crop origin (resized coordinates)
    x0: torch.Tensor            # int64
    erase_count: torch.Tensor   # int64, 0..2 rectangles
    erase_rects: torch.Tensor   # int64 [B, 2, 4] (x0, y0, dx, dy)


def params_from_host(ps, device="cpu") -> AugParams:
    """One ``FlowAugmentor.sample_params`` dict, or a list of them (one
    per row), as :class:`AugParams` on ``device``."""
    ps = [ps] if isinstance(ps, dict) else list(ps)
    rects = np.zeros((len(ps), 2, 4), np.int64)
    for i, p in enumerate(ps):
        for j, r in enumerate(p["erase_rects"]):
            rects[i, j] = r

    def col(key, dtype, default=None):
        vals = [p.get(key, default) for p in ps]
        return torch.tensor(vals, dtype=dtype, device=device)

    return AugParams(
        contrast=col("contrast", torch.float32, 1.0),
        gamma=col("gamma", torch.float32, 0.0),
        brightness=col("brightness", torch.float32, 0.0),
        nh=col("nh", torch.int64), nw=col("nw", torch.int64),
        hflip=col("hflip", torch.bool), vflip=col("vflip", torch.bool),
        y0=col("y0", torch.int64), x0=col("x0", torch.int64),
        erase_count=torch.tensor([len(p["erase_rects"]) for p in ps],
                                 dtype=torch.int64, device=device),
        erase_rects=torch.from_numpy(rects).to(device))


def _src_coords(r: torch.Tensor, size: torch.Tensor, nsize: torch.Tensor):
    """Resized-frame integer coordinate ``r`` -> source ``(r + 0.5) *
    size / nsize - 0.5 = ((2r + 1) size - nsize) / (2 nsize)`` as (floor
    index, fraction): the floor and remainder on the integer numerator
    keep the taps exact and the weight within one float32 rounding."""
    num = (2 * r + 1) * size - nsize
    den = 2 * nsize
    lo = torch.div(num, den, rounding_mode="floor")
    return lo, (num - lo * den).float() / den.float()


class DeviceFlowAugmentor:
    """FlowAugmentor's hyperparameters, executed as PyTorch ops on a batch
    ([B, H, W, C] tensors) on its device."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 spatial_prob: float = 0.8, stretch_prob: float = 0.8,
                 max_stretch: float = 0.2, eraser_prob: float = 0.5,
                 photometric: bool = True):
        self.crop_size = tuple(crop_size)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.do_flip = bool(do_flip)
        self.spatial_prob = float(spatial_prob)
        self.stretch_prob = float(stretch_prob)
        self.max_stretch = float(max_stretch)
        self.eraser_prob = float(eraser_prob)
        self.photometric = bool(photometric)

    # ------------------------------------------------------------- sampling

    def sample_params(self, generator: torch.Generator, hw: torch.Tensor
                      ) -> AugParams:
        """Draw the params of a batch from ``generator`` (on the batch's
        device); ``hw`` [B, 2] int64 is each row's (h, w) content extent."""
        ch, cw = self.crop_size
        dev = hw.device
        B = hw.shape[0]

        def uni(lo, hi, shape=(B,)):
            u = torch.rand(shape, generator=generator, device=dev)
            return lo + (hi - lo) * u

        def coin(p):
            return torch.rand((B,), generator=generator, device=dev) < p

        def randint(lo, hi, shape=(B,)):
            # integers in [lo, hi), lo/hi tensors or ints
            u = torch.rand(shape, generator=generator, device=dev,
                           dtype=torch.float64)
            return (lo + torch.floor(u * (hi - lo))).long()

        h = hw[:, 0].float()
        w = hw[:, 1].float()
        if self.photometric:
            contrast, gamma = uni(0.8, 1.2), uni(-0.2, 0.2)
            brightness = uni(-20.0, 20.0)
        else:
            contrast = torch.ones(B, device=dev)
            gamma = torch.zeros(B, device=dev)
            brightness = torch.zeros(B, device=dev)
        floor = torch.maximum((ch + 8) / h, (cw + 8) / w)
        scale = 2.0 ** uni(self.min_scale, self.max_scale)
        stretch = coin(self.stretch_prob)
        st_x = 2.0 ** uni(-self.max_stretch, self.max_stretch)
        st_y = 2.0 ** uni(-self.max_stretch, self.max_stretch)
        sx = torch.maximum(scale * torch.where(stretch, st_x, 1.0), floor)
        sy = torch.maximum(scale * torch.where(stretch, st_y, 1.0), floor)
        spatial = coin(self.spatial_prob)
        nh = torch.where(spatial, torch.round(h * sy), h).long()
        nw = torch.where(spatial, torch.round(w * sx), w).long()
        hflip = coin(0.5) & self.do_flip
        vflip = coin(0.1) & self.do_flip
        y0 = randint(0, nh - ch + 1)
        x0 = randint(0, nw - cw + 1)
        erase_on = coin(self.eraser_prob)
        n_rects = randint(1, 3)
        rects = torch.stack([randint(0, cw, (B, 2)), randint(0, ch, (B, 2)),
                             randint(50, 100, (B, 2)),
                             randint(50, 100, (B, 2))], dim=-1)
        return AugParams(contrast=contrast, gamma=gamma,
                         brightness=brightness, nh=nh, nw=nw, hflip=hflip,
                         vflip=vflip, y0=y0, x0=x0,
                         erase_count=torch.where(erase_on, n_rects, 0),
                         erase_rects=rects)

    # ---------------------------------------------------------- application

    @staticmethod
    def _photometric(im: torch.Tensor, p: AugParams,
                     mask: torch.Tensor) -> torch.Tensor:
        # contrast about the mean over the content extent (all H*W*C),
        # summed in float64: the same float32 mean on every device
        count = torch.clamp(mask.sum(dim=(1, 2, 3)) * im.shape[-1], min=1.0)
        mean = ((im.double() * mask).sum(dim=(1, 2, 3))
                / count.double()).float()
        c = p.contrast.view(-1, 1, 1, 1)
        m = mean.view(-1, 1, 1, 1)
        im = torch.clamp((im - m) * c + m, 0.0, 255.0)
        # gamma: the host LUT indexes by uint8(x), i.e. floor in [0, 255]
        idx = torch.clamp(torch.floor(im), 0.0, 255.0) / 255.0
        im = torch.pow(idx, 1.0 + p.gamma.view(-1, 1, 1, 1)) * 255.0
        return torch.clamp(im + p.brightness.view(-1, 1, 1, 1), 0.0, 255.0)

    @staticmethod
    def _gather(im: torch.Tensor, yr, xr, h, nh, w, nw) -> torch.Tensor:
        """Bilinear sample ``im`` [B, H, W, C] at the outer product of
        integer resized-frame coordinates ``yr`` [B, ch], ``xr`` [B, cw]
        (horizontal lerp first, border replicated within each row's (h, w)
        content extent)."""
        y0, wy = _src_coords(yr, h[:, None], nh[:, None])
        x0, wx = _src_coords(xr, w[:, None], nw[:, None])
        hm, wm = (h - 1)[:, None], (w - 1)[:, None]
        y0i = torch.minimum(torch.clamp(y0, min=0), hm)
        y1i = torch.minimum(torch.clamp(y0 + 1, min=0), hm)
        x0i = torch.minimum(torch.clamp(x0, min=0), wm)
        x1i = torch.minimum(torch.clamp(x0 + 1, min=0), wm)
        b = torch.arange(im.shape[0], device=im.device)[:, None, None]
        wx = wx[:, None, :, None]

        def rows(yi):
            top = im[b, yi[:, :, None], x0i[:, None, :]]
            bot = im[b, yi[:, :, None], x1i[:, None, :]]
            return top * (1.0 - wx) + bot * wx

        wy = wy[:, :, None, None]
        return rows(y0i) * (1.0 - wy) + rows(y1i) * wy

    def apply_params(self, p: AugParams, im1: torch.Tensor,
                     im2: torch.Tensor, flow: torch.Tensor,
                     hw: Optional[torch.Tensor] = None):
        """A batch: [B, H, W, 3] frames (uint8 or float, 0..255) + [B, H,
        W, 2] flow -> crop-shaped float [0, 1] frames, flow and valid,
        with ``p`` holding one row of params per sample.  ``hw`` [B, 2]:
        each row's content extent (default: the whole frame)."""
        ch, cw = self.crop_size
        B, H, W = im1.shape[:3]
        dev = im1.device
        if hw is None:
            hw = torch.tensor([[H, W]], dtype=torch.int64,
                              device=dev).expand(B, 2)
        h, w = hw[:, 0], hw[:, 1]
        im1 = im1.float()
        im2 = im2.float()
        flow = flow.float()
        if self.photometric:
            ys = torch.arange(H, device=dev)[None, :, None]
            xs = torch.arange(W, device=dev)[None, None, :]
            mask = ((ys < h[:, None, None]) & (xs < w[:, None, None])
                    ).float()[..., None]
            im1 = self._photometric(im1, p, mask)
            im2 = self._photometric(im2, p, mask)

        # crop coordinates in the (virtual) resized frame; the host flips
        # the resized arrays before cropping, so mirror them first
        yr = p.y0[:, None] + torch.arange(ch, device=dev)[None, :]
        xr = p.x0[:, None] + torch.arange(cw, device=dev)[None, :]
        yr = torch.where(p.vflip[:, None], p.nh[:, None] - 1 - yr, yr)
        xr = torch.where(p.hflip[:, None], p.nw[:, None] - 1 - xr, xr)
        im1c = self._gather(im1, yr, xr, h, p.nh, w, p.nw)
        im2c = self._gather(im2, yr, xr, h, p.nh, w, p.nw)
        flowc = self._gather(flow, yr, xr, h, p.nh, w, p.nw)
        fx = (p.nw.float() / w.float()) * torch.where(p.hflip, -1.0, 1.0)
        fy = (p.nh.float() / h.float()) * torch.where(p.vflip, -1.0, 1.0)
        flowc = flowc * torch.stack([fx, fy], dim=-1)[:, None, None, :]

        # occlusion eraser on frame 2: the mean before any rect is painted
        mean = im2c.reshape(B, -1, 3).mean(dim=1)[:, None, None, :]
        yg = torch.arange(ch, device=dev)[None, :, None]
        xg = torch.arange(cw, device=dev)[None, None, :]
        for r in range(2):
            ex, ey, dx, dy = (p.erase_rects[:, r, k][:, None, None]
                              for k in range(4))
            hit = ((r < p.erase_count)[:, None, None] & (xg >= ex)
                   & (xg < ex + dx) & (yg >= ey) & (yg < ey + dy))
            im2c = torch.where(hit[..., None], mean, im2c)

        valid = ((flowc[..., 0].abs() < 1000)
                 & (flowc[..., 1].abs() < 1000)).float()
        return im1c / 255.0, im2c / 255.0, flowc, valid

    def __call__(self, generator: torch.Generator, im1, im2, flow,
                 hw: Optional[torch.Tensor] = None):
        if hw is None:
            B, H, W = im1.shape[:3]
            hw = torch.tensor([[H, W]], dtype=torch.int64,
                              device=im1.device).expand(B, 2)
        return self.apply_params(self.sample_params(generator, hw),
                                 im1, im2, flow, hw)


def make_batch_augment_fn(aug: DeviceFlowAugmentor,
                          hw: Optional[Tuple[int, int]] = None):
    """``fn(batch, generator) -> (im1, im2, flow, valid)``: the batch's
    first three fields augmented on their device, params drawn from
    ``generator``.  ``hw`` fixes every row's content extent (the
    uniform-frame datasets); None means the whole frame.  The signature
    of ``PrefetchLoader``'s ``augment_fn``."""

    def fn(batch, generator):
        im1, im2, flow = batch[:3]
        B, H, W = im1.shape[:3]
        extent = torch.tensor([hw if hw is not None else (H, W)],
                              dtype=torch.int64, device=im1.device)
        return aug(generator, im1, im2, flow, extent.expand(B, 2))

    return fn


class DecodeOnlyDataset:
    """Decode-only view for the device-augmented pipeline: ``__getitem__``
    runs the dataset's raw ``_load`` (uint8 frames + float flow, no host
    augmentor, no /255) and ships (im1, im2, flow).

    Frames must share one canonical (H, W), as in every dense training
    stage; a mismatched frame raises, and so does sparse ground truth (a
    non-None ``valid`` from ``_load``), which stays on the host."""

    augmentor = None

    def __init__(self, ds, canonical_hw: Optional[Tuple[int, int]] = None):
        self.ds = ds
        if canonical_hw is None:
            canonical_hw = tuple(ds._load(0)[0].shape[:2])
        self.canonical_hw = tuple(canonical_hw)

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx):
        im1, im2, flow, valid = self.ds._load(idx)
        if valid is not None:
            raise ValueError(
                "device-side augmentation needs dense ground truth "
                "(sparse/gt-less splits keep the host pipeline)")
        h, w = im1.shape[:2]
        if (h, w) != self.canonical_hw:
            raise ValueError(
                f"device-aug needs uniform source frames: sample {idx} is "
                f"({h}, {w}), canonical is {self.canonical_hw}")
        return (np.ascontiguousarray(im1, dtype=np.uint8),
                np.ascontiguousarray(im2, dtype=np.uint8),
                np.ascontiguousarray(flow, dtype=np.float32))

    sample_iter = FlowDataset.sample_iter


def make_device_augmentor(stage: str,
                          crop_size: Tuple[int, int]) -> DeviceFlowAugmentor:
    """Stage-preset device augmentor sharing the host pipeline's
    :data:`~raft_tpu_torch.data.augment.STAGE_SCALES` ranges."""
    if stage not in STAGE_SCALES:
        raise ValueError(f"device-side augmentation has no preset for "
                         f"{stage!r} (sparse-gt stages are host-only)")
    lo, hi = STAGE_SCALES[stage]
    return DeviceFlowAugmentor(crop_size, min_scale=lo, max_scale=hi)
