"""The yardstick's arithmetic: peaks, roofline bounds and model FLOPs.

``RATES``, ``PEAK_BYTES``, :func:`bound_s`, :func:`gru_ops` and
:func:`corr_positions` are a frozen copy of ``chip_smoke.py``'s
``RATES``, ``_bound_ms``, ``_gru_flops`` and ``_corr_positions``: every
product is priced at the fastest route the H100 offers at its accuracy.
The f32 x f32 rate, 495/3 TFLOP/s, is *derived* from the data sheet's
TF32 figure (three TF32 products, hi*hi + hi*lo + lo*hi, make one
float32-accurate product); the data sheet publishes no such rate.

:func:`model_flops` counts the published architecture's convolutions and
matrix products for one frame pair from shapes alone: both encoders, the
all-pairs correlation volume, and per iteration the motion encoder, the
whole GRU (context channels included: a hoist that saves work shows as
time, not as fewer counted FLOPs), the flow head and, for raft-things,
the mask head.  Elementwise work, pooling, sampling and the upsampling
are not counted, so a share of the peak computed from it is a lower bound.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# H100 SXM (NVIDIA data sheet, dense rates, 700 W).
DATASHEET = {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
             "fp32_tflops": 67.0, "hbm_tb_s": 3.35}
RATES = {"bf16": 989e12,              # bf16 x bf16: one BF16 MMA, f32 sums
         "bf16xf32": 989e12 / 3,      # f32 operand in three bf16 pieces
         "f32xf32": 495e12 / 3,       # 3xTF32: hi*hi' + hi*lo' + lo*hi'
         "fp32": 67e12}               # elementwise, bilinear: FP32 cores
PEAK_BYTES = 3.35e12                  # HBM3
# The peak a float32 model's FLOPs are held to: every product of these
# configurations is float32-accurate with TF32 off.
PEAK_F32 = RATES["f32xf32"]


def bound_s(nbytes: float, ops: Dict[str, float]) -> float:
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over their ``RATES``."""
    return max(nbytes / PEAK_BYTES,
               sum(n / RATES[kind] for kind, n in ops.items()))


def corr_positions(coords: torch.Tensor, level_hw: Sequence[Tuple[int, int]],
                   radius: int) -> int:
    """In-map (2r+2)^2 window positions over every (query, level) of
    ``coords`` [..., 2] (x, y) on the 1/8 grid: the dot products these
    coordinates need.  ``level_hw``: each pyramid level's (h, w)."""
    win = 2 * radius + 2
    offs = torch.arange(win, device=coords.device)
    total = 0
    for lvl, (h2, w2) in enumerate(level_hw):
        c = coords.reshape(-1, 2) / (2.0 ** lvl)
        ix0 = torch.floor(c[:, 0]).clamp(-1e8, 1e8).long() - radius
        iy0 = torch.floor(c[:, 1]).clamp(-1e8, 1e8).long() - radius
        nx = ((ix0[:, None] + offs >= 0) & (ix0[:, None] + offs < w2)).sum(1)
        ny = ((iy0[:, None] + offs >= 0) & (iy0[:, None] + offs < h2)).sum(1)
        total += int((nx * ny).sum())
    return total


def level_sizes(h: int, w: int, levels: int):
    """The pyramid's (h, w) per level from the 1/8 grid (floor pooling)."""
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = h // 2, w // 2
        out.append((h, w))
    return out


def lookup_bound_s(rows: int, h: int, w: int, channels: int, levels: int,
                   radius: int, positions: float) -> float:
    """One float32 lookup call over ``rows`` frames on an h x w grid:
    fmap1, every pyramid level and the coordinates read once, the
    windows written once; 2 FLOPs per channel of each in-map window
    position (``positions``, all rows together) as f32 x f32 products and
    7 FP32 FLOPs per bilinear output."""
    q = h * w
    n_out = rows * q * levels * (2 * radius + 1) ** 2
    level_px = sum(a * b for a, b in level_sizes(h, w, levels))
    nbytes = 4 * (rows * q * channels + rows * level_px * channels
                  + rows * q * 2 + n_out)
    return bound_s(nbytes, {"f32xf32": 2 * channels * positions,
                            "fp32": 7 * n_out})


def gru_ops(B: int, H: int, W: int, hid: int, mot: int) -> Dict[str, float]:
    """The operations of one float32 SepConvGRU call: each in-image tap of
    the 1x5 and the 5x1 pass multiplies [h, motion] by the z|r weights and
    [r*h, motion] by the q weights, plus ~20 elementwise FLOPs per output
    of each pass (the context terms are hoisted out of the loop)."""
    def per_axis(n):
        return sum(1 for x in range(n) for d in range(5) if 0 <= x + d - 2 < n)
    t1, t2 = B * per_axis(W) * H, B * per_axis(H) * W
    macs = hid * 2 * hid + mot * 2 * hid + hid * hid + mot * hid
    return {"f32xf32": 2 * (t1 + t2) * macs,
            "fp32": 20 * B * H * W * hid * 2}


def gru_bound_s(rows: int, h: int, w: int, hid: int, mot: int) -> float:
    """One float32 SepConvGRU call: h, motion and the two hoisted context
    terms read once, h written once, the fused weights read once."""
    q = rows * h * w
    weights = 2 * 5 * ((hid + mot) * 2 * hid + hid * hid + mot * hid)
    nbytes = 4 * (2 * q * hid + q * mot + 2 * q * 3 * hid + weights)
    return bound_s(nbytes, gru_ops(rows, h, w, hid, mot))


# -- model FLOPs -------------------------------------------------------------

def _conv(h: int, w: int, k, c_in: int, c_out: int, stride: int = 1):
    """(FLOPs, out h, out w) of one convolution with k//2 padding."""
    kh, kw = (k, k) if isinstance(k, int) else k
    ho = (h + 2 * (kh // 2) - kh) // stride + 1
    wo = (w + 2 * (kw // 2) - kw) // stride + 1
    return 2 * ho * wo * c_out * c_in * kh * kw, ho, wo


def encoder_flops(cfg: dict, H: int, W: int, out: int) -> int:
    small = bool(cfg["small"])
    stem, stages = (32, (32, 64, 96)) if small else (64, (64, 96, 128))
    f, h, w = _conv(H, W, 7, 3, stem, 2)
    c_in = stem
    for c, stride in zip(stages, (1, 2, 2)):
        for bi in range(2):
            s = stride if bi == 0 else 1
            cin = c_in if bi == 0 else c
            if small:
                mid = c // 4
                a, _, _ = _conv(h, w, 1, cin, mid)
                b, ho, wo = _conv(h, w, 3, mid, mid, s)
                e, _, _ = _conv(ho, wo, 1, mid, c)
                f += a + b + e
            else:
                a, ho, wo = _conv(h, w, 3, cin, c, s)
                b, _, _ = _conv(ho, wo, 3, c, c)
                f += a + b
            if s != 1:
                f += _conv(h, w, 1, cin, c, s)[0]
            h, w = ho, wo
        c_in = c
    return f + _conv(h, w, 1, c_in, out)[0]


def iteration_flops(cfg: dict, h: int, w: int) -> int:
    """One update-block call on the 1/8 grid h x w (one frame pair)."""
    hid, ctx = cfg["hidden_dim"], cfg["context_dim"]
    corr = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    c = lambda k, ci, co: _conv(h, w, k, ci, co)[0]  # noqa: E731
    if cfg["small"]:
        hx = hid + ctx + 82
        return (c(1, corr, 96) + c(7, 2, 64) + c(3, 64, 32) + c(3, 128, 80)
                + 3 * c(3, hx, hid) + c(3, hid, 128) + c(3, 128, 2))
    hx = hid + ctx + 128
    return (c(1, corr, 256) + c(3, 256, 192) + c(7, 2, 128) + c(3, 128, 64)
            + c(3, 256, 126) + 3 * c((1, 5), hx, hid) + 3 * c((5, 1), hx, hid)
            + c(3, hid, 256) + c(3, 256, 2) + c(3, hid, 256)
            + c(1, 256, 64 * 9))


def model_flops(cfg: dict, H: int, W: int, iters: int) -> int:
    """Convolution and matrix-product FLOPs of one frame pair at H x W:
    fnet on both frames, cnet on the first, the all-pairs volume
    (2 Q^2 C), and ``iters`` update-block calls."""
    fdim = 128 if cfg["small"] else 256
    h, w = H // 8, W // 8
    q = h * w
    return (2 * encoder_flops(cfg, H, W, fdim)
            + encoder_flops(cfg, H, W, cfg["hidden_dim"] + cfg["context_dim"])
            + 2 * q * q * fdim + iters * iteration_flops(cfg, h, w))
