"""2-D convolution helpers.

The public functions keep the JAX package's layout (NHWC activations, HWIO
kernels, symmetric ``k//2`` padding) so tests compare like with like.  The
modules of the port hold ``nn.Conv2d`` weights (OIHW) and convolve
``channels_last`` NCHW tensors, which are NHWC in memory: the kernels read a
contiguous channel vector per pixel and the two layouts convert by a
``permute`` view, without a copy.

A bfloat16 conv adds its bias as the JAX package's ``conv2d`` does: the
conv's output is rounded to bfloat16 first, then the bias is added in
bfloat16 (two roundings).  ``F.conv2d`` with a bias would round once, after
the add, on the CPU.  On the GPU the bias is a separate add after cuDNN's
conv either way, so the launches are the same.  Float32 convs keep
``F.conv2d``'s bias.

Inside an active ``ops/spmd.py::spatial_sharding`` context the activations
are row slabs: :func:`conv_nchw` takes its H padding from a halo exchange
with the neighbouring ranks instead of zeros (the JAX package's
``conv2d``), so a row-sharded model convolves as the unsharded one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import spmd

KernelSize = Union[int, Tuple[int, int]]


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view (copies only if ``x`` is not
    ``channels_last`` already)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC tensor -> ``channels_last`` NCHW view (no copy)."""
    return x.permute(0, 3, 1, 2)


def conv_nchw(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              stride: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` with OIHW ``w`` and symmetric ``k//2``
    padding; a bfloat16 conv's bias is added after its output is rounded
    (the module docstring); row-sharded, the H padding is a halo."""
    kh = w.shape[2]
    pad = (kh // 2, w.shape[3] // 2)
    if kh > 1 and spmd.spatial_axis() is not None:
        # exchanged as NHWC rows, so a channels_last slab stays one
        x = to_nchw(spmd.halo_exchange(to_nhwc(x), kh // 2, dim=1))
        pad = (0, pad[1])
    if b is None or w.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, stride=stride, padding=pad)
    return F.conv2d(x, w, None, stride=stride, padding=pad).add_(b[:, None, None])


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose forward is :func:`conv_nchw`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nchw(x, self.weight, self.bias, self.stride[0])


def make_conv(k: KernelSize, c_in: int, c_out: int, stride: int = 1,
              bias: bool = True) -> Conv2d:
    """A :class:`Conv2d` with the JAX package's symmetric ``k//2`` padding."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return Conv2d(c_in, c_out, (kh, kw), stride=stride,
                  padding=(kh // 2, kw // 2), bias=bias)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Kaiming-normal (fan_out, relu) init in place, zero bias — the JAX
    package's ``init_conv`` scheme, drawn from ``generator``."""
    c_out, _, kh, kw = conv.weight.shape
    std = math.sqrt(2.0 / (kh * kw * c_out))
    with torch.no_grad():
        w = torch.randn(conv.weight.shape, generator=generator,
                        dtype=torch.float32) * std
        conv.weight.copy_(w)
        if conv.bias is not None:
            conv.bias.zero_()


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] NHWC; w [kh, kw, Cin, Cout] HWIO; b [Cout] or None.
    Symmetric ``k//2`` zero padding, as the JAX package's ``conv2d``."""
    return to_nhwc(conv_nchw(to_nchw(x), w.permute(3, 2, 0, 1), b, stride))


def apply_conv_fused(weights: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]],
                     x: torch.Tensor, stride: int = 1) -> Tuple[torch.Tensor, ...]:
    """Several same-input, same-kernel-size convolutions (OIHW ``weights``,
    ``biases`` each a tensor or None) as ONE conv on an NCHW ``x``: the
    output channels are concatenated (exact), and the per-conv slices come
    back in order."""
    w = torch.cat(list(weights), dim=0)
    fuse_bias = all(b is not None for b in biases)
    out = conv_nchw(x, w, torch.cat(list(biases)) if fuse_bias else None,
                    stride)
    pieces, start = [], 0
    for wi, bi in zip(weights, biases):
        piece = out[:, start:start + wi.shape[0]]
        if not fuse_bias and bi is not None:
            piece = piece + bi[:, None, None]
        pieces.append(piece)
        start += wi.shape[0]
    return tuple(pieces)


def avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling, stride 2, VALID padding, of NHWC ``x``: odd
    sizes floor (54 -> 27 -> 13 -> 6) and a size below 2 pools to 0."""
    B, H, W, C = x.shape
    h, w = H // 2, W // 2
    x = x[:, :2 * h, :2 * w].reshape(B, h, 2, w, 2, C)
    return x.sum(dim=(2, 4)) / 4.0
