"""Correlation pyramid and the plain windowed lookup (NHWC).

Semantics (those of the JAX package's ``ops/corr.py``):
``corr[b, q, p] = <fmap1[b, q], fmap2_l[b, p]> / sqrt(C)`` against the
2x2-average-pooled fmap2 of level ``l``, sampled bilinearly on a
``(2r+1)^2`` window centred at ``coords / 2^l`` with zeros outside the map,
channels ordered (level, x-offset, y-offset): the window is
**x-offset-major**.

:func:`lookup_blockwise_onehot` is the plain PyTorch version of the CUDA
lookup kernel (``ops/corr_cuda.py``): per query chunk and level one
``[T, P]`` correlation tile, then the separable one-hot window lookup, as
two small matmuls.  It never builds the ``(HW)^2`` volume.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .conv import avg_pool2d


def fmap2_pyramid(fmap2: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """[B, H, W, C] -> ``num_levels`` pooled maps (level 0 = input)."""
    levels = [fmap2]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2d(levels[-1]))
    return levels


def corr_scale(c: int) -> float:
    """``1/sqrt(C)`` rounded to float32, as the JAX package computes it."""
    return float(torch.rsqrt(torch.tensor(float(c), dtype=torch.float32)))


def _onehot_interp(idx0: torch.Tensor, frac: torch.Tensor, n: int, size: int,
                   offset: int = 0) -> torch.Tensor:
    """Separable bilinear selection matrix A [B, Q, n, size]:
    ``A[b,q,j,p] = (1-frac)*[p+offset == idx0+j] + frac*[p+offset == idx0+j+1]``.
    Out-of-range indices never match: zeros padding."""
    dev = idx0.device
    ids = torch.arange(size, device=dev)[None, None, None, :] + offset
    tgt = idx0[:, :, None, None] + torch.arange(n, device=dev)[None, None, :, None]
    f = frac[:, :, None, None]
    zero = torch.zeros((), dtype=frac.dtype, device=dev)
    return (torch.where(ids == tgt, 1.0 - f, zero)
            + torch.where(ids == tgt + 1, f, zero))


def lookup_partial_onehot(corr3: torch.Tensor, coords: torch.Tensor,
                          radius: int, level: int,
                          row_offset: int = 0) -> torch.Tensor:
    """Window lookup on a (possibly row-partial) correlation plane.

    corr3 [B, Q, Hblk, W2] against rows ``[row_offset, row_offset + Hblk)``
    of the level-``level`` plane; coords [B, Q, 2] full-resolution (x, y).
    Returns [B, Q, (2r+1)^2], x-offset-major.
    """
    B, Q, Hblk, W2 = corr3.shape
    n = 2 * radius + 1
    c = coords / (2.0 ** level)
    cx, cy = c[..., 0], c[..., 1]
    cx0 = torch.floor(cx)
    cy0 = torch.floor(cy)
    a_y = _onehot_interp(cy0.long() - radius, cy - cy0, n, Hblk,
                         offset=row_offset)                     # [B,Q,n,Hblk]
    a_x = _onehot_interp(cx0.long() - radius, cx - cx0, n, W2)  # [B,Q,n,W2]
    win_y = torch.matmul(a_y, corr3)                            # [B,Q,n(y),W2]
    win = torch.matmul(a_x, win_y.transpose(-1, -2))            # [B,Q,n(x),n(y)]
    return win.reshape(B, Q, n * n)


def lookup_blockwise_onehot(fmap1: torch.Tensor,
                            f2_levels: Sequence[torch.Tensor],
                            coords: torch.Tensor, radius: int,
                            chunk: int = 512) -> torch.Tensor:
    """fmap1 [B, H, W, C], f2_levels [B, H/2^l, W/2^l, C], coords
    [B, H, W, 2] -> [B, H, W, L*(2r+1)^2], all float32."""
    B, H, W, C = fmap1.shape
    Q = H * W
    f1 = fmap1.reshape(B, Q, C)
    flat = coords.reshape(B, Q, 2)
    scale = corr_scale(C)
    outs = []
    for s in range(0, Q, chunk):
        f1c, cc = f1[:, s:s + chunk], flat[:, s:s + chunk]
        T = f1c.shape[1]
        per_level = []
        for i, f2 in enumerate(f2_levels):
            _, H2, W2, _ = f2.shape
            corr = torch.matmul(f1c, f2.reshape(B, H2 * W2, C).transpose(1, 2))
            per_level.append(lookup_partial_onehot(
                (corr * scale).reshape(B, T, H2, W2), cc, radius, i))
        outs.append(torch.cat(per_level, dim=-1))
    return torch.cat(outs, dim=1).reshape(B, H, W, -1)
