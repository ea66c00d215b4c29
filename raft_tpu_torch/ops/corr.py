"""Correlation pyramid and the plain windowed lookup (NHWC).

Semantics (those of the JAX package's ``ops/corr.py``):
``corr[b, q, p] = <fmap1[b, q], fmap2_l[b, p]> / sqrt(C)`` against the
2x2-average-pooled fmap2 of level ``l``, sampled bilinearly on a
``(2r+1)^2`` window centred at ``coords / 2^l`` with zeros outside the map,
channels ordered (level, x-offset, y-offset): the window is
**x-offset-major**.

The plain PyTorch versions of the CUDA lookup kernels (``ops/corr_cuda.py``),
none of which builds the ``(HW)^2`` volume:

* :func:`lookup_blockwise_onehot` (``corr_lookup.cu``): per query chunk and
  level one ``[T, P]`` correlation tile, then the separable one-hot window
  lookup, as two small matmuls;
* :func:`lookup_window_plain` (``corr_window_f32``): the same, correlating
  each chunk only against the rows its windows touch (the window schedule);
* :func:`lookup_ragged_plain` (``corr_ragged_f32``): mixed-resolution items
  in one max box (:func:`mask_ragged_rows`, :func:`ragged_pyramid`), dead
  queries exact zeros.
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


def live_mask(sizes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H, W] bool: inside item b's corner-anchored ``sizes[b] = (h, w)``
    crop of an ``H x W`` max box."""
    sizes = sizes.to(torch.int32)
    iy = torch.arange(H, device=sizes.device)[None, :, None]
    ix = torch.arange(W, device=sizes.device)[None, None, :]
    return (iy < sizes[:, 0, None, None]) & (ix < sizes[:, 1, None, None])


def mask_ragged_rows(x: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Zero everything outside each item's live crop of a shared max box.
    x [B, H, W, ...] with every item corner-anchored at (0, 0); sizes
    [B, 2] integer per-item (h, w) live extents.  Dtype-preserving."""
    B, H, W = x.shape[:3]
    live = live_mask(sizes, H, W).reshape((B, H, W) + (1,) * (x.dim() - 3))
    return torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))


def ragged_pyramid(fmap2: torch.Tensor, sizes: torch.Tensor,
                   num_levels: int = 4) -> List[torch.Tensor]:
    """Ragged twin of :func:`fmap2_pyramid` for items in one max box: mask
    level 0 at ``sizes``, then per level pool and mask at the floor-halved
    extents.  At an odd live extent the boundary window mixes a live row
    with a dead one, and that window is exactly the first index the next
    mask kills, so each level equals the crop's own pyramid embedded with
    zeros outside.  Pooling first and masking once would not."""
    sizes = sizes.to(torch.int32)
    levels = [mask_ragged_rows(fmap2, sizes)]
    for _ in range(num_levels - 1):
        sizes = sizes // 2
        levels.append(mask_ragged_rows(avg_pool2d(levels[-1]), sizes))
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


def lookup_window_plain(fmap1: torch.Tensor,
                        f2_levels: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        chunk: int = 512) -> torch.Tensor:
    """The window-scheduled lookup, shapes and values as
    :func:`lookup_blockwise_onehot`.  Per (item, query chunk, level) the
    schedule is the row range ``[min(iy0), max(iy0) + 2r + 1]`` of the
    chunk's windows (``iy0 = floor(cy / 2^l) - r``) clipped to the map; a
    chunk whose windows miss the map gives zeros, the others correlate
    against those rows only."""
    B, H, W, C = fmap1.shape
    Q = H * W
    n = 2 * radius + 1
    f1 = fmap1.reshape(B, Q, C)
    flat = coords.reshape(B, Q, 2)
    scale = corr_scale(C)
    out = fmap1.new_zeros((B, Q, len(f2_levels), n * n))
    for lvl, f2 in enumerate(f2_levels):
        _, H2, W2, _ = f2.shape
        iy0 = (torch.floor(flat[..., 1] / (2.0 ** lvl)) - radius).nan_to_num(
            1e8).clamp(-1e8, 1e8)
        for b in range(B):
            for s in range(0, Q, chunk):
                lo = int(iy0[b, s:s + chunk].min())
                hi = int(iy0[b, s:s + chunk].max()) + n    # last row, inclusive
                if H2 == 0 or W2 == 0 or hi < 0 or lo >= H2:
                    continue
                r0, r1 = max(lo, 0), min(hi, H2 - 1)
                f1c, cc = f1[b:b + 1, s:s + chunk], flat[b:b + 1, s:s + chunk]
                rows = f2[b:b + 1, r0:r1 + 1].reshape(1, -1, C)
                corr = torch.matmul(f1c, rows.transpose(1, 2)) * scale
                out[b:b + 1, s:s + chunk, lvl] = lookup_partial_onehot(
                    corr.reshape(1, f1c.shape[1], r1 - r0 + 1, W2), cc,
                    radius, lvl, row_offset=r0)
    return out.reshape(B, H, W, -1)


def lookup_ragged_plain(fmap1: torch.Tensor,
                        f2_levels: Sequence[torch.Tensor],
                        coords: torch.Tensor, sizes8: torch.Tensor,
                        radius: int, chunk: int = 512) -> torch.Tensor:
    """The ragged lookup: fmap1 [B, H, W, C] masked by
    :func:`mask_ragged_rows` and f2_levels by :func:`ragged_pyramid` at
    ``sizes8`` [B, 2] (live (h, w) per item at the query grid), coords
    [B, H, W, 2] -> [B, H, W, L*(2r+1)^2].  On each item's live crop the
    values equal the crop's own lookup; dead queries are exact zeros."""
    B, H, W, _ = fmap1.shape
    out = lookup_blockwise_onehot(fmap1, f2_levels, coords, radius, chunk)
    live = live_mask(sizes8.to(out.device), H, W)[..., None]
    return torch.where(live, out, torch.zeros((), device=out.device))
