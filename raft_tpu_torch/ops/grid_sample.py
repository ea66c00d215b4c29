"""Bilinear grid sampling in pixel coordinates (NHWC), the port's copy of
the JAX package's ``ops/grid_sample.py``, as thin conversions around
``F.grid_sample(mode='bilinear')``.

Pixel (0, 0) is the centre of the top-left input pixel, the convention of
``F.grid_sample(..., align_corners=True)`` after unnormalizing its grid:
:func:`grid_sample_normalized` with ``align_corners=True`` (or False) is
``F.grid_sample`` with the same flag (``tests/test_torch_port_ondemand.py``
shows it against the JAX package at 1e-5).  ``padding_mode='zeros'``: an
out-of-range corner contributes 0; ``'border'``: coordinates are clamped to
the image first.

:func:`grid_sample` maps pixel coordinates to ``F.grid_sample``'s grid with
the ``align_corners=False`` normalization, ``(2x + 1) / W - 1``, which
unnormalizes back to ``x`` for every ``W >= 1``; the ``align_corners=True``
one divides by ``W - 1`` and sends every coordinate of a one-pixel axis
(a coarse pyramid level) to that pixel, where zero padding wants 0 off it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..lint.contracts import contract


def _sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str,
            align_corners: bool) -> torch.Tensor:
    """``F.grid_sample`` of NHWC ``img`` at ``grid`` [B, ..., 2] in
    [-1, 1] -> [B, ..., C] float32."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    B, H, W, C = img.shape
    out_shape = tuple(grid.shape[:-1]) + (C,)
    if H == 0 or W == 0:                     # every corner is off the image
        return img.new_zeros(out_shape, dtype=torch.float32)
    out = F.grid_sample(img.float().permute(0, 3, 1, 2),
                        grid.float().reshape(B, 1, -1, 2), mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out[:, :, 0].transpose(1, 2).reshape(out_shape)


@contract(img="*[B,H,W,C]", coords="*[B,...,2]", _returns="*[B,...,C]")
def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] bilinearly at pixel coordinates
    ``coords`` [B, ..., 2] (x, y) -> [B, ..., C], float32."""
    B, H, W, C = img.shape
    size = torch.tensor([W, H], dtype=torch.float32, device=coords.device)
    return _sample(img, (2.0 * coords.float() + 1.0) / size - 1.0,
                   padding_mode, align_corners=False)


@contract(img="*[B,H,W,C]", grid="*[B,...,2]", _returns="*[B,...,C]")
def grid_sample_normalized(img: torch.Tensor, grid: torch.Tensor,
                           padding_mode: str = "zeros",
                           align_corners: bool = True) -> torch.Tensor:
    """PyTorch's convention: ``grid`` [B, ..., 2] in [-1, 1], (x, y)."""
    return _sample(img, grid, padding_mode, align_corners)
