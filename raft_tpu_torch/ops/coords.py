"""Pixel-coordinate grids."""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 2] pixel-coordinate grid, last axis (x, y)."""
    ys = torch.arange(ht, device=device, dtype=dtype)
    xs = torch.arange(wd, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                 # [H, W, 2] (x, y)
    return grid[None].expand(batch, ht, wd, 2).contiguous()
