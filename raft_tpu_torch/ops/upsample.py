"""Learned convex upsampling of flow fields (NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_stack_3x3(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 9, C]: zero-padded 3x3 neighbourhoods, tap
    order row-major (dy, dx), as ``F.unfold`` and the JAX package."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=3)


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor,
                         factor: int = 8) -> torch.Tensor:
    """Upsample [B, H, W, 2] flow to [B, 8H, 8W, 2] with convex weights.

    mask: [B, H, W, 9 * factor**2] raw logits, channels factored (k, r, c)
    with k the 3x3 tap; the softmax runs over k, and flow values are scaled
    by ``factor``.  The combination is an elementwise product and a sum (no
    matmul), so it stays true float32 whatever the TF32 flags say.
    """
    B, H, W, _ = flow.shape
    f = factor
    m = torch.softmax(mask.reshape(B, H, W, 9, f, f), dim=3)
    patches = _shift_stack_3x3(float(f) * flow)           # [B, H, W, 9, 2]
    up = (m[..., None] * patches[:, :, :, :, None, None, :]).sum(dim=3)
    up = up.permute(0, 1, 3, 2, 4, 5)                     # [B, H, f, W, f, 2]
    return up.reshape(B, H * f, W * f, 2)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """The small model's upsampling: [B, H, W, 2] -> [B, 8H, 8W, 2], the
    align-corners bilinear resize by 8 with the flow values scaled by 8
    (the JAX package's ``upflow8(rescale=True)``).  JAX forms the resize as
    two products with interpolation matrices; this port calls
    ``F.interpolate(mode='bilinear', align_corners=True)``, elementwise
    float32 arithmetic (the same two-tap weights, summed in another order),
    so no TF32 switch can reach it."""
    B, H, W, _ = flow.shape
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(8 * H, 8 * W),
                       mode="bilinear", align_corners=True)
    return 8.0 * up.permute(0, 2, 3, 1)
