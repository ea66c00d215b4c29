"""Seeded frame pairs, made on the device in a few large calls.

Each pair is a smooth random texture (four octaves of uniform noise,
bilinearly upsampled and summed) and the same texture warped backward by
a smooth random flow (a global translation plus a low-frequency field),
with a little per-frame noise.  The flow is the pair's ground truth for
training; ``valid`` marks the pixels whose source lies inside frame 1.
The traffic file's ``motion`` sets the translation's and the field's
standard deviations in pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

OCTAVES = ((64, 1.0), (16, 0.5), (4, 0.25), (1, 0.125))   # (cell px, weight)


def _up(noise: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return F.interpolate(noise, size=(H, W), mode="bilinear",
                         align_corners=False)


def make_pairs(n: int, H: int, W: int, seed: int, device, motion: dict
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """``n`` pairs at H x W: image1, image2 [n, H, W, 3] float32 in [0, 1],
    flow [n, H, W, 2] (x, y) and valid [n, H, W] float32 (0 or 1)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + 1) % 2 ** 63)
    tex = 0.0
    for cell, weight in OCTAVES:
        noise = torch.rand((n, 3, -(-H // cell) + 1, -(-W // cell) + 1),
                           generator=gen, device=device)
        tex = tex + weight * _up(noise, H, W)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    tex = (tex - lo) / (hi - lo)
    field = torch.randn((n, 2, -(-H // 128) + 1, -(-W // 128) + 1),
                        generator=gen, device=device)
    shift = torch.randn((n, 2, 1, 1), generator=gen, device=device)
    flow = (motion["field_px"] * _up(field, H, W)
            + motion["translation_px"] * shift)               # [n, 2, H, W]
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    src_x = xs - flow[:, 0]
    src_y = ys - flow[:, 1]
    grid = torch.stack([2 * src_x / (W - 1) - 1, 2 * src_y / (H - 1) - 1], -1)
    warped = F.grid_sample(tex, grid, mode="bilinear", padding_mode="border",
                           align_corners=True)
    valid = ((src_x >= 0) & (src_x <= W - 1) & (src_y >= 0)
             & (src_y <= H - 1)).float()
    grain = torch.randn((2, n, 3, H, W), generator=gen, device=device)
    im1 = (tex + motion["noise"] * grain[0]).clamp(0, 1)
    im2 = (warped + motion["noise"] * grain[1]).clamp(0, 1)
    return (im1.permute(0, 2, 3, 1).contiguous(),
            im2.permute(0, 2, 3, 1).contiguous(),
            flow.permute(0, 2, 3, 1).contiguous(), valid)
