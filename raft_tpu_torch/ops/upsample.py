"""Learned convex upsampling of flow fields (NHWC), and the small model's
bilinear one.

Row-sharded (``ops/spmd.py::spatial_sharding`` active), the 3x3
neighbourhoods take their H padding from a one-row halo exchange, and
:func:`upflow8` interpolates rows at this slab's global offset (the JAX
package's ``_interp_rows_sharded``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import spmd


def _shift_stack_3x3(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 9, C]: zero-padded 3x3 neighbourhoods, tap
    order row-major (dy, dx), as ``F.unfold`` and the JAX package.
    Row-sharded, the H padding rows come from the neighbouring slabs."""
    B, H, W, C = x.shape
    if spmd.spatial_axis() is not None:
        xp = F.pad(spmd.halo_exchange(x, 1, dim=1), (0, 0, 1, 1))
    else:
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
    so no TF32 switch can reach it.  Row-sharded, it runs
    :func:`upflow8_sharded`."""
    B, H, W, _ = flow.shape
    if spmd.spatial_axis() is not None:
        return upflow8_sharded(flow, spmd.spatial_axis())
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(8 * H, 8 * W),
                       mode="bilinear", align_corners=True)
    return 8.0 * up.permute(0, 2, 3, 1)


def _two_taps(pos: torch.Tensor, n: int):
    """The align-corners taps of float32 positions ``pos`` in an input of
    ``n`` samples: ``(i0, i1, f)``, the value ``(1 - f) * x[i0] + f *
    x[i1]`` (the JAX package's ``_interp_matrix``: ``i0`` clipped to
    ``n - 2``)."""
    i0 = torch.floor(pos).clamp(0, max(n - 2, 0))
    f = pos - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), f


def upflow8_sharded(flow: torch.Tensor, axis: spmd.Axis) -> torch.Tensor:
    """:func:`upflow8` of a row slab [B, h, W, 2] of a flow whose global
    height is ``h * axis.size``: the output slab [B, 8h, 8W, 2].  The rows
    are interpolated at their global positions against this slab and a
    one-row halo each side (the JAX package's ``_interp_rows_sharded``:
    every source row of the slab's outputs lies inside it), then the
    columns; each output is its two taps' weighted sum, in float32."""
    B, h, W, _ = flow.shape
    f8 = 8
    hg = h * axis.size
    dev = flow.device
    xp = spmd.halo_exchange(flow.float(), 1, axis, dim=1)       # [B,h+2,W,2]
    scale = (hg - 1) / (hg * f8 - 1)
    o = (torch.arange(h * f8, dtype=torch.float32, device=dev)
         + float(axis.index * h * f8))
    pos = o * scale
    i0 = torch.floor(pos)
    fy = (pos - i0)[None, :, None, None]
    r0 = i0.long() - axis.index * h + 1                          # halo offset
    rows = (1.0 - fy) * xp[:, r0] + fy * xp[:, r0 + 1]           # [B,8h,W,2]
    if W == 1:
        cpos = torch.zeros(W * f8, dtype=torch.float32, device=dev)
    else:
        cpos = (torch.arange(W * f8, dtype=torch.float32, device=dev)
                * ((W - 1) / (W * f8 - 1)))
    c0, c1, fx = _two_taps(cpos, W)
    fx = fx[None, None, :, None]
    up = (1.0 - fx) * rows[:, :, c0] + fx * rows[:, :, c1]
    return 8.0 * up
