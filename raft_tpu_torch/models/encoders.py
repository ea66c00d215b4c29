"""The full model's feature / context encoder (``BasicEncoder``), NCHW.

Module names mirror the JAX parameter tree (``layer1.0.conv1``, ...), so
``state_dict`` keys are the JAX paths.  fnet uses affine-free instance
norm, cnet eval-mode batch norm.  The strided block's shortcut norm is
registered once, as ``downsample.1`` (official RAFT also registers it as
``norm3``; the JAX tree, and so this port, does not).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import make_conv
from ..ops.norm import BatchNorm, InstanceNorm

_BASIC_DIMS = (64, 64, 96, 128)     # stem, layer1..3


def _norm(norm_fn: str, c: int) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "batch":
        return BatchNorm(c)
    raise NotImplementedError(
        f"norm_fn={norm_fn!r} is not ported yet (the small variant's "
        f"encoders: ROADMAP Queue A item 6b)")


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, norm_fn: str, stride: int):
        super().__init__()
        self.conv1 = make_conv(3, c_in, c_out, stride=stride)
        self.conv2 = make_conv(3, c_out, c_out)
        self.norm1 = _norm(norm_fn, c_out)
        self.norm2 = _norm(norm_fn, c_out)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                make_conv(1, c_in, c_out, stride=stride), _norm(norm_fn, c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + y)


class BasicEncoder(nn.Module):
    """[B, 3, H, W] -> [B, output_dim, H/8, W/8]."""

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        dims = _BASIC_DIMS
        self.conv1 = make_conv(7, 3, dims[0], stride=2)
        self.norm1 = _norm(norm_fn, dims[0])
        c_in = dims[0]
        for li, (dim, stride) in enumerate(zip(dims[1:], (1, 2, 2)), start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                ResidualBlock(c_in, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            c_in = dim
        self.conv2 = make_conv(1, c_in, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.layer3(self.layer2(self.layer1(y)))
        return self.conv2(y)
