"""The feature / context encoders, NCHW: ``BasicEncoder`` (raft-things,
residual blocks) and ``SmallEncoder`` (raft-small, bottleneck blocks).

Module names mirror the JAX parameter tree (``layer1.0.conv1``, ...), so
``state_dict`` keys are the JAX paths.  fnet uses affine-free instance
norm; cnet eval-mode batch norm (full) or no norm at all (small), which
holds no leaves, as in the JAX tree.  The strided block's shortcut norm is
registered once, as ``downsample.1`` (official RAFT also registers it as
``norm3`` in the residual block; the JAX tree, and so this port, does
not).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import make_conv
from ..ops.norm import BatchNorm, InstanceNorm

_BASIC_DIMS = (64, 64, 96, 128)     # stem, layer1..3
_SMALL_DIMS = (32, 32, 64, 96)


def _norm(norm_fn: str, c: int) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "batch":
        return BatchNorm(c)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"norm_fn must be 'instance', 'batch' or 'none', "
                     f"got {norm_fn!r}")


def _shortcut(c_in: int, c_out: int, norm_fn: str, stride: int):
    if stride == 1:
        return None
    return nn.Sequential(make_conv(1, c_in, c_out, stride=stride),
                         _norm(norm_fn, c_out))


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, norm_fn: str, stride: int):
        super().__init__()
        self.conv1 = make_conv(3, c_in, c_out, stride=stride)
        self.conv2 = make_conv(3, c_out, c_out)
        self.norm1 = _norm(norm_fn, c_out)
        self.norm2 = _norm(norm_fn, c_out)
        self.downsample = _shortcut(c_in, c_out, norm_fn, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + y)


class BottleneckBlock(nn.Module):
    """1x1 down to ``c_out // 4``, the strided 3x3, 1x1 up to ``c_out``."""

    def __init__(self, c_in: int, c_out: int, norm_fn: str, stride: int):
        super().__init__()
        mid = c_out // 4
        self.conv1 = make_conv(1, c_in, mid)
        self.conv2 = make_conv(3, mid, mid, stride=stride)
        self.conv3 = make_conv(1, mid, c_out)
        self.norm1 = _norm(norm_fn, mid)
        self.norm2 = _norm(norm_fn, mid)
        self.norm3 = _norm(norm_fn, c_out)
        self.downsample = _shortcut(c_in, c_out, norm_fn, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + y)


class BasicEncoder(nn.Module):
    """[B, 3, H, W] -> [B, output_dim, H/8, W/8]."""

    dims = _BASIC_DIMS
    block = ResidualBlock

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        dims = self.dims
        self.conv1 = make_conv(7, 3, dims[0], stride=2)
        self.norm1 = _norm(norm_fn, dims[0])
        c_in = dims[0]
        for li, (dim, stride) in enumerate(zip(dims[1:], (1, 2, 2)), start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                self.block(c_in, dim, norm_fn, stride),
                self.block(dim, dim, norm_fn, 1)))
            c_in = dim
        self.conv2 = make_conv(1, c_in, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.layer3(self.layer2(self.layer1(y)))
        return self.conv2(y)


class SmallEncoder(BasicEncoder):
    """The raft-small encoder: :class:`BasicEncoder`'s plan with narrower
    stages (32, 32, 64, 96) of bottleneck blocks."""

    dims = _SMALL_DIMS
    block = BottleneckBlock
