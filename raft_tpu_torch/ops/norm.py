"""Normalization layers (eval mode), on NCHW tensors.

``instance_norm`` is affine-free with the biased variance; ``batch_norm``
uses the running statistics.  Both use eps 1e-5 and the JAX package's
formula ``(x - mean) * rsqrt(var + eps)``.  Training-mode batch norm waits
for ROADMAP Queue A item 7.
"""

from __future__ import annotations

import torch
import torch.nn as nn

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W of NCHW ``x``."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """Eval-mode batch norm of NCHW ``x`` with running statistics."""
    def c(t):
        return t[None, :, None, None]
    return (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(gamma) + c(beta)


class InstanceNorm(nn.Module):
    """Affine-free instance norm: no parameters, no state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class BatchNorm(nn.Module):
    """Eval-mode batch norm whose state dict holds exactly ``weight``,
    ``bias``, ``running_mean`` and ``running_var`` — the four leaves the
    JAX tree carries (``gamma``, ``beta``, ``mean``, ``var``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.running_mean, self.running_var,
                          self.weight, self.bias)
