"""Normalization layers, on NCHW tensors.

``instance_norm`` is affine-free with the biased variance; ``batch_norm``
uses the running statistics and ``batch_norm_train`` the batch's.  All use
eps 1e-5 and the JAX package's formula ``(x - mean) * rsqrt(var + eps)``.
On bfloat16 tensors the eval-mode norms run in bfloat16 as the JAX
package's do: instance-norm statistics are accumulated in float32 and
rounded to bfloat16 (as ``jnp.mean`` / ``jnp.var`` return them), then
applied in bfloat16; batch norm takes the module's (bfloat16) running
statistics.

Training-mode batch norm (:class:`BatchNorm` with ``batch_stats`` set,
which ``models/raft.py::bn_training`` does for a training forward, whatever
``nn.Module.train()`` says) is the JAX package's ``batch_norm(train=True)``: it normalizes with the batch's
biased variance, computed as ``E[x^2] - mean^2`` (not two-pass), and moves
the running statistics by momentum 0.1 towards the batch mean and the
**unbiased** variance ``var * n / (n - 1)``.  That is not
``nn.BatchNorm2d``'s update, whose defaults are close; the port holds
JAX's formula.  In eval mode (``freeze_bn``) the running statistics are
used and left untouched, and the affine parameters still get gradients.
"""

from __future__ import annotations

import torch
import torch.nn as nn

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W of NCHW ``x``; the
    statistics in float32, rounded to ``x``'s dtype before they apply."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """Eval-mode batch norm of NCHW ``x`` with running statistics."""
    def c(t):
        return t[None, :, None, None]
    return (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(gamma) + c(beta)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = EPS):
    """Training-mode batch norm of NCHW ``x``: returns the output and the
    batch statistics ``(mean, var_unbiased)`` [C] for the running update."""
    def c(t):
        return t[None, :, None, None]
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean = x.mean(dim=(0, 2, 3))
    mean2 = torch.square(x).mean(dim=(0, 2, 3))
    var = mean2 - torch.square(mean)
    out = (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(gamma) + c(beta)
    # n / max(n - 1, 1) in float32, as the JAX package computes it
    nf = torch.tensor(float(n), dtype=torch.float32)
    ratio = nf / torch.clamp(nf - 1.0, min=1.0)
    return out, (mean, var * ratio.to(var.device))


class InstanceNorm(nn.Module):
    """Affine-free instance norm: no parameters, no state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class BatchNorm(nn.Module):
    """Batch norm whose state dict holds exactly ``weight``, ``bias``,
    ``running_mean`` and ``running_var`` — the four leaves the JAX tree
    carries (``gamma``, ``beta``, ``mean``, ``var``).  It uses the running
    statistics unless ``batch_stats`` is set; then the batch's, and it
    updates the running statistics in place.  ``batch_stats`` is the JAX
    package's ``train`` argument, separate from ``nn.Module.training``, so
    no inference entry depends on the module's mode."""

    momentum = 0.1
    batch_stats = False

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.batch_stats:
            return batch_norm(x, self.running_mean, self.running_var,
                              self.weight, self.bias)
        out, (mean, var) = batch_norm_train(x, self.weight, self.bias)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        return out
