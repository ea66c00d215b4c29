"""Normalization layers, on NCHW tensors.

``instance_norm`` is affine-free with the biased variance; ``batch_norm``
uses the running statistics and ``batch_norm_train`` the batch's.  All use
eps 1e-5 and the JAX package's formula ``(x - mean) * rsqrt(var + eps)``.
On bfloat16 tensors the eval-mode norms run in bfloat16 as the JAX
package's do: instance-norm statistics are accumulated in float32 and
rounded to bfloat16 (as ``jnp.mean`` / ``jnp.var`` return them), then
applied in bfloat16; batch norm takes the module's running statistics
rounded to bfloat16 (bfloat16 already in a bfloat16 model; float32 master
buffers under a bfloat16 training forward, as the JAX package casts its
whole tree).

Training-mode batch norm (:class:`BatchNorm` with ``batch_stats`` set,
which ``models/raft.py::bn_training`` does for a training forward, whatever
``nn.Module.train()`` says) is the JAX package's ``batch_norm(train=True)``: it normalizes with the batch's
biased variance, computed as ``E[x^2] - mean^2`` (not two-pass), and moves
the running statistics by momentum 0.1 towards the batch mean and the
**unbiased** variance ``var * n / (n - 1)`` (in the JAX package's types:
the mean's update in the activations' dtype, the variance's in float32,
written back to the buffers, float32 masters under bfloat16 training).  That is not
``nn.BatchNorm2d``'s update, whose defaults are close; the port holds
JAX's formula.  In eval mode (``freeze_bn``) the running statistics are
used and left untouched, and the affine parameters still get gradients.

Two statistics are reduced across ranks, as the JAX package reduces them:

* row-sharded (``ops/spmd.py::spatial_sharding`` active), instance norm
  takes the mean over the ranks of the slabs' mean and ``E[x^2]``, and
  ``var = max(E[x^2] - mean^2, 0)`` (so a one-rank run is not bitwise the
  unsharded norm, whose variance is two-pass);
* data-parallel or row-sharded training (a data
  :class:`~raft_tpu_torch.ops.spmd.Axis`, or several, given to
  :func:`batch_norm_train`, which :class:`BatchNorm` passes from its
  ``sync_axis``; the active spatial axis joins them), the batch mean and
  ``E[x^2]`` are averaged over the ranks (synchronized batch norm) by
  ``spmd.pmean``, whose backward all-reduces the two statistics'
  cotangents, the transpose of JAX's ``pmean``.  ``nn.SyncBatchNorm`` is
  not used: it runs on CUDA only and its Welford statistics are not this
  formula.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from . import spmd

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W of NCHW ``x``; the
    statistics in float32, rounded to ``x``'s dtype before they apply.
    Row-sharded, the statistics of the whole image (the module
    docstring)."""
    xf = x.float()
    ax = spmd.spatial_axis()
    if ax is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
    else:
        # equal slabs: the mean of the slabs' means is the image's
        stats = spmd.pmean(torch.stack([xf.mean(dim=(2, 3)),
                                        xf.square().mean(dim=(2, 3))]), ax)
        mean = stats[0][:, :, None, None]
        # E[x^2] - mean^2 can cancel below 0 in float32: NaN via rsqrt
        var = (stats[1][:, :, None, None] - mean.square()).clamp_min(0.0)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """Eval-mode batch norm of NCHW ``x`` with running statistics."""
    def c(t):
        return t[None, :, None, None]
    return (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(gamma) + c(beta)


def _stat_axes(axis) -> list:
    """The axes a training batch norm's statistics are reduced over: the
    given data axis (or axes), and the active row-sharding axis, each with
    a group."""
    axes = [] if axis is None else (list(axis) if isinstance(
        axis, (list, tuple)) else [axis])
    sp = spmd.spatial_axis()
    if sp is not None and all(a is not sp for a in axes):
        axes.append(sp)
    return [a for a in axes if a.group is not None]


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = EPS,
                     axis=None):
    """Training-mode batch norm of NCHW ``x``: returns the output and the
    batch statistics ``(mean, var_unbiased)`` [C] for the running update,
    the mean in ``x``'s dtype and the unbiased variance in float32 (the
    JAX package's types: its biased variance times a float32 ratio).
    ``axis``: the data axis (or axes) of a data-parallel step; row-sharded,
    the active spatial axis joins them.  The statistics are then those of
    the whole batch over every rank, ``n`` counting every rank's pixels:
    the mean and ``E[x^2]`` averaged over the ranks by the differentiable
    ``spmd.pmean`` (equal shares: the mean of the means), whose transpose,
    the ``pmean`` of the cotangents, is JAX's."""
    def c(t):
        return t[None, :, None, None]
    n = x.shape[0] * x.shape[2] * x.shape[3]
    stats = torch.stack([x.mean(dim=(0, 2, 3)),
                         torch.square(x).mean(dim=(0, 2, 3))])
    for ax in _stat_axes(axis):
        stats = spmd.pmean(stats, ax)
        n *= ax.size
    mean, mean2 = stats[0], stats[1]
    var = mean2 - torch.square(mean)
    out = (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(gamma) + c(beta)
    # n / max(n - 1, 1) in float32, as the JAX package computes it, on the
    # host: a scalar of the shape, so a captured step holds no host copy
    ratio = float(np.float32(n) / np.float32(max(n - 1, 1)))
    return out, (mean, var.float() * ratio)


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
    sync_axis = None          # the data axis (or axes) of a parallel step

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the running statistics are read in x's dtype: under a bfloat16
        # training forward they stay float32 buffers (the master copy) and
        # are rounded for use, as the JAX package casts its whole tree
        mean_r = self.running_mean.to(x.dtype)
        var_r = self.running_var.to(x.dtype)
        if not self.batch_stats:
            return batch_norm(x, mean_r, var_r, self.weight, self.bias)
        out, (mean, var) = batch_norm_train(x, self.weight, self.bias,
                                            axis=self.sync_axis)
        m = self.momentum
        with torch.no_grad():
            # the JAX package's types: the mean's update in x's dtype, the
            # variance's in float32 (its unbiased batch variance is), both
            # written back to the buffers' dtype
            self.running_mean.copy_((1.0 - m) * mean_r + m * mean)
            self.running_var.copy_((1.0 - m) * var_r + m * var)
        return out
