"""The plain reference of a training step: RAFT's sequence loss, its
gradients and the optimizer's update, float32.

The recipe is the official one (``train.py`` of princeton-vl/RAFT):
``sequence_loss`` (gamma-weighted L1 of every iteration's upsampled flow,
invalid pixels and ground truth beyond ``max_flow`` masked, divided by
every pixel), the gradients' global norm clipped to ``clip_norm``, AdamW
with a one-cycle learning rate that rises linearly from ``lr / 25`` over
the first ``pct_start`` of the steps.  The update follows optax's order
of operations (the JAX package's optimizer, which the port mirrors):
``scale_by_adam`` with bias correction and ``eps`` outside the root, the
decoupled decay ``+ weight_decay * p``, then ``-lr``; the clipping keeps a
gradient whose norm is below the bound and scales it to the bound
otherwise.  Everything here is written from that description and reads
only the state dict and batches it is given.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import raft as ref

B1, B2 = 0.9, 0.999


def sequence_loss(flows: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float, max_flow: float) -> torch.Tensor:
    """flows [n, B, H, W, 2], gt [B, H, W, 2], valid [B, H, W]."""
    n = flows.shape[0]
    mask = (valid >= 0.5) & (gt.square().sum(-1).sqrt() < max_flow)
    loss = flows.new_zeros(())
    for i in range(n):
        err = (flows[i] - gt).abs().mean(-1)
        loss = loss + gamma ** (n - i - 1) * (err * mask).sum() / mask.numel()
    return loss


def learning_rate(count: int, tc: dict) -> float:
    """The one-cycle schedule at the optimizer's ``count`` (0 first)."""
    warm = max(int(tc["num_steps"] * tc["pct_start"]), 1)
    lo = tc["lr"] / 25.0
    if count < warm:
        return lo + (tc["lr"] - lo) * count / warm
    final = lo / 1e4
    down = max(tc["num_steps"] - warm, 1)
    return tc["lr"] + (final - tc["lr"]) * min(count - warm, down) / down


def trainable(names: Sequence[str]) -> List[str]:
    return [n for n in names
            if not n.endswith(("running_mean", "running_var"))]


def train_steps(sd: Dict[str, torch.Tensor], cfg: dict, tc: dict, batches,
                coords_out: list = None):
    """Run ``len(batches)`` steps from ``sd``.  Returns per step the loss,
    the first step's gradient per parameter as the optimizer takes it
    (after clipping), and each parameter's change over all the steps.
    ``coords_out`` gets the first forward's lookup coordinates."""
    names = trainable(list(sd))
    params = {n: sd[n].detach().clone().requires_grad_(True) for n in names}
    fixed = {n: v for n, v in sd.items() if n not in params}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first_grad = [], None
    for count, (im1, im2, gt, valid) in enumerate(batches):
        flows = ref.forward({**fixed, **params}, cfg, im1, im2, cfg["iters"],
                            train=True, all_flows=True,
                            coords_out=coords_out if count == 0 else None)
        loss = sequence_loss(flows, gt, valid, tc["gamma"], tc["max_flow"])
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if not bool(norm < tc["clip_norm"]):
                grads = [g / norm * tc["clip_norm"] for g in grads]
            if first_grad is None:
                first_grad = {n: g.clone() for n, g in zip(names, grads)}
            lr = learning_rate(count, tc)
            t = count + 1
            for n, g in zip(names, grads):
                mu[n] = B1 * mu[n] + (1 - B1) * g
                nu[n] = B2 * nu[n] + (1 - B2) * g.square()
                u = (mu[n] / (1 - B1 ** t)) / (
                    torch.sqrt(nu[n] / (1 - B2 ** t)) + tc["adamw_eps"])
                u = u + tc["weight_decay"] * params[n]
                params[n] -= lr * u
    change = {n: (params[n].detach() - sd[n]) for n in names}
    return losses, first_grad, change
