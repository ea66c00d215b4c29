"""Sequence loss and flow metrics: the JAX package's ``training/loss.py``.

The RAFT paper's recipe: the gamma-weighted L1 over every iteration's
upsampled flow, ground-truth flows beyond ``max_flow`` masked out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..lint.contracts import contract
from ..ops import spmd


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last (flow) axis."""
    return torch.sqrt(torch.square(x).sum(dim=-1))


def _psum_all(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    for ax in axes:
        x = spmd.psum(x, ax)
    return x


@contract(flow_preds="*[I,B,H,W,2]", flow_gt="*[B,H,W,2]",
          valid="*[B,H,W]")
def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, gamma: float = 0.8,
                  max_flow: float = 400.0, normalization: str = "total",
                  axes: Sequence = ()
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L_seq = sum_i gamma^(N-i-1) * mean |pred_i - gt|_1 over valid pixels.

    flow_preds [iters, B, H, W, 2] (every iteration's upsampled flow),
    flow_gt [B, H, W, 2], valid [B, H, W] bool or 0/1 (None: all valid; a
    pixel is valid where ``valid >= 0.5`` and ``|gt| < max_flow``).  The L1
    term is the mean over the 2 channels.  ``normalization='total'``
    divides each iteration's sum by B*H*W (the official recipe: invalid
    pixels count in the denominator), ``'valid'`` by the valid-pixel count.
    Returns (scalar loss, metrics of the final prediction: loss, epe, 1px,
    3px, 5px as valid-pixel means, each a 0-dim tensor).

    ``axes``: the mesh axes (``ops/spmd.py::Axis``) a sharded batch lies
    over (the data axis's samples, the spatial axis's rows).  Each rank's
    numerators are then divided by the **global** count (under 'total' the
    pixels of the whole batch, under 'valid' the psum of the valid counts,
    taken without a gradient), so the returned loss is this rank's share
    and the ranks' shares sum to the global loss (the convention of
    ``ops/spmd.py``); the metrics are the global batch's, the same on
    every rank (``loss`` the sum of the shares)."""
    axes = [ax for ax in axes if ax.group is not None]
    if normalization not in ("total", "valid"):
        raise ValueError(f"normalization must be 'total' or 'valid', "
                         f"got {normalization!r}")
    n = flow_preds.shape[0]
    mag = _norm(flow_gt)
    v = (torch.ones_like(mag) if valid is None
         else (valid.float() >= 0.5).float())
    v = v * (mag < max_flow)
    if axes:
        with torch.no_grad():
            denom = torch.clamp(_psum_all(v.sum(), axes), min=1.0)
    else:
        denom = torch.clamp(v.sum(), min=1.0)
    count = mag.numel()
    for ax in axes:
        count *= ax.size
    loss_denom = (torch.full((), float(count), device=mag.device)
                  if normalization == "total" else denom)
    exps = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=mag.device)
    weights = torch.pow(torch.full((), gamma, device=mag.device), exps)
    l1 = (flow_preds - flow_gt[None]).abs().mean(dim=-1)          # [n,B,H,W]
    per_iter = (l1 * v[None]).sum(dim=(1, 2, 3)) / loss_denom      # [n]
    loss = (weights * per_iter).sum()

    with torch.no_grad():
        epe = _norm(flow_preds[-1] - flow_gt)                      # [B,H,W]
        sums = torch.stack([(epe * v).sum(), ((epe < 1.0) * v).sum(),
                            ((epe < 3.0) * v).sum(), ((epe < 5.0) * v).sum(),
                            loss.detach()])
        sums = _psum_all(sums, axes)
        metrics = {"loss": sums[4] if axes else loss.detach()}
        for k, name in enumerate(("epe", "1px", "3px", "5px")):
            metrics[name] = sums[k] / denom
    return loss, metrics


def epe_metrics(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                reduce: str = "mean", axes: Sequence = ()
                ) -> Dict[str, torch.Tensor]:
    """End-point-error statistics for evaluation: epe, 1px, 3px, 5px and
    KITTI's Fl-all (error > 3 px and > 5% of the magnitude).
    ``reduce='mean'`` gives means over valid pixels; ``'sum'`` the
    valid-masked sums and ``valid_px``, so a caller can pool pixels across
    images (the official KITTI convention).  ``axes``: as
    :func:`sequence_loss`'s, the sums and the valid count psum'd over them,
    so every rank holds the global batch's statistics."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    epe = _norm(flow_pred - flow_gt)
    v = torch.ones_like(epe) if valid is None else valid.float()
    mag = torch.clamp(_norm(flow_gt), min=1e-6)
    fl = ((epe > 3.0) & (epe / mag > 0.05)).float()
    names = ("epe", "1px", "3px", "5px", "fl_all", "valid_px")
    stacked = torch.stack([(epe * v).sum(), ((epe < 1.0) * v).sum(),
                           ((epe < 3.0) * v).sum(), ((epe < 5.0) * v).sum(),
                           (fl * v).sum(), v.sum()])
    stacked = _psum_all(stacked, [ax for ax in axes if ax.group is not None])
    sums = dict(zip(names, stacked))
    if reduce == "sum":
        return sums
    denom = torch.clamp(sums.pop("valid_px"), min=1.0)
    return {k: s / denom for k, s in sums.items()}
