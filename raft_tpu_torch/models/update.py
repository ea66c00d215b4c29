"""The full model's update block: motion encoder, SepConvGRU, flow and mask
heads (NCHW, ``channels_last``).  Module names mirror the JAX tree
(``encoder.convc1``, ``gru.convz1``, ``flow_head.conv1``, ``mask.0`` ...).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import apply_conv_fused, make_conv, to_nchw, to_nhwc
from ..ops.gru_cuda import sep_conv_gru, sep_conv_gru_plain

# .25 mask scale as in official RAFT
MASK_SCALE = 0.25


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_dim: int):
        super().__init__()
        self.convc1 = make_conv(1, corr_dim, 256)
        self.convc2 = make_conv(3, 256, 192)
        self.convf1 = make_conv(7, 2, 128)
        self.convf2 = make_conv(3, 128, 64)
        self.conv = make_conv(3, 192 + 64, 128 - 2)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """flow [B, 2, H, W], corr [B, L*(2r+1)^2, H, W] -> [B, 128, H, W]:
        126 conv channels, then the 2 flow channels."""
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Holds the six gate convs; the iteration itself runs through
    :func:`raft_tpu_torch.ops.gru_cuda.sep_conv_gru` (or its plain
    version) on hoisted context terms and fused weights."""

    def __init__(self, hidden: int, input_dim: int):
        super().__init__()
        hx = hidden + input_dim
        for s, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in ("convz", "convr", "convq"):
                setattr(self, g + s, make_conv(k, hx, hidden))


def precompute_gru_ctx(gru: SepConvGRU, inp: torch.Tensor, hidden: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate convs' terms over the loop-invariant context ``inp``
    [B, ctx, H, W], biases folded in, so the in-loop convs are bias-free.
    The hx layout is [h, inp, motion]: inp is kernel columns
    ``[hidden, hidden+ctx)``.  Returns the 1x5 and the 5x1 pass terms, each
    [B, H, W, 3*hidden] NHWC (z | r | q), from one fused conv per pass."""
    lo, hi = hidden, hidden + inp.shape[1]
    out = []
    for s in ("1", "2"):
        convs = [getattr(gru, g + s) for g in ("convz", "convr", "convq")]
        terms = apply_conv_fused([c.weight[:, lo:hi] for c in convs],
                                 [c.bias for c in convs], inp)
        out.append(to_nhwc(torch.cat(terms, dim=1)).contiguous())
    return out[0], out[1]


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_dim: int, hidden_dim: int = 128,
                 context_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_dim)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128)
        self.flow_head = nn.Module()
        self.flow_head.conv1 = make_conv(3, hidden_dim, 256)
        self.flow_head.conv2 = make_conv(3, 256, 2)
        self.mask = nn.Sequential(make_conv(3, hidden_dim, 256), nn.ReLU(),
                                  make_conv(1, 256, 64 * 9))

    def forward(self, net: torch.Tensor, corr: torch.Tensor,
                flow: torch.Tensor, gru_ctx, gru_weights: Dict[str, torch.Tensor],
                gru_impl: str = "pallas",
                gru_kernel_weights: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """net [B, H, W, hidden] NHWC; corr, flow NCHW.  Returns the new
        net (NHWC), the mask logits and the flow update (NCHW).
        ``gru_kernel_weights``: the GRU kernel's weights
        (``prepare_gru_weights``), needed on CUDA under ``gru_impl='pallas'``."""
        motion = to_nhwc(self.encoder(flow, corr))
        if gru_impl == "pallas":
            net = sep_conv_gru(gru_weights, net, motion, gru_ctx,
                               gru_kernel_weights)
        else:
            net = sep_conv_gru_plain(gru_weights, net, motion, gru_ctx)
        # flow head conv1 and mask head [0] read `net` with 3x3 kernels:
        # one fused conv, then each branch's own tail
        heads = (self.flow_head.conv1, self.mask[0])
        fh, mh = apply_conv_fused([c.weight for c in heads],
                                  [c.bias for c in heads], to_nchw(net))
        delta_flow = self.flow_head.conv2(F.relu(fh))
        mask = MASK_SCALE * self.mask[2](F.relu(mh))
        return net, mask, delta_flow
