"""The update blocks (NCHW, ``channels_last``): the full model's motion
encoder, SepConvGRU, flow and mask heads, and the small model's motion
encoder, 3x3 ConvGRU and flow head (no mask head: raft-small upsamples
bilinearly).  Module names mirror the JAX tree (``encoder.convc1``,
``gru.convz1``, ``flow_head.conv1``, ``mask.0`` ...).

Both GRUs run on hoisted context terms (:func:`precompute_gru_ctx`, the
JAX package's ``gru_ctx_hoist=True``): the gate convs' terms over the
loop-invariant context features, biases folded in, computed once per
forward, so the in-loop gate convs read only ``[h, motion]`` and carry no
bias.  Under ``gru_ctx_hoist=False`` (``gru_impl='xla'`` only: the kernel
always hoists) they run as the JAX package's ``apply_sep_conv_gru`` and
``apply_conv_gru``: every gate conv, bias included, on ``[h, x]`` with
``x = [context, motion]`` (:func:`sep_conv_gru_full`,
:func:`conv_gru_full`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import (apply_conv_fused, conv_nchw, make_conv, to_nchw,
                        to_nhwc)
from ..ops.gru_cuda import sep_conv_gru_plain, sep_conv_gru_rows

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


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_dim: int):
        super().__init__()
        self.convc1 = make_conv(1, corr_dim, 96)
        self.convf1 = make_conv(7, 2, 64)
        self.convf2 = make_conv(3, 64, 32)
        self.conv = make_conv(3, 96 + 32, 80)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """flow [B, 2, H, W], corr [B, L*(2r+1)^2, H, W] -> [B, 82, H, W]:
        80 conv channels, then the 2 flow channels."""
        cor = F.relu(self.convc1(corr))
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


class ConvGRU(nn.Module):
    """The small model's 3x3 ConvGRU: holds the three gate convs; the
    iteration is :func:`conv_gru_hoisted`."""

    def __init__(self, hidden: int, input_dim: int):
        super().__init__()
        for g in ("convz", "convr", "convq"):
            setattr(self, g, make_conv(3, hidden + input_dim, hidden))


_GATES = ("convz", "convr", "convq")


def precompute_gru_ctx(gru: nn.Module, inp: torch.Tensor, hidden: int
                       ) -> Tuple[torch.Tensor, ...]:
    """The gate convs' terms over the loop-invariant context ``inp``
    [B, ctx, H, W], biases folded in, so the in-loop convs are bias-free.
    The hx layout is [h, inp, motion]: inp is kernel columns
    ``[hidden, hidden+ctx)``.  For a :class:`SepConvGRU`, the 1x5 and the
    5x1 pass terms, each [B, H, W, 3*hidden] NHWC (z | r | q), from one
    fused conv per pass; for a :class:`ConvGRU`, the z, r and q terms,
    each [B, hidden, H, W] NCHW, from one fused conv."""
    lo, hi = hidden, hidden + inp.shape[1]
    if isinstance(gru, ConvGRU):
        convs = [getattr(gru, g) for g in _GATES]
        return apply_conv_fused([c.weight[:, lo:hi] for c in convs],
                                [c.bias for c in convs], inp)
    out = []
    for s in ("1", "2"):
        convs = [getattr(gru, g + s) for g in _GATES]
        terms = apply_conv_fused([c.weight[:, lo:hi] for c in convs],
                                 [c.bias for c in convs], inp)
        out.append(to_nhwc(torch.cat(terms, dim=1)).contiguous())
    return out[0], out[1]


def fuse_conv_gru_weights(gru: ConvGRU, hidden: int, ctx_dim: int
                          ) -> Dict[str, torch.Tensor]:
    """The ConvGRU's in-loop weights (the JAX package's ``_gate_loop_w``),
    once per forward: each gate's kernel with the context input channels
    ``[hidden, hidden+ctx_dim)`` removed; ``wzr`` [2*hidden, hidden+motion,
    3, 3] holds z and r fused on the output, ``wq`` [hidden, hidden+motion,
    3, 3] the q gate.  In the parameters' dtype."""
    lo, hi = hidden, hidden + ctx_dim

    def loop_cols(conv: nn.Module) -> torch.Tensor:
        w = conv.weight
        return torch.cat([w[:, :lo], w[:, hi:]], dim=1)

    return {"wzr": torch.cat([loop_cols(gru.convz), loop_cols(gru.convr)]),
            "wq": loop_cols(gru.convq).contiguous()}


def conv_gru_hoisted(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                     motion: torch.Tensor, ctx: Tuple[torch.Tensor, ...]
                     ) -> torch.Tensor:
    """One ConvGRU iteration on hoisted context terms (the JAX package's
    ``apply_conv_gru_hoisted``): h [B, hidden, H, W] and motion NCHW, ``fw``
    from :func:`fuse_conv_gru_weights`, ``ctx`` the z, r and q terms of
    :func:`precompute_gru_ctx`.  In h's dtype, op by op."""
    hidden = h.shape[1]
    zr = conv_nchw(torch.cat([h, motion], dim=1), fw["wzr"], None)
    z = torch.sigmoid(zr[:, :hidden] + ctx[0])
    r = torch.sigmoid(zr[:, hidden:] + ctx[1])
    q = torch.tanh(conv_nchw(torch.cat([r * h, motion], dim=1), fw["wq"], None)
                   + ctx[2])
    return (1.0 - z) * h + z * q


def _gate_pass(gru: nn.Module, suffix: str, h: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """One gate pass of the un-hoisted GRU (NCHW): z and r as one fused
    conv over ``[h, x]``, q over ``[r*h, x]``, biases in the convs."""
    z_conv, r_conv, q_conv = (getattr(gru, g + suffix) for g in _GATES)
    zc, rc = apply_conv_fused([z_conv.weight, r_conv.weight],
                              [z_conv.bias, r_conv.bias],
                              torch.cat([h, x], dim=1))
    z, r = torch.sigmoid(zc), torch.sigmoid(rc)
    q = torch.tanh(q_conv(torch.cat([r * h, x], dim=1)))
    return (1.0 - z) * h + z * q


def sep_conv_gru_full(gru: SepConvGRU, h: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The SepConvGRU iteration without hoisting (the JAX package's
    ``apply_sep_conv_gru``): h [B, hidden, H, W] and x = [context, motion]
    NCHW; the 1x5 pass, then the 5x1 pass.  In h's dtype, op by op."""
    for suffix in ("1", "2"):
        h = _gate_pass(gru, suffix, h, x)
    return h


def conv_gru_full(gru: ConvGRU, h: torch.Tensor, x: torch.Tensor
                  ) -> torch.Tensor:
    """The 3x3 ConvGRU iteration without hoisting (the JAX package's
    ``apply_conv_gru``), shapes as :func:`sep_conv_gru_full`."""
    return _gate_pass(gru, "", h, x)


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
                gru_kernel_weights: Optional[Dict[str, torch.Tensor]] = None,
                inp: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """net [B, H, W, hidden] NHWC; corr, flow NCHW.  Returns the new
        net (NHWC), the mask logits and the flow update (NCHW).
        ``gru_kernel_weights``: the GRU kernel's weights
        (``prepare_gru_weights``), needed on CUDA under ``gru_impl='pallas'``.
        ``gru_ctx`` None runs the un-hoisted GRU on the context ``inp``
        [B, ctx, H, W] (``gru_ctx_hoist=False``, ``gru_impl='xla'``)."""
        motion = self.encoder(flow, corr)
        if gru_impl == "pallas":
            # row-sharded (training), the kernel on a halo'd slab
            net = sep_conv_gru_rows(gru_weights, net, to_nhwc(motion),
                                    gru_ctx, gru_kernel_weights)
        elif gru_ctx is not None:
            net = sep_conv_gru_plain(gru_weights, net, to_nhwc(motion), gru_ctx)
        else:
            net = to_nhwc(sep_conv_gru_full(self.gru, to_nchw(net),
                                            torch.cat([inp, motion], dim=1)))
        # flow head conv1 and mask head [0] read `net` with 3x3 kernels:
        # one fused conv, then each branch's own tail
        heads = (self.flow_head.conv1, self.mask[0])
        fh, mh = apply_conv_fused([c.weight for c in heads],
                                  [c.bias for c in heads], to_nchw(net))
        delta_flow = self.flow_head.conv2(F.relu(fh))
        mask = MASK_SCALE * self.mask[2](F.relu(mh))
        return net, mask, delta_flow


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_dim: int, hidden_dim: int = 96,
                 context_dim: int = 64):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_dim)
        self.gru = ConvGRU(hidden_dim, context_dim + 82)
        self.flow_head = nn.Module()
        self.flow_head.conv1 = make_conv(3, hidden_dim, 128)
        self.flow_head.conv2 = make_conv(3, 128, 2)

    def forward(self, net: torch.Tensor, corr: torch.Tensor,
                flow: torch.Tensor, gru_ctx, gru_weights: Dict[str, torch.Tensor],
                inp: Optional[torch.Tensor] = None,
                **_) -> Tuple[torch.Tensor, None, torch.Tensor]:
        """net [B, H, W, hidden] NHWC; corr, flow NCHW; ``gru_ctx`` and
        ``gru_weights`` from :func:`precompute_gru_ctx` and
        :func:`fuse_conv_gru_weights`, or ``gru_ctx`` None and the context
        ``inp`` [B, ctx, H, W] for the un-hoisted GRU.  Returns the new net
        (NHWC), no mask and the flow update (NCHW)."""
        motion = self.encoder(flow, corr)
        if gru_ctx is None:
            h = conv_gru_full(self.gru, to_nchw(net),
                              torch.cat([inp, motion], dim=1))
        else:
            h = conv_gru_hoisted(gru_weights, to_nchw(net), motion, gru_ctx)
        delta_flow = self.flow_head.conv2(F.relu(self.flow_head.conv1(h)))
        return to_nhwc(h), None, delta_flow
