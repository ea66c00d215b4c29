"""RAFT (the full ``raft-things`` model), eval-mode pairwise inference.

The port of the JAX package's ``models/raft.py`` main path:
``make_inference_fn`` -> ``raft_forward(train=False)`` -> ``_iterate_flow``
under the fixed iteration policy.  Images are float [0, 1], NHWC, as in
JAX.  Inside, activations are NCHW ``channels_last`` (NHWC in memory), so
the two kernels read them through ``permute`` views without copies.

Per iteration the loop runs the correlation lookup (``corr_impl='pallas'``:
the CUDA kernel of ``ops/corr_cuda.py``; ``'blockwise'`` + ``'onehot'``:
its plain version), the motion encoder, the SepConvGRU (``gru_impl=
'pallas'``: the CUDA kernel of ``ops/gru_cuda.py``; ``'xla'``: its plain
version) and the flow and mask heads; then convex upsampling.

Entry points (:func:`init_raft_torch`, :func:`make_inference_fn`) run on
CUDA unless the caller passes ``device="cpu"``, and raise when CUDA is
absent and the CPU was not asked for.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import RAFTConfig, check_port_support
from ..ops.conv import init_conv_, to_nchw, to_nhwc
from ..ops.coords import coords_grid
from ..ops.corr import fmap2_pyramid, lookup_blockwise_onehot
from ..ops.corr_cuda import make_fused_lookup
from ..ops.gru_cuda import fuse_gru_weights
from ..ops.upsample import convex_upsample_flow
from .encoders import BasicEncoder
from .update import BasicUpdateBlock, precompute_gru_ctx


class RAFTOutput(NamedTuple):
    flow: torch.Tensor                    # [B, H, W, 2] final full-res flow
    flow_iters: Optional[torch.Tensor]    # [iters, B, H, W, 2] or None
    flow_lr: torch.Tensor                 # [B, H/8, W/8, 2] final low-res flow
    iters_used: Optional[torch.Tensor] = None   # [B] int32


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, and raises when
    CUDA is absent (no quiet fallback to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: raft_tpu_torch runs "
                               "on the GPU unless device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


class RAFT(nn.Module):
    """The weights of the full model; ``state_dict`` keys are the JAX
    parameter paths (see ``convert/weights.py``)."""

    def __init__(self, config: RAFTConfig):
        super().__init__()
        if config.small:
            raise NotImplementedError("small=True (the raft-small variant) "
                                      "is ROADMAP Queue A item 6b")
        self.fnet = BasicEncoder(config.fnet_dim, "instance")
        self.cnet = BasicEncoder(config.cnet_dim, "batch")
        self.update_block = BasicUpdateBlock(
            config.corr_feature_dim, config.hidden_dim, config.context_dim)


def init_raft_torch(config: RAFTConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> RAFT:
    """A RAFT module with seeded random weights (Kaiming fan-out normal
    convs, zero biases, identity batch-norm statistics), in eval mode on
    ``device``.  Weights are drawn on the CPU from ``generator`` (default:
    seed 0), so one seed gives the same weights on every device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RAFT(config)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator)
    return model.to(dev).eval()


def _preprocess(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> NCHW channels_last in [-1, 1]."""
    return to_nchw((2.0 * image - 1.0).contiguous())


def encode_pair(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                config: RAFTConfig):
    """The encoders: one fnet pass over both frames (batch 2B), one cnet
    pass over frame 1.  Returns fmap1, fmap2, inp (NCHW) and the initial
    net [B, h, w, hidden] (NHWC)."""
    B = image1.shape[0]
    x1 = _preprocess(image1.float())
    x2 = _preprocess(image2.float())
    fmaps = model.fnet(torch.cat([x1, x2], dim=0))
    cnet = model.cnet(x1)
    hid = config.hidden_dim
    net = to_nhwc(torch.tanh(cnet[:, :hid])).contiguous()
    return fmaps[:B], fmaps[B:], net, torch.relu(cnet[:, hid:])


@torch.no_grad()
def raft_forward(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                 config: RAFTConfig, iters: Optional[int] = None,
                 all_flows: bool = False,
                 flow_init: Optional[torch.Tensor] = None,
                 sizes: Optional[torch.Tensor] = None) -> RAFTOutput:
    """Eval-mode RAFT on the device of the inputs (``train=False`` of the
    JAX function).  image1/image2 [B, H, W, 3] float32 in [0, 1], H and W
    multiples of 8; ``flow_init`` [B, H/8, W/8, 2] or None.  ``config``
    selects the paths; ``model`` holds the weights."""
    check_port_support(config)
    if sizes is not None:
        raise NotImplementedError("ragged mixed-resolution batches (sizes=) "
                                  "are ROADMAP Queue A item 10")
    iters = config.iters if iters is None else iters
    B, H, W, _ = image1.shape
    if H % 8 or W % 8:
        raise ValueError(
            f"RAFT requires H and W divisible by 8, got {(H, W)}; pad or "
            f"resize the inputs.")
    if image2.shape != image1.shape:
        raise ValueError(f"image shapes differ: {tuple(image1.shape)} vs "
                         f"{tuple(image2.shape)}")
    fmap1, fmap2, net, inp = encode_pair(model, image1, image2, config)
    return _iterate_flow(model, fmap1, fmap2, net, inp, config, iters,
                         all_flows, flow_init)


class LoopState(NamedTuple):
    """What every GRU iteration reads: the lookup closure, the hoisted
    context terms, the fused GRU weights and the base coordinates."""
    lookup: object
    gru_ctx: tuple
    gru_weights: dict
    coords0: torch.Tensor


def prepare_loop(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 inp: torch.Tensor, config: RAFTConfig) -> LoopState:
    """Loop-invariant work, once per forward.  fmap1/fmap2 [B, C, h, w]
    and inp [B, ctx, h, w] NCHW."""
    B, _, h, w = fmap1.shape
    f1 = to_nhwc(fmap1.float()).contiguous()
    f2 = to_nhwc(fmap2.float()).contiguous()
    r = config.corr_radius
    if config.corr_impl == "pallas":
        lookup = make_fused_lookup(f1, f2, config.corr_levels, r)
    else:                                   # 'blockwise' + 'onehot'
        levels = fmap2_pyramid(f2, config.corr_levels)

        def lookup(coords):
            return lookup_blockwise_onehot(f1, levels, coords, r)

    gru = model.update_block.gru
    return LoopState(
        lookup=lookup,
        gru_ctx=precompute_gru_ctx(gru, inp, config.hidden_dim),
        gru_weights=fuse_gru_weights(gru, config.hidden_dim, config.context_dim),
        coords0=coords_grid(B, h, w, device=f1.device))


def gru_step(model: RAFT, config: RAFTConfig, loop: LoopState,
             net: torch.Tensor, coords1: torch.Tensor):
    """One GRU iteration: lookup, motion encoder, SepConvGRU, heads.
    net [B, h, w, hidden] and coords1 [B, h, w, 2] NHWC; returns the new
    (net, coords1, mask), mask NHWC [B, h, w, 576]."""
    corr = loop.lookup(coords1)
    flow = coords1 - loop.coords0
    net, mask, delta_flow = model.update_block(
        net, to_nchw(corr), to_nchw(flow), loop.gru_ctx, loop.gru_weights,
        gru_impl=config.gru_impl)
    return net, coords1 + to_nhwc(delta_flow), to_nhwc(mask)


def _iterate_flow(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                  net: torch.Tensor, inp: torch.Tensor, config: RAFTConfig,
                  iters: int, all_flows: bool,
                  flow_init: Optional[torch.Tensor]) -> RAFTOutput:
    """The recurrent core, fixed policy.  fmap1/fmap2 [B, C, h, w] and inp
    [B, ctx, h, w] NCHW; net [B, h, w, hidden] NHWC."""
    loop = prepare_loop(model, fmap1, fmap2, inp, config)
    coords0 = loop.coords0
    coords1 = coords0 if flow_init is None else coords0 + flow_init.float()
    B, h, w, _ = coords0.shape
    mask = torch.zeros((B, h, w, 64 * 9), device=coords0.device)
    flows = []
    for _ in range(iters):
        net, coords1, mask = gru_step(model, config, loop, net, coords1)
        if all_flows:
            flows.append(convex_upsample_flow(coords1 - coords0, mask))

    flow_lr = coords1 - coords0
    if all_flows:
        flow_iters = torch.stack(flows)
        final = flow_iters[-1]
    else:
        flow_iters = None
        final = convex_upsample_flow(flow_lr, mask)
    iters_used = torch.full((B,), iters, dtype=torch.int32,
                            device=coords0.device)
    return RAFTOutput(flow=final, flow_iters=flow_iters, flow_lr=flow_lr,
                      iters_used=iters_used)


def make_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                      device=None):
    """``fn(model, image1, image2) -> flow`` [B, H, W, 2] on ``device``
    (CUDA unless ``device="cpu"``).  Images are [B, H, W, 3] in [0, 1],
    numpy arrays or tensors; they are moved to the device."""
    dev = resolve_device(device)
    check_port_support(config)

    def fn(model: RAFT, image1, image2) -> torch.Tensor:
        p = next(model.parameters())
        if p.device.type != dev.type:
            raise ValueError(f"model is on {p.device}, the inference "
                             f"function on {dev}")
        im1 = torch.as_tensor(image1, dtype=torch.float32, device=p.device)
        im2 = torch.as_tensor(image2, dtype=torch.float32, device=p.device)
        return raft_forward(model, im1, im2, config, iters=iters).flow

    return fn
