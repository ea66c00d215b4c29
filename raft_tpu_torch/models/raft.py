"""RAFT (the full ``raft-things`` model), eval-mode inference.

The port of the JAX package's ``models/raft.py``: ``make_inference_fn``
(pairwise) and ``make_ragged_inference_fn`` / ``make_ragged_counted_
inference_fn`` (mixed-resolution items corner-anchored in one max box,
``sizes=``) -> ``raft_forward(train=False)`` -> ``_iterate_flow`` under
the fixed iteration policy.  Images are float [0, 1], NHWC, as in JAX.
Inside, activations are NCHW ``channels_last`` (NHWC in memory), so the
kernels read them through ``permute`` views without copies.

Per iteration the loop runs the correlation lookup, the motion encoder,
the SepConvGRU (``gru_impl='pallas'``: the CUDA kernel of
``ops/gru_cuda.py``; ``'xla'``: its plain version) and the flow and mask
heads; then convex upsampling.  The lookup (``ops/corr_cuda.py``) is, with
``corr_impl='pallas'``, the CUDA kernel of ``pallas_p_select`` ('all' or
'window'; with ``pallas_pack=True`` the narrow levels go to the packed
kernel) or, for a ragged batch, the ragged kernel (``pallas_pack`` does not
apply there, as in JAX); with ``'blockwise'`` + ``'onehot'``, the plain
versions.  A ragged batch masks the images and the correlation features
outside each item's crop; everything else runs over the whole max box, as
in JAX, and the caller slices each item's crop.

``compute_dtype='bfloat16'`` follows the JAX package's policy: the images
are cast after ``2x - 1``; the model's weights must already be bfloat16
(:func:`init_raft_torch` makes them so; a model loaded from float32
weights is cast once with ``model.to(torch.bfloat16)``), so no request
casts a parameter; encoders, motion encoder, GRU I/O and heads run in
bfloat16; the correlation is computed from float32 maps (bfloat16-rounded
operands under ``corr_precision='default'``) and cast to bfloat16; the
coordinates and the upsampling stay float32.

Entry points (:func:`init_raft_torch`, :func:`make_inference_fn`, the
ragged ones) run on CUDA unless the caller passes ``device="cpu"``, and
raise when CUDA is absent and the CPU was not asked for.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import RAFTConfig, check_port_support
from ..ops.conv import init_conv_, to_nchw, to_nhwc
from ..ops.coords import coords_grid
from ..ops.corr import (lookup_blockwise_onehot, lookup_operands,
                        lookup_ragged_plain, mask_ragged_rows)
from ..ops.corr_cuda import (make_fused_lookup, make_ragged_fused_lookup,
                             make_window_lookup)
from ..ops.gru_cuda import fuse_gru_weights, prepare_gru_weights
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


def compute_dtype(config: RAFTConfig) -> torch.dtype:
    """The activations' and weights' dtype of ``config.compute_dtype``."""
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def init_raft_torch(config: RAFTConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> RAFT:
    """A RAFT module with seeded random weights (Kaiming fan-out normal
    convs, zero biases, identity batch-norm statistics), in eval mode on
    ``device``, in ``config.compute_dtype``.  Weights are drawn in float32
    on the CPU from ``generator`` (default: seed 0), so one seed gives the
    same weights on every device; under ``compute_dtype='bfloat16'`` every
    parameter and buffer is then rounded to bfloat16, once."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RAFT(config)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator)
    return model.to(dev, compute_dtype(config)).eval()


def _preprocess(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, 3] float32 in [0, 1] -> NCHW channels_last in [-1, 1],
    cast to ``dtype`` after the affine map."""
    return to_nchw((2.0 * image - 1.0).to(dtype).contiguous())


def _check_model_dtype(model: RAFT, config: RAFTConfig) -> None:
    want = compute_dtype(config)
    got = next(model.parameters()).dtype
    if got != want:
        raise ValueError(
            f"the model's weights are {got}, compute_dtype={config.compute_dtype!r} "
            f"needs {want}: cast the model once (model.to({want})) or build "
            f"it with init_raft_torch(config)")


def encode_pair(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                config: RAFTConfig):
    """The encoders: one fnet pass over both frames (batch 2B), one cnet
    pass over frame 1, in ``config.compute_dtype``.  Returns fmap1, fmap2,
    inp (NCHW) and the initial net [B, h, w, hidden] (NHWC)."""
    B = image1.shape[0]
    cdt = compute_dtype(config)
    x1 = _preprocess(image1.float(), cdt)
    x2 = _preprocess(image2.float(), cdt)
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
    selects the paths; ``model`` holds the weights.

    ``sizes`` (integer [B, 2], optional) makes the batch ragged: item b is
    a corner-anchored ``sizes[b] = (h, w)`` crop of the ``H x W`` max box
    (need not be multiples of 8).  The images are masked to zero outside
    the crops, the correlation runs on each crop alone, and the flow is
    valid on ``[:h, :w]`` of each item."""
    check_port_support(config)
    _check_model_dtype(model, config)
    iters = config.iters if iters is None else iters
    B, H, W, _ = image1.shape
    if H % 8 or W % 8:
        raise ValueError(
            f"RAFT requires H and W divisible by 8, got {(H, W)}; pad or "
            f"resize the inputs.")
    if image2.shape != image1.shape:
        raise ValueError(f"image shapes differ: {tuple(image1.shape)} vs "
                         f"{tuple(image2.shape)}")
    sizes8 = None
    if sizes is not None:
        sizes = torch.as_tensor(sizes, device=image1.device)
        if tuple(sizes.shape) != (B, 2) or sizes.is_floating_point():
            raise ValueError(f"sizes must be an integer [B, 2] = {[B, 2]} "
                             f"tensor of live (h, w) per item, got "
                             f"{sizes.dtype} {list(sizes.shape)}")
        sizes = sizes.to(torch.int32)
        # dead regions become exact zeros whatever the caller embedded, so
        # each item's flow depends only on its crop
        image1 = mask_ragged_rows(image1, sizes)
        image2 = mask_ragged_rows(image2, sizes)
        sizes8 = sizes // 8
    fmap1, fmap2, net, inp = encode_pair(model, image1, image2, config)
    return _iterate_flow(model, fmap1, fmap2, net, inp, config, iters,
                         all_flows, flow_init, sizes8)


class LoopState(NamedTuple):
    """What every GRU iteration reads: the lookup closure, the hoisted
    context terms, the fused GRU weights, the GRU kernel's weights (CUDA
    and ``gru_impl='pallas'`` only, else None) and the base coordinates."""
    lookup: object
    gru_ctx: tuple
    gru_weights: dict
    gru_kernel_weights: Optional[dict]
    coords0: torch.Tensor


def prepare_loop(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 inp: torch.Tensor, config: RAFTConfig,
                 sizes8: Optional[torch.Tensor] = None) -> LoopState:
    """Loop-invariant work, once per forward.  fmap1/fmap2 [B, C, h, w]
    and inp [B, ctx, h, w] NCHW; ``sizes8`` [B, 2] int32 live (h, w) per
    item on the 1/8 grid for a ragged batch, else None.  The lookup's
    operands are float32 maps (bfloat16-rounded under
    ``corr_precision='default'``), whatever the compute dtype."""
    B, _, h, w = fmap1.shape
    f1 = to_nhwc(fmap1)
    f2 = to_nhwc(fmap2)
    r, L, prec = config.corr_radius, config.corr_levels, config.corr_precision
    pallas = config.corr_impl == "pallas"
    if sizes8 is not None and pallas:
        lookup = make_ragged_fused_lookup(f1, f2, sizes8, L, r, prec)
    elif sizes8 is not None:                # the masked plain twin
        f1m, levels = lookup_operands(f1, f2, L, prec, sizes8)

        def lookup(coords):
            return lookup_ragged_plain(f1m, levels, coords, sizes8, r)
    elif pallas and config.pallas_p_select == "window":
        lookup = make_window_lookup(f1, f2, L, r, config.pallas_pack, prec)
    elif pallas:
        lookup = make_fused_lookup(f1, f2, L, r, config.pallas_pack, prec)
    else:                                   # 'blockwise' + 'onehot'
        f1p, levels = lookup_operands(f1, f2, L, prec)

        def lookup(coords):
            return lookup_blockwise_onehot(f1p, levels, coords, r)

    gru = model.update_block.gru
    fw = fuse_gru_weights(gru, config.hidden_dim, config.context_dim)
    kw = None
    if config.gru_impl == "pallas" and f1.device.type == "cuda":
        kw = prepare_gru_weights(fw, compute_dtype(config))
    return LoopState(
        lookup=lookup,
        gru_ctx=precompute_gru_ctx(gru, inp, config.hidden_dim),
        gru_weights=fw, gru_kernel_weights=kw,
        coords0=coords_grid(B, h, w, device=f1.device))


def gru_step(model: RAFT, config: RAFTConfig, loop: LoopState,
             net: torch.Tensor, coords1: torch.Tensor):
    """One GRU iteration: lookup, motion encoder, SepConvGRU, heads.
    net [B, h, w, hidden] (compute dtype) and coords1 [B, h, w, 2] (float32)
    NHWC; returns the new (net, coords1, mask), mask NHWC [B, h, w, 576] in
    the compute dtype.  The float32 correlation and flow are cast to the
    compute dtype, the flow update back to float32 before it moves
    coords1."""
    cdt = compute_dtype(config)
    corr = loop.lookup(coords1).to(cdt)
    flow = (coords1 - loop.coords0).to(cdt)
    net, mask, delta_flow = model.update_block(
        net, to_nchw(corr), to_nchw(flow), loop.gru_ctx, loop.gru_weights,
        gru_impl=config.gru_impl, gru_kernel_weights=loop.gru_kernel_weights)
    return net, coords1 + to_nhwc(delta_flow).float(), to_nhwc(mask)


def _iterate_flow(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                  net: torch.Tensor, inp: torch.Tensor, config: RAFTConfig,
                  iters: int, all_flows: bool,
                  flow_init: Optional[torch.Tensor],
                  sizes8: Optional[torch.Tensor] = None) -> RAFTOutput:
    """The recurrent core, fixed policy.  fmap1/fmap2 [B, C, h, w] and inp
    [B, ctx, h, w] NCHW; net [B, h, w, hidden] NHWC; ``sizes8`` as in
    :func:`prepare_loop`."""
    loop = prepare_loop(model, fmap1, fmap2, inp, config, sizes8)
    coords0 = loop.coords0
    coords1 = coords0 if flow_init is None else coords0 + flow_init.float()
    B, h, w, _ = coords0.shape
    mask = torch.zeros((B, h, w, 64 * 9), dtype=compute_dtype(config),
                       device=coords0.device)
    flows = []
    for _ in range(iters):
        net, coords1, mask = gru_step(model, config, loop, net, coords1)
        if all_flows:
            flows.append(convex_upsample_flow(coords1 - coords0, mask.float()))

    flow_lr = coords1 - coords0
    if all_flows:
        flow_iters = torch.stack(flows)
        final = flow_iters[-1]
    else:
        flow_iters = None
        final = convex_upsample_flow(flow_lr, mask.float())
    iters_used = torch.full((B,), iters, dtype=torch.int32,
                            device=coords0.device)
    return RAFTOutput(flow=final, flow_iters=flow_iters, flow_lr=flow_lr,
                      iters_used=iters_used)


def _forward_on(config: RAFTConfig, iters: Optional[int], device):
    """``forward(model, image1, image2, sizes=None) -> RAFTOutput`` on
    ``device`` (CUDA unless ``device="cpu"``): images (and sizes) as numpy
    arrays or tensors, moved to the model's device."""
    dev = resolve_device(device)
    check_port_support(config)

    def forward(model: RAFT, image1, image2, sizes=None) -> RAFTOutput:
        p = next(model.parameters())
        if p.device.type != dev.type:
            raise ValueError(f"model is on {p.device}, the inference "
                             f"function on {dev}")
        im1 = torch.as_tensor(image1, dtype=torch.float32, device=p.device)
        im2 = torch.as_tensor(image2, dtype=torch.float32, device=p.device)
        return raft_forward(model, im1, im2, config, iters=iters, sizes=sizes)

    return forward


def make_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                      device=None):
    """``fn(model, image1, image2) -> flow`` [B, H, W, 2] on ``device``
    (CUDA unless ``device="cpu"``).  Images are [B, H, W, 3] in [0, 1],
    numpy arrays or tensors; they are moved to the device."""
    forward = _forward_on(config, iters, device)

    def fn(model: RAFT, image1, image2) -> torch.Tensor:
        return forward(model, image1, image2).flow

    return fn


def make_ragged_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                             device=None):
    """``fn(model, image1, image2, sizes) -> flow`` [B, H, W, 2] for a
    ragged mixed-resolution batch on ``device`` (CUDA unless
    ``device="cpu"``): images [B, H, W, 3] in [0, 1] hold each item
    corner-anchored in the shared max box (``data.pipeline.embed_to_shape``),
    ``sizes`` [B, 2] integer the items' full-resolution (h, w).  Item b's
    flow is valid on ``[:sizes[b, 0], :sizes[b, 1]]``."""
    forward = _forward_on(config, iters, device)

    def fn(model: RAFT, image1, image2, sizes) -> torch.Tensor:
        return forward(model, image1, image2, sizes).flow

    return fn


def make_ragged_counted_inference_fn(config: RAFTConfig,
                                     iters: Optional[int] = None,
                                     device=None):
    """As :func:`make_ragged_inference_fn`, returning ``(flow,
    iters_used)``, iters_used [B] int32 (the fixed policy's count)."""
    forward = _forward_on(config, iters, device)

    def fn(model: RAFT, image1, image2, sizes):
        out = forward(model, image1, image2, sizes)
        return out.flow, out.iters_used

    return fn
