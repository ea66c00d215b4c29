"""RAFT (``raft-things`` and ``raft-small``), eval-mode inference.

The port of the JAX package's ``models/raft.py``, every entry point:

* pairwise: :func:`make_inference_fn`, :func:`make_counted_inference_fn`
  and their ragged twins (mixed-resolution items corner-anchored in one
  max box, ``sizes=``) -> :func:`raft_forward` (``train=False``) ->
  :func:`_iterate_flow`;
* streaming (one encoder pass per frame, the previous frame's maps
  cached): :func:`encode_frame`, :func:`forward_from_features`,
  :func:`make_encode_fn`, :func:`make_stream_step_fn` (maps as
  arguments), :func:`make_stream_batch_step_fn` (rows gathered from a slot
  pool's buffers, ``buf[slots]``) and their ragged twins;
* the storage formats of ``quant``: :func:`cast_encoder_weights`
  (``'bf16w'``), :func:`quantize_rows` and :func:`dequantize_rows`
  (``'int8'`` slot rows).

Images are float [0, 1], NHWC, as in JAX, and so are the streaming
entries' features (``[B, h, w, C]`` rows a slot pool stores).  Inside,
activations are NCHW ``channels_last`` (NHWC in memory), so the kernels
read them through ``permute`` views without copies.

Per iteration the loop runs the correlation lookup, the motion encoder,
the GRU and the heads; then the upsampling.  The full model's GRU is the
SepConvGRU (``gru_impl='pallas'``: the CUDA kernel of ``ops/gru_cuda.py``;
``'xla'``: its plain version, hoisted or, under ``gru_ctx_hoist=False``,
not), its heads the flow and mask heads, its upsampling convex; the small
model's GRU is a 3x3 ConvGRU in stock PyTorch (as in JAX, it has no
kernel), its head the flow head alone, its upsampling ``upflow8``.  The
lookup (``ops/corr_cuda.py``) is, with ``corr_impl='pallas'``, the CUDA
kernel of ``pallas_p_select`` ('all' or 'window'; with ``pallas_pack=True``
the narrow levels go to the packed kernel) or, for a ragged batch, the
ragged kernel (``pallas_pack`` does not apply there, as in JAX); with
``'blockwise'``, the plain versions (``corr_lookup='onehot'``) or the
gather lookup ``ops/corr.py::lookup_ondemand`` (``'gather'``); with
``'dense'``, the materialised pyramid (``ops/corr.py::build_pyramid``)
sampled by ``corr_lookup``.  A ragged batch masks the images and the
correlation features outside each item's crop, and takes the ragged kernel
under 'pallas', the masked plain twin under 'dense' and 'blockwise', as in
JAX; everything else runs over the whole max box, and the caller slices
each item's crop.

Iteration policies: ``'fixed'`` runs ``iters`` iterations;
``'converge:eps[:min_iters]'`` freezes each sample (its net, coords and
mask keep their values) once the mean L2 norm of its flow update is below
``eps`` from iteration ``min_iters`` on, and stops when every sample has
frozen; ``iters_used`` counts each sample's live iterations.  Rows marked
inactive (``active``, a slot-padded batch) start frozen and count 0.

``compute_dtype='bfloat16'`` follows the JAX package's policy: the images
are cast after ``2x - 1``; the model's weights must already be bfloat16
(:func:`init_raft_torch` makes them so; a model loaded from float32
weights is cast once with ``model.to(torch.bfloat16)``), so no request
casts a parameter; encoders, motion encoder, GRU I/O and heads run in
bfloat16; the correlation is computed from float32 maps (bfloat16-rounded
operands under ``corr_precision='default'``) and cast to bfloat16; the
coordinates and the upsampling stay float32.  ``quant='bf16w'`` stores the
encoders' weights bfloat16 (:func:`cast_encoder_weights`) and, under
float32 compute, up-casts them in each forward, as JAX does in-graph.

Entry points (:func:`init_raft_torch` and every factory) run on CUDA
unless the caller passes ``device="cpu"``, and raise when CUDA is absent
and the CPU was not asked for.  On CUDA the factories' functions replay
captured CUDA graphs (``models/capture.py``; a converge policy as three
graphs with a host check between iterations); on the CPU they run eager.
:func:`raft_forward`, :func:`encode_frame` and
:func:`forward_from_features` are always eager.  Under
``compute_dtype='float32'`` the factories' functions run with TF32 off for
cuDNN and cuBLAS (:func:`tf32_off`), as the JAX package's float32 convs
are computed, and give the caller's settings back after it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..config import (RAFTConfig, adaptive_iters, check_port_support,
                      parse_iters_policy)
from ..ops.conv import init_conv_, to_nchw, to_nhwc
from ..ops.coords import coords_grid
from ..ops.corr import (build_pyramid, lookup_blockwise_onehot, lookup_dense,
                        lookup_dense_onehot, lookup_ondemand, lookup_operands,
                        lookup_ragged_plain, mask_ragged_rows)
from ..ops.corr_cuda import (make_fused_lookup, make_ragged_fused_lookup,
                             make_window_lookup)
from ..ops.gru_cuda import fuse_gru_weights, prepare_gru_weights
from ..ops.upsample import convex_upsample_flow, upflow8
from .capture import BY_ADDRESS, GraphedForward, as_inputs
from .encoders import BasicEncoder, SmallEncoder
from .update import (BasicUpdateBlock, SmallUpdateBlock, fuse_conv_gru_weights,
                     precompute_gru_ctx)


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
    """The weights of the full model or, with ``config.small``, of
    raft-small; ``state_dict`` keys are the JAX parameter paths (see
    ``convert/weights.py``)."""

    def __init__(self, config: RAFTConfig):
        super().__init__()
        if config.small:
            self.fnet = SmallEncoder(config.fnet_dim, "instance")
            self.cnet = SmallEncoder(config.cnet_dim, "none")
            self.update_block = SmallUpdateBlock(
                config.corr_feature_dim, config.hidden_dim, config.context_dim)
            return
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


def _check_grid(shape) -> None:
    if shape[1] % 8 or shape[2] % 8:
        raise ValueError(
            f"RAFT requires H and W divisible by 8, got {tuple(shape[1:3])}; "
            f"pad or resize the inputs.")


def check_images(image1, image2) -> Tuple[int, int, int]:
    """(B, H, W) of two [B, H, W, 3] image batches (arrays or tensors);
    raises unless their shapes agree and H and W are multiples of 8."""
    shape1, shape2 = tuple(image1.shape), tuple(image2.shape)
    if len(shape1) != 4 or shape1[3] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got {list(shape1)}")
    if shape2 != shape1:
        raise ValueError(f"image shapes differ: {shape1} vs {shape2}")
    _check_grid(shape1)
    return shape1[:3]


def check_sizes(sizes: torch.Tensor, B: int) -> torch.Tensor:
    """``sizes`` as int32, after checking it is an integer [B, 2]."""
    if tuple(sizes.shape) != (B, 2) or sizes.is_floating_point():
        raise ValueError(f"sizes must be an integer [B, 2] = {[B, 2]} "
                         f"tensor of live (h, w) per item, got "
                         f"{sizes.dtype} {list(sizes.shape)}")
    return sizes.to(torch.int32)


def _check_model_dtype(model: RAFT, config: RAFTConfig) -> None:
    """Every weight in the compute dtype; under ``quant='bf16w'`` the
    encoders' may also be stored bfloat16 (:func:`cast_encoder_weights`)."""
    want = compute_dtype(config)
    stored = {want, torch.bfloat16} if config.quant_weights else {want}
    for name, allowed in (("fnet", stored), ("cnet", stored),
                          ("update_block", {want})):
        got = next(getattr(model, name).parameters()).dtype
        if got not in allowed:
            raise ValueError(
                f"the model's {name} weights are {got}, compute_dtype="
                f"{config.compute_dtype!r} needs {want}: cast the model once "
                f"(model.to({want})) or build it with init_raft_torch(config)")


def _encode(encoder: nn.Module, x: torch.Tensor, config: RAFTConfig
            ) -> torch.Tensor:
    """An encoder's forward in the compute dtype; weights stored bfloat16
    under ``quant='bf16w'`` are up-cast for float32 compute first."""
    cdt = compute_dtype(config)
    if next(encoder.parameters()).dtype == cdt:
        return encoder(x)
    state = {k: v.to(cdt) for k, v in
             list(encoder.named_parameters()) + list(encoder.named_buffers())}
    return torch.func.functional_call(encoder, state, (x,))


def split_context(cnet: torch.Tensor, config: RAFTConfig):
    """The context encoder's output [B, h, w, hidden+ctx] NHWC -> the
    initial net ``tanh`` [B, h, w, hidden] (NHWC, contiguous) and the
    context ``relu`` [B, ctx, h, w] (NCHW channels_last), in the compute
    dtype."""
    cnet = cnet.to(compute_dtype(config))
    hid = config.hidden_dim
    net = torch.tanh(cnet[..., :hid]).contiguous()
    return net, to_nchw(torch.relu(cnet[..., hid:]).contiguous())


def encode_pair(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                config: RAFTConfig):
    """The encoders: one fnet pass over both frames (batch 2B), one cnet
    pass over frame 1, in ``config.compute_dtype``.  Returns fmap1, fmap2,
    inp (NCHW) and the initial net [B, h, w, hidden] (NHWC)."""
    B = image1.shape[0]
    cdt = compute_dtype(config)
    x1 = _preprocess(image1.float(), cdt)
    x2 = _preprocess(image2.float(), cdt)
    fmaps = _encode(model.fnet, torch.cat([x1, x2], dim=0), config)
    net, inp = split_context(to_nhwc(_encode(model.cnet, x1, config)), config)
    return fmaps[:B], fmaps[B:], net, inp


def _encode_frame(model: RAFT, image: torch.Tensor, config: RAFTConfig):
    x = _preprocess(image.float(), compute_dtype(config))
    return (to_nhwc(_encode(model.fnet, x, config)),
            to_nhwc(_encode(model.cnet, x, config)))


@torch.no_grad()
def encode_frame(model: RAFT, image: torch.Tensor, config: RAFTConfig):
    """Encode one frame for sequential (video) inference: image [B, H, W, 3]
    in [0, 1] -> ``(fmap, cnet)``, the fnet map [B, H/8, W/8, fnet_dim] and
    the raw context-encoder output [B, H/8, W/8, hidden+ctx], NHWC, in the
    compute dtype: what :func:`raft_forward` computes for the frame.
    ``fmap`` is frame 2's map on this step and frame 1's on the next;
    ``cnet`` the context when this frame is frame 1."""
    check_port_support(config)
    _check_model_dtype(model, config)
    _check_grid(image.shape)
    return _encode_frame(model, image, config)


class Core(NamedTuple):
    """What the recurrent core reads: fmap1, fmap2 [B, C, h, w] and inp
    [B, ctx, h, w] NCHW, net [B, h, w, hidden] NHWC; flow_init [B, h, w, 2]
    float32, active [B] bool and sizes8 [B, 2] int32, each or None."""
    fmap1: torch.Tensor
    fmap2: torch.Tensor
    net: torch.Tensor
    inp: torch.Tensor
    flow_init: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    sizes8: Optional[torch.Tensor] = None


def _pair_core(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
               config: RAFTConfig, flow_init=None, sizes=None) -> Core:
    """The encoders of a pairwise request; a ragged batch's images are
    masked to zero outside the crops first, so each item's flow depends
    only on its crop."""
    sizes8 = None
    if sizes is not None:
        image1 = mask_ragged_rows(image1, sizes)
        image2 = mask_ragged_rows(image2, sizes)
        sizes8 = sizes // 8
    fmap1, fmap2, net, inp = encode_pair(model, image1, image2, config)
    return Core(fmap1, fmap2, net, inp, flow_init, None, sizes8)


def _features_core(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   cnet1: torch.Tensor, config: RAFTConfig, flow_init=None,
                   active=None, sizes8=None) -> Core:
    """The core's inputs from NHWC features (the streaming entries)."""
    net, inp = split_context(cnet1, config)
    return Core(to_nchw(fmap1.contiguous()), to_nchw(fmap2.contiguous()), net,
                inp, flow_init, active, sizes8)


@torch.no_grad()
def raft_forward(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                 config: RAFTConfig, iters: Optional[int] = None,
                 all_flows: bool = False,
                 flow_init: Optional[torch.Tensor] = None,
                 sizes: Optional[torch.Tensor] = None) -> RAFTOutput:
    """Eval-mode RAFT on the device of the inputs (``train=False`` of the
    JAX function).  image1/image2 [B, H, W, 3] float32 in [0, 1], H and W
    multiples of 8; ``flow_init`` [B, H/8, W/8, 2] or None.  ``config``
    selects the paths and the iteration policy; ``model`` holds the
    weights.

    ``sizes`` (integer [B, 2], optional) makes the batch ragged: item b is
    a corner-anchored ``sizes[b] = (h, w)`` crop of the ``H x W`` max box
    (need not be multiples of 8).  The images are masked to zero outside
    the crops, the correlation runs on each crop alone, and the flow is
    valid on ``[:h, :w]`` of each item."""
    check_port_support(config)
    _check_model_dtype(model, config)
    B = check_images(image1, image2)[0]
    if sizes is not None:
        sizes = check_sizes(torch.as_tensor(sizes, device=image1.device), B)
    core = _pair_core(model, image1, image2, config, flow_init, sizes)
    return _iterate_flow(model, *core[:4], config,
                         config.iters if iters is None else iters, all_flows,
                         flow_init, core.sizes8)


@torch.no_grad()
def forward_from_features(model: RAFT, fmap1: torch.Tensor,
                          fmap2: torch.Tensor, cnet1: torch.Tensor,
                          config: RAFTConfig, iters: Optional[int] = None,
                          flow_init: Optional[torch.Tensor] = None,
                          active: Optional[torch.Tensor] = None,
                          sizes8: Optional[torch.Tensor] = None
                          ) -> RAFTOutput:
    """The recurrent core from precomputed features: ``fmap1``/``fmap2``
    the :func:`encode_frame` maps of the two frames and ``cnet1`` frame 1's
    context output, NHWC (cast to the compute dtype); ``flow_init``
    [B, h, w, 2] (``ops/warmstart.py::warm_start_seed``), ``active`` [B]
    bool (False: a padding row, frozen from the start, ``iters_used`` 0)
    and ``sizes8`` [B, 2] int32 live (h, w) per item on the 1/8 grid (a
    ragged batch), each or None.  What :func:`raft_forward` computes on
    the frames the features came from."""
    check_port_support(config)
    _check_model_dtype(model, config)
    core = _features_core(fmap1, fmap2, cnet1, config, flow_init, active, sizes8)
    return _iterate_flow(model, *core[:4], config,
                         config.iters if iters is None else iters, False,
                         flow_init, sizes8, active)


class LoopState(NamedTuple):
    """What every GRU iteration reads: the lookup closure, the hoisted
    context terms and in-loop GRU weights (the SepConvGRU's fused ones, or
    the small ConvGRU's; both None for the un-hoisted GRU, which reads the
    context ``inp`` instead), the GRU kernel's weights (CUDA and
    ``gru_impl='pallas'`` only, else None) and the base coordinates."""
    lookup: object
    gru_ctx: Optional[tuple]
    gru_weights: Optional[dict]
    gru_kernel_weights: Optional[dict]
    coords0: torch.Tensor
    inp: Optional[torch.Tensor] = None


def prepare_loop(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 inp: torch.Tensor, config: RAFTConfig,
                 sizes8: Optional[torch.Tensor] = None) -> LoopState:
    """Loop-invariant work, once per forward.  fmap1/fmap2 [B, C, h, w]
    and inp [B, ctx, h, w] NCHW; ``sizes8`` [B, 2] int32 live (h, w) per
    item on the 1/8 grid for a ragged batch, else None.  The lookup's
    operands are float32 maps (bfloat16-rounded under
    ``corr_precision='default'``), whatever the compute dtype; a ragged
    batch under 'dense' or 'blockwise' takes the masked plain twin, as in
    JAX (the volume has no ragged form).  The context terms are hoisted
    unless ``gru_ctx_hoist=False`` under ``gru_impl='xla'``."""
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
    elif config.corr_impl == "dense":
        pyramid = build_pyramid(*lookup_operands(f1, f2, L, prec))
        sample = (lookup_dense_onehot if config.corr_lookup == "onehot"
                  else lookup_dense)

        def lookup(coords):
            return sample(pyramid, coords, r)
    else:                                   # 'blockwise'
        f1p, levels = lookup_operands(f1, f2, L, prec)
        sample = (lookup_blockwise_onehot if config.corr_lookup == "onehot"
                  else lookup_ondemand)

        def lookup(coords):
            return sample(f1p, levels, coords, r)

    coords0 = coords_grid(B, h, w, device=f1.device)
    gru = model.update_block.gru
    if not (config.gru_ctx_hoist or config.gru_impl == "pallas"):
        return LoopState(lookup, None, None, None, coords0, inp)
    kw = None
    if config.small:
        fw = fuse_conv_gru_weights(gru, config.hidden_dim, config.context_dim)
    else:
        fw = fuse_gru_weights(gru, config.hidden_dim, config.context_dim)
        if config.gru_impl == "pallas" and f1.device.type == "cuda":
            # in the compute dtype: bfloat16 weights are bfloat16-exact by
            # type, so laying them out needs no check on the host
            cdt = compute_dtype(config)
            kw = prepare_gru_weights({k: v.to(cdt) for k, v in fw.items()},
                                     cdt)
    return LoopState(
        lookup=lookup,
        gru_ctx=precompute_gru_ctx(gru, inp, config.hidden_dim),
        gru_weights=fw, gru_kernel_weights=kw, coords0=coords0)


def _update(model: RAFT, config: RAFTConfig, loop: LoopState,
            net: torch.Tensor, coords1: torch.Tensor):
    """One GRU iteration's new net, flow update (float32 NHWC) and mask."""
    cdt = compute_dtype(config)
    corr = loop.lookup(coords1).to(cdt)
    flow = (coords1 - loop.coords0).to(cdt)
    net, mask, delta_flow = model.update_block(
        net, to_nchw(corr), to_nchw(flow), loop.gru_ctx, loop.gru_weights,
        gru_impl=config.gru_impl, gru_kernel_weights=loop.gru_kernel_weights,
        inp=loop.inp)
    return (net, to_nhwc(delta_flow).float(),
            None if mask is None else to_nhwc(mask))


def gru_step(model: RAFT, config: RAFTConfig, loop: LoopState,
             net: torch.Tensor, coords1: torch.Tensor):
    """One GRU iteration: lookup, motion encoder, GRU, heads.
    net [B, h, w, hidden] (compute dtype) and coords1 [B, h, w, 2] (float32)
    NHWC; returns the new (net, coords1, mask), mask NHWC [B, h, w, 576] in
    the compute dtype, or None for the small model (no mask head).  The
    float32 correlation and flow are cast to the compute dtype, the flow
    update back to float32 before it moves coords1."""
    net, delta, mask = _update(model, config, loop, net, coords1)
    return net, coords1 + delta, mask


def upsample_flow(config: RAFTConfig, flow_lr: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The full-resolution flow of a low-resolution one, float32: convex
    upsampling with ``mask`` (full model), ``upflow8`` (small model)."""
    if config.small:
        return upflow8(flow_lr.float())
    return convex_upsample_flow(flow_lr, mask.float())


class Carry:
    """The converge loop's state between iterations: the loop's
    invariants (``loop``), net, coords1 and mask, ``converged`` [B] bool,
    ``nused`` [B] int32, the iteration counter ``i`` (a device int32, so
    that one captured iteration serves every ``i``), ``flag`` =
    all(converged) as a 1-element bool tensor, and the entry's ``extras``.
    :func:`converge_begin` writes it, :func:`converge_step` updates its
    tensors in place."""


def converge_begin(carry: Carry, model: RAFT, config: RAFTConfig,
                   core: Core) -> None:
    """The converge loop's initial state: padding rows (``active`` False)
    start converged, so they never extend the loop and count 0."""
    loop = prepare_loop(model, core.fmap1, core.fmap2, core.inp, config,
                        core.sizes8)
    c0 = loop.coords0
    B, h, w, _ = c0.shape
    carry.loop = loop
    carry.net = core.net.clone()
    carry.coords1 = (c0.clone() if core.flow_init is None
                     else c0 + core.flow_init.float())
    carry.mask = None if config.small else torch.zeros(
        (B, h, w, 64 * 9), dtype=compute_dtype(config), device=c0.device)
    carry.converged = (torch.zeros(B, dtype=torch.bool, device=c0.device)
                       if core.active is None else ~core.active.bool())
    carry.nused = torch.zeros(B, dtype=torch.int32, device=c0.device)
    carry.i = torch.zeros((), dtype=torch.int32, device=c0.device)
    carry.flag = carry.converged.all().reshape(1)


def converge_step(carry: Carry, model: RAFT, config: RAFTConfig, eps: float,
                  min_iters: int) -> None:
    """One masked iteration, in place: the rows not yet converged take the
    iteration's net, coords and mask, the others keep theirs; a live row
    converges when its ``dn`` (the mean over the grid of the L2 norm of its
    flow update, float32) is below ``eps`` and ``i + 1 >= min_iters``.
    ``eps = 0`` never fires (a norm is never < 0): every row takes every
    iteration's values, bit for bit those of the fixed policy."""
    act = ~carry.converged
    net, delta, mask = _update(model, config, carry.loop, carry.net,
                               carry.coords1)
    dn = delta.square().sum(dim=-1).sqrt().mean(dim=(1, 2))
    a = act[:, None, None, None]
    carry.coords1.copy_(torch.where(a, carry.coords1 + delta, carry.coords1))
    carry.net.copy_(torch.where(a, net, carry.net))
    if carry.mask is not None:
        carry.mask.copy_(torch.where(a, mask, carry.mask))
    carry.converged |= act & (dn < eps) & (carry.i + 1 >= min_iters)
    carry.nused += act.to(torch.int32)
    carry.i += 1
    carry.flag.copy_(carry.converged.all().reshape(1))


def converge_output(config: RAFTConfig, carry: Carry) -> RAFTOutput:
    flow_lr = carry.coords1 - carry.loop.coords0
    return RAFTOutput(flow=upsample_flow(config, flow_lr, carry.mask),
                      flow_iters=None, flow_lr=flow_lr,
                      iters_used=carry.nused)


def converge_iterations(iters: int, min_iters: int, step: Callable[[], None],
                        all_converged: Callable[[], bool]) -> int:
    """Run ``step`` until every row has converged, at most ``iters`` times;
    returns how many ran, which is max(iters_used).  ``all_converged``
    reads the device's flag on the host (a sync): before the first
    iteration (a batch of padding rows runs none) and after each from
    ``min_iters`` on; before that no row can converge."""
    for i in range(iters):
        if (i == 0 or i >= min_iters) and all_converged():
            return i
        step()
    return iters


def _iterate_flow(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                  net: torch.Tensor, inp: torch.Tensor, config: RAFTConfig,
                  iters: int, all_flows: bool,
                  flow_init: Optional[torch.Tensor],
                  sizes8: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None) -> RAFTOutput:
    """The recurrent core.  fmap1/fmap2 [B, C, h, w] and inp [B, ctx, h, w]
    NCHW; net [B, h, w, hidden] NHWC; ``sizes8`` as in :func:`prepare_loop`;
    ``active`` [B] bool or None (every row real).  Under a converge policy
    the loop exits on a host check (:func:`converge_iterations`), except
    with ``all_flows``, where it runs masked over all ``iters`` iterations
    and emits each one's flow, as JAX's masked scan."""
    policy, eps, min_iters = parse_iters_policy(config.iters_policy)
    core = Core(fmap1, fmap2, net, inp, flow_init, active, sizes8)
    if policy == "converge":
        carry = Carry()
        converge_begin(carry, model, config, core)

        def step():
            converge_step(carry, model, config, eps, min_iters)
        if not all_flows:
            converge_iterations(iters, min_iters, step,
                                lambda: bool(carry.flag))
            return converge_output(config, carry)
        flows = []
        for _ in range(iters):
            step()
            flows.append(upsample_flow(
                config, carry.coords1 - carry.loop.coords0, carry.mask))
        flow_iters = torch.stack(flows)
        return converge_output(config, carry)._replace(
            flow=flow_iters[-1], flow_iters=flow_iters)

    loop = prepare_loop(model, fmap1, fmap2, inp, config, sizes8)
    coords0 = loop.coords0
    coords1 = coords0 if flow_init is None else coords0 + flow_init.float()
    B, h, w, _ = coords0.shape
    mask = None if config.small else torch.zeros(
        (B, h, w, 64 * 9), dtype=compute_dtype(config), device=coords0.device)
    flows = []
    for _ in range(iters):
        net, coords1, mask = gru_step(model, config, loop, net, coords1)
        if all_flows:
            flows.append(upsample_flow(config, coords1 - coords0, mask))

    flow_lr = coords1 - coords0
    if all_flows:
        flow_iters = torch.stack(flows)
        final = flow_iters[-1]
    else:
        flow_iters = None
        final = upsample_flow(config, flow_lr, mask)
    iters_used = torch.full((B,), iters, dtype=torch.int32,
                            device=coords0.device)
    if active is not None:                  # padding rows spent nothing real
        iters_used = torch.where(active.bool(), iters_used, 0)
    return RAFTOutput(flow=final, flow_iters=flow_iters, flow_lr=flow_lr,
                      iters_used=iters_used)


# -- the storage formats of quant -------------------------------------------

def cast_encoder_weights(model: RAFT, config: RAFTConfig) -> RAFT:
    """``quant='bf16w'``: cast the fnet and cnet modules' weights and
    statistics to bfloat16 in place, once (the update block stays as it
    is), and return the model; the forward up-casts them for float32
    compute, so its numerics are those of bfloat16-rounded encoder
    weights.  A no-op for the other ``quant`` values."""
    if config.quant_weights:
        model.fnet.to(torch.bfloat16)
        model.cnet.to(torch.bfloat16)
    return model


def quantize_rows(rows: torch.Tensor):
    """Symmetric per-channel int8 quantization of feature rows
    ``[..., H, W, C]`` -> ``(int8 vals [..., H, W, C], float32 scales
    [..., C])``, the absmax over the spatial dims mapped to 127 (floored at
    1e-12, so an all-zero channel stays exact 0), rounded half to even,
    as the JAX package's ``quantize_rows``.  The divisions are true float32
    divisions on every device (a divisor made on the device: CUDA turns a
    host scalar divisor into a reciprocal multiply)."""
    rows = rows.float()
    absmax = rows.abs().amax(dim=(-3, -2))
    scales = absmax.clamp_min(1e-12) / torch.full((), 127.0, device=rows.device)
    q = torch.round(rows / scales[..., None, None, :])
    return q.clamp(-127, 127).to(torch.int8), scales


def dequantize_rows(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (float32)."""
    return vals.float() * scales[..., None, None, :]


# -- the entry points -------------------------------------------------------

@contextlib.contextmanager
def tf32_off():
    """cuDNN's convolutions and cuBLAS's matmuls in IEEE float32 (TF32 off)
    inside the block; the caller's two switches are restored after it,
    whether it returns or raises.  The switches are the process-wide
    ``torch.backends.cudnn.allow_tf32`` (PyTorch's default: True) and
    ``torch.backends.cuda.matmul.allow_tf32``.  They choose the math of a
    kernel when it is launched from Python, so for a captured CUDA graph
    they matter while it is captured (and during its eager warm-up); a
    replay runs what was captured, whatever they say then."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def _forward_mode(config: RAFTConfig):
    """No autograd, and :func:`tf32_off` for a float32 configuration."""
    with torch.no_grad(), (tf32_off() if compute_dtype(config) == torch.float32
                           else contextlib.nullcontext()):
        yield


class Forward:
    """An entry point's forward on device tensors: ``front(model, *args) ->
    (Core, extras)`` (the encoders, and what the entry gathers), the
    recurrent core under the configuration's policy, then ``pack(out,
    extras)`` (the entry's outputs).  Called, it runs eager; :meth:`begin`,
    :meth:`step` and :meth:`end` are the converge loop's three parts
    (``models/capture.py`` captures each as a graph) and :meth:`iterate`
    its host loop.  Every part runs under :func:`_forward_mode`."""

    def __init__(self, config: RAFTConfig, iters: Optional[int], front, pack):
        self.config = config
        self.iters = config.iters if iters is None else iters
        self.front, self.pack = front, pack
        policy, self.eps, self.min_iters = parse_iters_policy(config.iters_policy)
        self.adaptive = policy == "converge"

    def __call__(self, model: RAFT, *args):
        with _forward_mode(self.config):
            core, extras = self.front(model, *args)
            out = _iterate_flow(model, *core[:4], self.config, self.iters,
                                False, core.flow_init, core.sizes8, core.active)
            return self.pack(out, extras)

    def new_carry(self) -> Carry:
        return Carry()

    def begin(self, carry: Carry, model: RAFT, *args) -> tuple:
        with _forward_mode(self.config):
            core, carry.extras = self.front(model, *args)
            converge_begin(carry, model, self.config, core)
        return ()

    def step(self, carry: Carry, model: RAFT) -> tuple:
        with _forward_mode(self.config):
            converge_step(carry, model, self.config, self.eps, self.min_iters)
        return ()

    def end(self, carry: Carry):
        with _forward_mode(self.config):
            return self.pack(converge_output(self.config, carry), carry.extras)

    def iterate(self, carry: Carry, step: Callable[[], None]) -> int:
        return converge_iterations(self.iters, self.min_iters, step,
                                   lambda: bool(carry.flag))


def _check_stream(image, maps, flow_init=None, slots=None, active=None,
                  sizes=None):
    """Shapes of a streaming call; returns ``sizes`` as int32, or None."""
    B = image.shape[0]
    check_images(image, image)
    grid = (image.shape[1] // 8, image.shape[2] // 8)
    for name, m in maps:
        if tuple(m.shape[-3:-1]) != grid:
            raise ValueError(f"{name} {list(m.shape)} is not on the frames' "
                             f"1/8 grid {list(grid)}")
    if flow_init is not None and tuple(flow_init.shape) != (B, *grid, 2):
        raise ValueError(f"flow_init must be {[B, *grid, 2]}, got "
                         f"{list(flow_init.shape)}")
    for name, t, integer in (("slots", slots, True), ("active", active, False)):
        if t is not None and (tuple(t.shape) != (B,) or (
                integer and torch.as_tensor(t).is_floating_point())):
            raise ValueError(f"{name} must be a [{B}] "
                             f"{'integer' if integer else 'bool'} tensor, got "
                             f"{list(t.shape)}")
    return None if sizes is None else check_sizes(torch.as_tensor(sizes), B)


def _gather_rows(buf, slots: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``slots`` of a slot-pool buffer (``buf[slots]``), dequantized
    from an ``(int8 vals, float32 scales)`` pair, in ``dtype``."""
    if isinstance(buf, (tuple, list)):
        return dequantize_rows(buf[0].index_select(0, slots),
                               buf[1].index_select(0, slots)).to(dtype)
    return buf.index_select(0, slots)


class Entry(NamedTuple):
    """An entry point's parts: the :class:`Forward` (the encoder entry's:
    a plain callable, which has no loop); ``spec``, per
    argument its dtype on the device (None: its own) or ``BY_ADDRESS`` (a
    tensor, or a pair, read in place on the model's device); ``validate(
    *args)``, which checks the caller's arguments (arrays or tensors) and
    returns them normalized."""
    forward: Callable
    spec: tuple
    validate: Callable


def _factory(config: RAFTConfig, device, entry: Entry):
    """``run(model, *args)`` on ``device`` (CUDA unless ``device="cpu"``):
    on CUDA a :class:`~raft_tpu_torch.models.capture.GraphedForward` (a
    converge policy captured in three parts), on the CPU the eager
    forward."""
    dev = resolve_device(device)
    check_port_support(config)
    forward, spec, validate = entry

    def check(model: RAFT) -> None:
        p = next(model.parameters())
        if p.device.type != dev.type:
            raise ValueError(f"model is on {p.device}, the inference "
                             f"function on {dev}")
        _check_model_dtype(model, config)

    if dev.type == "cuda":
        adaptive = isinstance(forward, Forward) and forward.adaptive
        return GraphedForward(forward, check, spec, validate,
                              staged=forward if adaptive else None)

    def run(model: RAFT, *args):
        check(model)
        args = validate(*args)
        return forward(model, *as_inputs(args, spec,
                                         next(model.parameters()).device))
    return run


def _pair_entry(config: RAFTConfig, iters: Optional[int], ragged: bool
                ) -> Entry:
    """The pairwise entries: ``(model, image1, image2[, sizes]) ->
    RAFTOutput``, what :func:`raft_forward` computes."""
    def front(model, image1, image2, sizes=None):
        return _pair_core(model, image1, image2, config, None, sizes), None

    def validate(image1, image2, *sizes):
        if bool(sizes) != ragged or len(sizes) > 1:
            raise ValueError("a ragged entry takes sizes, a pairwise one none")
        B = check_images(image1, image2)[0]
        if ragged:
            return image1, image2, check_sizes(torch.as_tensor(sizes[0]), B)
        return image1, image2

    spec = (torch.float32, torch.float32) + ((torch.int32,) if ragged else ())
    return Entry(Forward(config, iters, front, lambda out, _: out), spec,
                 validate)


def _graphs(run):
    return run if isinstance(run, GraphedForward) else None


def make_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                      device=None):
    """``fn(model, image1, image2) -> flow`` [B, H, W, 2] on ``device``
    (CUDA unless ``device="cpu"``).  Images are [B, H, W, 3] in [0, 1],
    numpy arrays or tensors; they are moved to the device.  On CUDA each
    (model, batch, H, W) is captured once as a CUDA graph and replayed
    (``models/capture.py``; ``fn.graphs`` is the
    :class:`~raft_tpu_torch.models.capture.GraphedForward`, None on the
    CPU); each call returns a fresh tensor."""
    run = _factory(config, device, _pair_entry(config, iters, False))

    def fn(model: RAFT, image1, image2) -> torch.Tensor:
        return run(model, image1, image2).flow

    fn.graphs = _graphs(run)
    return fn


def make_counted_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                              device=None):
    """As :func:`make_inference_fn`, returning ``(flow, iters_used)``,
    iters_used [B] int32: each sample's live iterations (``iters`` under
    the fixed policy, fewer for a sample a converge policy froze)."""
    run = _factory(config, device, _pair_entry(config, iters, False))

    def fn(model: RAFT, image1, image2):
        out = run(model, image1, image2)
        return out.flow, out.iters_used

    fn.graphs = _graphs(run)
    return fn


def make_ragged_inference_fn(config: RAFTConfig, iters: Optional[int] = None,
                             device=None):
    """``fn(model, image1, image2, sizes) -> flow`` [B, H, W, 2] for a
    ragged mixed-resolution batch on ``device`` (CUDA unless
    ``device="cpu"``): images [B, H, W, 3] in [0, 1] hold each item
    corner-anchored in the shared max box (``data.pipeline.embed_to_shape``),
    ``sizes`` [B, 2] integer the items' full-resolution (h, w).  Item b's
    flow is valid on ``[:sizes[b, 0], :sizes[b, 1]]``.  On CUDA one graph
    per (model, box, batch) serves every ``sizes``, as
    :func:`make_inference_fn` captures."""
    run = _factory(config, device, _pair_entry(config, iters, True))

    def fn(model: RAFT, image1, image2, sizes) -> torch.Tensor:
        return run(model, image1, image2, sizes).flow

    fn.graphs = _graphs(run)
    return fn


def make_ragged_counted_inference_fn(config: RAFTConfig,
                                     iters: Optional[int] = None,
                                     device=None):
    """As :func:`make_ragged_inference_fn`, returning ``(flow,
    iters_used)`` as :func:`make_counted_inference_fn`."""
    run = _factory(config, device, _pair_entry(config, iters, True))

    def fn(model: RAFT, image1, image2, sizes):
        out = run(model, image1, image2, sizes)
        return out.flow, out.iters_used

    fn.graphs = _graphs(run)
    return fn


def make_encode_fn(config: RAFTConfig, device=None):
    """``fn(model, image) -> (fmap, cnet)`` (:func:`encode_frame`) on
    ``device``, captured on CUDA as the fixed factories are: a session's
    first frame."""
    def validate(image):
        check_images(image, image)
        return (image,)

    def encode(model, image):
        with _forward_mode(config):
            return _encode_frame(model, image, config)

    run = _factory(config, device, Entry(encode, (torch.float32,), validate))

    def fn(model: RAFT, image):
        return run(model, image)

    fn.graphs = _graphs(run)
    return fn


def _stream_pack(config: RAFTConfig):
    adaptive = adaptive_iters(config.iters_policy)

    def pack(out, extras):
        fmap_cur, cnet_cur = extras
        res = (out.flow, out.flow_lr, fmap_cur, cnet_cur)
        return res + (out.iters_used,) if adaptive else res
    return pack


def _stream_entry(config: RAFTConfig, iters: Optional[int], ragged: bool
                  ) -> Entry:
    """The solo stream step, ``(model, image, fmap_prev, cnet_prev,
    flow_init[, sizes])``: every argument copied into the graph's buffers."""
    def front(model, image, fmap_prev, cnet_prev, flow_init, sizes=None):
        sizes8 = None
        if sizes is not None:
            image, sizes8 = mask_ragged_rows(image, sizes), sizes // 8
        fmap_cur, cnet_cur = _encode_frame(model, image, config)
        return (_features_core(fmap_prev, fmap_cur, cnet_prev, config,
                               flow_init, None, sizes8),
                (fmap_cur, cnet_cur))

    def validate(image, fmap_prev, cnet_prev, flow_init, *sizes):
        if bool(sizes) != ragged or len(sizes) > 1:
            raise ValueError("a ragged stream step takes sizes, a dense one none")
        sz = _check_stream(image, (("fmap_prev", fmap_prev),
                                   ("cnet_prev", cnet_prev)), flow_init,
                           sizes=sizes[0] if ragged else None)
        return (image, fmap_prev, cnet_prev, flow_init) + (
            (sz,) if ragged else ())

    spec = (torch.float32, None, None, torch.float32) + (
        (torch.int32,) if ragged else ())
    return Entry(Forward(config, iters, front, _stream_pack(config)), spec,
                 validate)


def _stream_batch_entry(config: RAFTConfig, iters: Optional[int],
                        ragged: bool) -> Entry:
    """The continuous-batched stream step, ``(model, images, fmap_buf,
    cnet_buf, flow_buf, slots, active[, sizes])``: images, slots, active
    (and sizes) copied in, the pool's buffers read in place."""
    def front(model, images, fmap_buf, cnet_buf, flow_buf, slots, active,
              sizes=None):
        sizes8 = None
        if sizes is not None:
            images, sizes8 = mask_ragged_rows(images, sizes), sizes // 8
        fmap_cur, cnet_cur = _encode_frame(model, images, config)
        fmap_prev = _gather_rows(fmap_buf, slots, fmap_cur.dtype)
        cnet_prev = _gather_rows(cnet_buf, slots, cnet_cur.dtype)
        return (_features_core(fmap_prev, fmap_cur, cnet_prev, config,
                               flow_buf.index_select(0, slots), active,
                               sizes8),
                (fmap_cur, cnet_cur))

    def validate(images, fmap_buf, cnet_buf, flow_buf, slots, active, *sizes):
        if bool(sizes) != ragged or len(sizes) > 1:
            raise ValueError("a ragged stream step takes sizes, a dense one none")
        pairs = [isinstance(b, (tuple, list)) for b in (fmap_buf, cnet_buf)]
        if pairs != [config.quant_slots] * 2:
            raise ValueError(
                f"quant={config.quant!r}: the fmap and cnet buffers must be "
                + ("(int8 vals, scales) pairs" if config.quant_slots
                   else "tensors"))
        maps = (("fmap_buf", fmap_buf[0] if pairs[0] else fmap_buf),
                ("cnet_buf", cnet_buf[0] if pairs[1] else cnet_buf),
                ("flow_buf", flow_buf))
        sz = _check_stream(images, maps, slots=slots, active=active,
                           sizes=sizes[0] if ragged else None)
        return (images, fmap_buf, cnet_buf, flow_buf, slots, active) + (
            (sz,) if ragged else ())

    spec = (torch.float32, BY_ADDRESS, BY_ADDRESS, BY_ADDRESS, torch.int32,
            torch.bool) + ((torch.int32,) if ragged else ())
    return Entry(Forward(config, iters, front, _stream_pack(config)), spec,
                 validate)


def _stream_fn(config: RAFTConfig, device, entry: Entry):
    run = _factory(config, device, entry)

    def fn(model: RAFT, *args):
        return run(model, *args)

    fn.graphs = _graphs(run)
    return fn


def make_stream_step_fn(config: RAFTConfig, iters: Optional[int] = None,
                        device=None):
    """``fn(model, image, fmap_prev, cnet_prev, flow_init) -> (flow,
    flow_lr, fmap_cur, cnet_cur[, iters_used])``: one call advances a video
    session by one frame, one encoder pass (the current frame's; the
    previous frame's maps arrive as arguments, from :func:`encode_frame` or
    the last step), correlation fmap_prev x fmap_cur, context cnet_prev,
    seed ``flow_init`` [B, h, w, 2].  ``iters_used`` is appended under a
    converge policy.  On CUDA captured as :func:`make_inference_fn` is,
    every argument copied into the graph's buffers."""
    return _stream_fn(config, device, _stream_entry(config, iters, False))


def make_stream_batch_step_fn(config: RAFTConfig, iters: Optional[int] = None,
                              device=None):
    """``fn(model, images [b, H, W, 3], fmap_buf [cap+1, h, w, C], cnet_buf
    [cap+1, h, w, D], flow_buf [cap+1, h, w, 2], slots [b] int32, active
    [b] bool) -> (flow, flow_lr, fmap_cur, cnet_cur[, iters_used])``: one
    call advances ``b`` sessions by one frame each, row ``i`` gathering its
    session's cached maps and seed from slot ``slots[i]`` of the pool's
    buffers (``buf[slots]``).  Under ``quant='int8'`` fmap_buf and cnet_buf
    are ``(int8 vals, float32 scales)`` pairs (:func:`quantize_rows`),
    dequantized on gather; flow_buf stays float32.  Padding rows carry
    ``active`` False (frozen from the start under a converge policy,
    ``iters_used`` 0).  The current maps come back as rows for the caller
    to commit.  On CUDA the buffers are read in place, by address: a call
    with buffers at other addresses captures anew."""
    return _stream_fn(config, device,
                      _stream_batch_entry(config, iters, False))


def make_ragged_stream_step_fn(config: RAFTConfig,
                               iters: Optional[int] = None, device=None):
    """Ragged twin of :func:`make_stream_step_fn`: ``fn(model, image,
    fmap_prev, cnet_prev, flow_init, sizes)``, every array at the max box,
    ``sizes`` [B, 2] integer full-resolution live (h, w).  The current
    frame is masked outside its crop before encoding; the correlation
    takes the ragged path (the ragged kernel under 'pallas')."""
    return _stream_fn(config, device, _stream_entry(config, iters, True))


def make_ragged_stream_batch_step_fn(config: RAFTConfig,
                                     iters: Optional[int] = None, device=None):
    """Ragged twin of :func:`make_stream_batch_step_fn`: ``fn(model,
    images, fmap_buf, cnet_buf, flow_buf, slots, active, sizes)``, the
    buffers one max-box arena, ``sizes`` [b, 2] the rows' live extents."""
    return _stream_fn(config, device,
                      _stream_batch_entry(config, iters, True))
