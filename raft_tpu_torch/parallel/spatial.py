"""Row sharding: the sequence-parallel form of the correlation workload.

The port of the JAX package's ``parallel/spatial.py``.  RAFT's ``(HW)^2``
correlation is long-context attention (queries: fmap1's pixels, keys:
fmap2's); at high resolution the ranks each take a slab of the image rows
(the queries), and the keys come to them.  Two ways:

* :func:`make_spatial_corr_lookup` gathers fmap2 to every rank, then looks
  up the local queries against all of it;
* the ring (:func:`make_ring_lookup_local`, :func:`make_ring_corr_lookup`)
  correlates the local queries with one fmap2 slab at a time, accumulates
  that slab's window contributions (zero outside the slab, so the partials
  sum to the whole lookup) and passes the slab's pyramid to the next rank:
  ``n - 1`` rotations a lookup, each overlapped with the next slab's
  compute, and two slab pyramids the most a rank holds.  Under
  ``kernel='pallas'`` each slab's partial is one call of a CUDA lookup
  kernel (``ops/corr_cuda.py``: B1, B3 under ``p_select='window'``, B5 under
  ``pack_rows``) with the query coordinates shifted down by the slab's
  first row: the kernel's own scaling by ``1/2^l`` lands the shift on the
  slab's first row at every level, and its windows read zeros off the
  slab, so the unchanged kernel gives exactly that slab's partial.  On CPU
  tensors the same wrappers run their plain versions.

The whole model row-sharded is :func:`make_shard_inference_fn`: the
unchanged model code under ``ops/spmd.py::spatial_sharding`` (halo'd
convolutions, instance norms over the whole image, the ring lookup,
halo'd upsampling).  On CUDA over NCCL it is captured as a CUDA graph,
its collectives inside; under gloo, whose collectives stage through the
host and cannot be captured, it runs eagerly.  The same ops run under
autograd in the row-sharded train step (``training/step.py``): the ring's
slab pyramids come back along the inverse ring as their cotangents, and
each kernel's backward is its twin's vjp on its slab.  The JAX package's
:func:`make_spatial_inference_fn`
leaves the collectives to XLA's SPMD partitioner; the port has none, so it
runs the same explicit collectives around the same forward.

Constraint: H divisible by :func:`required_h_multiple`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import RAFTConfig
from ..ops import spmd
from ..ops.corr import (build_pyramid, dense_corr, lookup_dense,
                        lookup_operands, lookup_partial_onehot)
from .mesh import SPATIAL_AXIS, Mesh, capturable

# the TPU kernels' tiling knobs (no value changes here) and the two that
# choose the CUDA kernel
PALLAS_OPTS = {"q_blk": 128, "p_blk_target": 4096, "lookup_style": "matmul",
               "p_select": "all", "pack_rows": False}


def required_h_multiple(config: RAFTConfig, n_devices: int) -> int:
    """The multiple H must be of for row-sharded inference over
    ``n_devices`` ranks: the 1/8 feature stem times the ring's per-slab
    pyramid pooling (each slab's H/8 divisible by 2^(corr_levels-1))."""
    return 8 * n_devices * 2 ** (config.corr_levels - 1)


def halo_exchange(x: torch.Tensor, halo: int, axis: spmd.Axis) -> torch.Tensor:
    """``ops/spmd.py::halo_exchange`` of an NHWC slab ([B, H, W, C] ->
    [B, H + 2*halo, W, C])."""
    return spmd.halo_exchange(x, halo, axis, dim=1)


def conv2d_row_sharded(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, stride: int = 1,
                       axis: Optional[spmd.Axis] = None) -> torch.Tensor:
    """conv2d of a row slab, NHWC ``x`` and HWIO ``w``: the H padding a
    halo exchange, symmetric zero padding in W."""
    axis = spmd.spatial_axis() if axis is None else axis
    kh, kw = w.shape[0], w.shape[1]
    xp = halo_exchange(x, kh // 2, axis).permute(0, 3, 1, 2)
    out = F.conv2d(xp, w.permute(3, 2, 0, 1), b, stride=stride,
                   padding=(0, kw // 2))
    return out.permute(0, 2, 3, 1)


def _pallas_opts(pallas_opts: Optional[dict]) -> dict:
    opts = {**PALLAS_OPTS, **(pallas_opts or {})}
    unknown = set(opts) - set(PALLAS_OPTS)
    if unknown:
        raise ValueError(f"unknown pallas_opts {sorted(unknown)}; known "
                         f"{sorted(PALLAS_OPTS)}")
    if opts["p_select"] not in ("all", "window"):
        raise ValueError(f"p_select must be 'all' or 'window', got "
                         f"{opts['p_select']!r}")
    return opts


def make_ring_lookup_local(f1_local: torch.Tensor, f2_local: torch.Tensor,
                           num_levels: int, radius: int, axis: spmd.Axis,
                           precision: str = "highest", kernel: str = "onehot",
                           pallas_opts: Optional[dict] = None):
    """The ring lookup's per-iteration closure ``lookup(coords) -> [B, Hl,
    W, L*(2r+1)^2]`` float32, for a rank holding the NHWC slabs
    ``f1_local`` and ``f2_local`` [B, Hl, W, C] and the query coordinates
    of its slab in global pixel units.

    ``kernel='onehot'``: each slab's partial is ``dense_corr`` of the local
    queries against the slab's level, sampled by ``lookup_partial_onehot``
    at the slab's row offset.  ``'pallas'``: one lookup wrapper's call per
    slab on the shifted coordinates (the module docstring):
    ``corr_cuda.fused_lookup`` (B1), ``window_lookup`` under
    ``p_select='window'`` (B3), ``packed_lookup`` under ``pack_rows`` (B5).
    ``precision``: ``corr_precision`` ('highest': float32 operands;
    'default': bfloat16-rounded ones, as ``ops/corr.py::lookup_operands``
    gives every lookup).  Each slab's pyramid is pooled on its own rank
    (so Hl must divide by 2^(num_levels-1))."""
    if kernel not in ("onehot", "pallas"):
        raise ValueError(f"kernel must be 'onehot' or 'pallas', "
                         f"got {kernel!r}")
    opts = _pallas_opts(pallas_opts)
    n, my = axis.size, axis.index
    B, Hl, W, C = f1_local.shape
    if Hl % (2 ** (num_levels - 1)) != 0:
        raise ValueError(
            f"local H/8 slab {Hl} must be divisible by 2^{num_levels - 1} "
            f"so pyramid pooling stays shard-local; use fewer devices or "
            f"pad H (H/8 divisible by n_dev * 2^(levels-1)).")
    f1, levels0 = lookup_operands(f1_local, f2_local, num_levels, precision)
    perm = [(i, (i + 1) % n) for i in range(n)]
    if kernel == "pallas":
        from ..ops.corr_cuda import fused_lookup, packed_lookup, window_lookup
        if opts["pack_rows"]:
            def entry(levels, c):
                return packed_lookup(f1, levels, c, radius, opts["p_select"])
        elif opts["p_select"] == "window":
            def entry(levels, c):
                return window_lookup(f1, levels, c, radius)
        else:
            def entry(levels, c):
                return fused_lookup(f1, levels, c, radius)

    def contrib(levels, src: int, coords: torch.Tensor) -> torch.Tensor:
        if kernel == "pallas":
            # global -> slab rows: subtract the slab's first row (src * Hl
            # rows of the level-0 map); the kernel scales by 1/2^l itself
            shifted = coords.clone()
            shifted[..., 1] -= float(src * Hl)
            return entry(levels, shifted.contiguous())
        flat = coords.reshape(B, Hl * W, 2)
        outs = [lookup_partial_onehot(dense_corr(f1, lv), flat, radius, i,
                                      row_offset=src * lv.shape[1])
                for i, lv in enumerate(levels)]
        return torch.cat(outs, dim=-1).reshape(B, Hl, W, -1)

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        levels, src = levels0, my
        acc = torch.zeros((B, Hl, W, num_levels * (2 * radius + 1) ** 2),
                          dtype=torch.float32, device=f1.device)
        for _ in range(n - 1):
            # pass the slab pyramid on while this slab's partial computes
            pending = spmd.ppermute_start([(lv, perm) for lv in levels], axis)
            acc = acc + contrib(levels, src, coords)
            levels, src = pending.wait(), (src - 1) % n
        return acc + contrib(levels, src, coords)

    return lookup


def make_ring_corr_lookup(mesh: Mesh, num_levels: int, radius: int,
                          axis: str = SPATIAL_AXIS, precision: str = "highest",
                          kernel: str = "onehot",
                          pallas_opts: Optional[dict] = None):
    """The standalone ring lookup: ``fn(f1_local, f2_local, coords_local)
    -> [B, Hl, W, L*(2r+1)^2]``, every argument this rank's row slab (NHWC,
    coordinates in global pixels), options as :func:`make_ring_lookup_local`."""
    ax = mesh[axis]

    def fn(f1_local, f2_local, coords_local):
        with torch.no_grad():
            return make_ring_lookup_local(
                f1_local, f2_local, num_levels, radius, ax,
                precision=precision, kernel=kernel,
                pallas_opts=pallas_opts)(coords_local)
    return fn


def make_spatial_corr_lookup(mesh: Mesh, num_levels: int, radius: int,
                             axis: str = SPATIAL_AXIS,
                             precision: str = "highest"):
    """Distributed blockwise correlation, the gathering way: ``fn(f1_local,
    f2_local, coords_local)`` all-gathers fmap2's slabs, then samples the
    dense pyramid of the local queries against the whole of it
    (``lookup_dense``).  Memory O(HW/n * HW) a rank."""
    ax = mesh[axis]

    def fn(f1_local, f2_local, coords_local):
        with torch.no_grad():
            f2 = spmd.all_gather(f2_local, ax, dim=1)
            f1, levels = lookup_operands(f1_local, f2, num_levels, precision)
            return lookup_dense(build_pyramid(f1, levels), coords_local,
                                radius)
    return fn


def shard_rows(x, mesh: Mesh, axis: str = SPATIAL_AXIS) -> torch.Tensor:
    """This rank's row slab (dim 1) of a whole-image array, on its device;
    raises when the rows do not divide over the axis."""
    ax = mesh[axis]
    t = torch.as_tensor(x)
    if t.shape[1] % ax.size:
        raise ValueError(f"H {t.shape[1]} is not divisible by the "
                         f"{ax.size} ranks of axis {axis!r}")
    h = t.shape[1] // ax.size
    return t[:, ax.index * h:(ax.index + 1) * h].to(mesh.device)


def gather_rows(x: torch.Tensor, mesh: Mesh,
                axis: str = SPATIAL_AXIS) -> torch.Tensor:
    """Every rank's row slab (dim 1) together, on every rank."""
    return spmd.all_gather(x, mesh[axis], dim=1)


def check_rows(config: RAFTConfig, h_local: int, n: int,
               what: str = "inference") -> None:
    """Raise ValueError, in the JAX command line's words, unless the whole
    image's H (``h_local`` rows a rank, ``n`` ranks) is a multiple of
    :func:`required_h_multiple`."""
    need = required_h_multiple(config, n)
    h = h_local * n
    if h % need:
        raise ValueError(
            f"row-sharded {what} over {n} ranks requires H divisible by "
            f"{need} (8 * N devices * 2^(corr_levels-1)); got H={h}. "
            f"Pick the size accordingly, e.g. H={((h // need) + 1) * need}")


def make_shard_inference_fn(config: RAFTConfig, mesh: Mesh,
                            iters: Optional[int] = None,
                            axis: str = SPATIAL_AXIS):
    """Whole-model row-sharded inference: ``fn(model, image1_local,
    image2_local) -> flow_local``, images [B, H/n, W, 3] (this rank's rows,
    :func:`shard_rows`) -> this rank's rows of the flow [B, H/n, W, 2].
    ``model`` is this rank's copy of the weights, on its device.  The
    unchanged ``raft_forward`` runs under ``spatial_sharding`` (the module
    docstring), with TF32 off under ``compute_dtype='float32'``: on CUDA
    over NCCL (or one rank) captured as a CUDA graph per (model, batch,
    H, W), collectives inside it (``models/capture.py``; ``fn.graphs``),
    under gloo eagerly (``fn.graphs`` None).  What row-sharded inference
    does not run raises NotImplementedError with the JAX package's
    message: ``iters_policy='converge:*'``, ``gru_impl='pallas'``, ragged
    batches; an H that is not a multiple of :func:`required_h_multiple`
    raises ValueError."""
    from ..models.capture import GraphedForward
    from ..models.raft import _forward_mode, check_images, raft_forward
    ax = mesh[axis]

    def eager(model, im1, im2) -> tuple:
        with spmd.spatial_sharding(ax), _forward_mode(config):
            return (raft_forward(model, im1, im2, config, iters=iters,
                                 all_flows=False).flow,)

    def validate(image1, image2):
        check_images(image1, image2)
        check_rows(config, image1.shape[1], ax.size)
        return image1, image2

    if capturable(mesh, ax):
        def check(model) -> None:
            if next(model.parameters()).device.type != "cuda":
                raise ValueError("a captured shard forward needs the model "
                                 "on CUDA")
        graphed = GraphedForward(eager, check, (torch.float32,) * 2, validate)

        def fn(model, image1, image2) -> torch.Tensor:
            return graphed(model, image1, image2)[0]
        fn.graphs = graphed
        return fn

    def fn(model, image1, image2) -> torch.Tensor:
        im1 = torch.as_tensor(image1).to(mesh.device)
        im2 = torch.as_tensor(image2).to(mesh.device)
        validate(im1, im2)
        return eager(model, im1, im2)[0]
    fn.graphs = None
    return fn


def make_spatial_inference_fn(config: RAFTConfig, mesh: Mesh,
                              iters: Optional[int] = None,
                              axis: str = SPATIAL_AXIS):
    """Whole-model inference on whole images: ``fn(model, image1, image2)
    -> flow`` [B, H, W, 2] on every rank.  In the JAX package XLA's SPMD
    partitioner inserts the collectives; the port has no partitioner, so
    this runs :func:`make_shard_inference_fn` on this rank's rows
    (:func:`shard_rows`) and gathers the flow (:func:`gather_rows`): the
    same explicit collectives."""
    shard = make_shard_inference_fn(config, mesh, iters=iters, axis=axis)

    def fn(model, image1, image2) -> torch.Tensor:
        local = shard(model, shard_rows(image1, mesh, axis),
                      shard_rows(image2, mesh, axis))
        return gather_rows(local, mesh, axis)

    return fn
