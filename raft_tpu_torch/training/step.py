"""Train and eval steps: the JAX package's ``training/step.py``.

``make_train_step`` returns ``step(state, batch, seed) -> (state,
metrics)``: the training forward (``raft_forward(train=True)``), the
sequence loss, the gradients (autograd; through the kernels' wrappers
their backward is the plain twins' vjp, as the JAX package defines it),
then the optimizer (``training/optim.py``), all on the model's device,
updating the model and the optimizer's state in place.  The metrics are
0-dim device tensors; the step reads nothing back to the host, so it can
be captured as one CUDA graph (``training/capture.py``, what the loop
runs on CUDA; this eager step is what runs on the CPU).

The model holds float32 master weights under both compute dtypes: under
``compute_dtype='bfloat16'`` the forward casts them once
(``models/raft.py::MasterCast``), the gradients land in the float32
masters through the cast, and ``metrics['grad_norm']`` and the optimizer
run in float32 (the JAX package's step after the cast's transpose).

The whole step, forward, backward and optimizer, runs with TF32 off for
cuBLAS and cuDNN under both compute dtypes (:func:`precision`): the
switches are process-wide, and the kernels' backward (matrix products and
convolutions of the twins) runs on autograd's own thread after the
forward has returned, so holding them off for the forward alone would let
the backward's products round their operands to TF32.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..config import RAFTConfig, TrainConfig, adaptive_iters
from ..lint.contracts import contract
from ..models.raft import draw_dropout_masks, raft_forward, tf32_off
from ..ops import spmd
from .loss import sequence_loss
from .optim import Optimizer, all_finite
from .state import TrainState


class Batch(NamedTuple):
    image1: torch.Tensor           # [B, H, W, 3] float in [0, 1]
    image2: torch.Tensor
    flow: torch.Tensor             # [B, H, W, 2]
    valid: torch.Tensor            # [B, H, W] float/bool


def precision():
    """The TF32 switches of a train step, set explicitly (:func:`tf32_off`)
    under both compute dtypes, and the callers' restored after it.  No
    product of the step may take TF32: under float32 compute every product
    is float32; under bfloat16 the bfloat16 convolutions and products run
    in bfloat16 on the tensor cores whatever the switches say, and the
    float32 ones (the lookup twin's backward on the upcast bfloat16
    operands, the GRU twin's float32 convolutions, the convex upsampling,
    the loss) stay float32, as the JAX package computes them on the CPU
    (ROADMAP, "Deviations by design": on a TPU its 'default' precision
    rounds their float32 operands to bfloat16).  The eval steps take the
    same switches."""
    return tf32_off()


def _check_batch(batch: Batch) -> None:
    B, H, W = tuple(batch.image1.shape[:3])
    want = {"image1": (B, H, W, 3), "image2": (B, H, W, 3),
            "flow": (B, H, W, 2), "valid": (B, H, W)}
    for name, shape in want.items():
        got = tuple(getattr(batch, name).shape)
        if got != shape:
            raise ValueError(f"batch.{name} must be {list(shape)}, got "
                             f"{list(got)}")


def _on(batch, device: torch.device) -> Batch:
    return Batch(*(torch.as_tensor(x).to(device) for x in batch))


def pmean_tensors(tensors, axis: spmd.Axis, op=spmd.pmean) -> list:
    """The mean (``op=spmd.psum``: the sum) over ``axis``'s ranks of each
    tensor, as one all-reduce of their concatenation (a bucket), in their
    dtypes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = op(flat, axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def make_train_step(config: RAFTConfig, tconfig: TrainConfig,
                    tx: Optimizer, axis: Optional[spmd.Axis] = None,
                    spatial: Optional[spmd.Axis] = None):
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    ``batch``: a :class:`Batch` (or a 4-tuple) of tensors or arrays,
    moved to the model's device if they are elsewhere.  ``seed`` seeds
    the ``torch.Generator`` that channel dropout draws from (one per
    micro-batch); at ``config.dropout = 0`` nothing is drawn.

    With ``tconfig.accum_steps > 1`` the batch is split stride-major:
    micro-batch k takes samples k, k + accum, ... (the JAX package's
    split, which keeps each device's share local under data parallelism).
    The micro-batches run one after another; losses, metrics and
    gradients are averaged, and the batch-norm statistics update through
    them in turn.  With ``tconfig.skip_nonfinite_updates`` a step whose
    gradients are not all finite also puts the batch-norm statistics back
    as they were before it (the optimizer drops its update).
    ``metrics['grad_norm']`` is the gradients' global norm before
    clipping; under a converge policy ``metrics['mean_iters']`` is the
    mean of the samples' live iterations.

    ``axis``: the data axis of a data-parallel step
    (``parallel/data_parallel.py``): each rank steps on its rows of the
    global batch, the training forward's batch-norm statistics are the
    global batch's, and the gradients and the metrics are averaged over
    the ranks after the backward (and the accumulation), before the
    non-finite check, the clipping and the optimizer (the JAX package's
    ``pmean`` over ``axis_name``): every rank sees the same gradients, so
    all agree on skipping a non-finite one.

    ``spatial``: the spatial axis of a row-sharded step (the JAX
    package's ``make_pjit_train_step(spatial_axis=...)``, whose batch is
    sharded over ``axis`` on B and over ``spatial`` on H): each rank holds
    its rows of its samples and runs the unchanged training forward under
    ``spmd.spatial_sharding(spatial)``; the step is the global batch's, as
    XLA's partitioner computes it.  The loss is each rank's share
    (``loss.sequence_loss`` over both axes: its numerators over the global
    count, under 'valid' the psum'd valid count), so the gradient of the
    global loss is the sum of the ranks' gradients: psum'd over
    ``spatial``, then over ``axis``, one flattened all-reduce each; the
    metrics are the global batch's; the batch-norm statistics are over
    every rank's pixels; dropout masks are drawn at the global batch's
    shape and sliced to this rank's samples (JAX's one replicated key over
    the global array); H must be a multiple of
    ``parallel/spatial.py::required_h_multiple``.

    ``step.masks(batch, seed)`` draws one step's masks for a local batch of
    ``batch`` samples (:func:`step_masks`, sliced as above when row-sharded).

    ``step.compute(state, batch, masks)`` is the step's device work alone
    (``batch`` a :class:`Batch` of device tensors already checked,
    ``masks`` one :func:`step_masks` entry per micro-batch, each on the
    device or None): what ``training/capture.py`` captures."""
    adaptive = adaptive_iters(config.iters_policy)
    accum = tconfig.accum_steps
    data = axis if axis is not None and axis.group is not None else None
    sharded = spatial is not None
    loss_axes = [a for a in (axis, spatial) if a is not None] if sharded \
        else []

    def grad_fn(model, params, batch: Batch, masks):
        out = raft_forward(model, batch.image1, batch.image2, config,
                           train=True, freeze_bn=tconfig.freeze_bn,
                           dropout_masks=masks, sync_axis=axis)
        loss, metrics = sequence_loss(
            out.flow_iters, batch.flow, batch.valid, gamma=tconfig.gamma,
            max_flow=tconfig.max_flow,
            normalization=tconfig.loss_normalization, axes=loss_axes)
        if adaptive:
            metrics["mean_iters"] = out.iters_used.float().mean()
            if sharded and data is not None:
                metrics["mean_iters"] = spmd.pmean(metrics["mean_iters"],
                                                   data)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)], metrics

    @contract({"batch.image1": "*[B,H,W,3]", "batch.image2": "*[B,H,W,3]",
               "batch.flow": "*[B,H,W,2]", "batch.valid": "*[B,H,W]"})
    def compute(state: TrainState, batch: Batch, masks) -> dict:
        params = state.params
        with precision(), (spmd.spatial_sharding(spatial) if sharded
                           else contextlib.nullcontext()):
            bn = list(state.bn_state.values())
            before = ([b.clone() for b in bn]
                      if tconfig.skip_nonfinite_updates else None)
            if accum <= 1:
                grads, metrics = grad_fn(state.model, params, batch, masks[0])
            else:
                gsum, mlist = None, []
                for k in range(accum):
                    micro = Batch(*(x[k::accum] for x in batch))
                    g, m = grad_fn(state.model, params, micro, masks[k])
                    gsum = g if gsum is None else [a + b for a, b in
                                                   zip(gsum, g)]
                    mlist.append(m)
                grads = [g / accum for g in gsum]
                metrics = {k: torch.stack([m[k] for m in mlist]).mean()
                           for k in mlist[0]}
            if sharded:
                # the shares' gradients summed: over the rows, then the
                # samples (the metrics are global already)
                for ax in (spatial, data):
                    if ax is not None and ax.group is not None:
                        grads = pmean_tensors(grads, ax, op=spmd.psum)
            elif data is not None:
                grads = pmean_tensors(grads, data)
                keys = sorted(metrics)
                metrics = dict(zip(keys, pmean_tensors(
                    [metrics[k] for k in keys], data)))
            if before is not None:
                finite = all_finite(grads)
                with torch.no_grad():
                    for b, old in zip(bn, before):
                        b.copy_(torch.where(finite, b, old))
            metrics["grad_norm"] = tx.update(grads, state.opt_state, params)
        return metrics

    def masks_for(batch: int, seed: int) -> list:
        if not sharded or data is None:
            return step_masks(config, batch, accum, seed)
        mb, idx = batch // accum, data.index
        out = []
        for m in step_masks(config, batch * data.size, accum, seed):
            if m is None:
                out.append(None)
                continue
            fmask, cmask = m
            whole = cmask.shape[0]
            out.append((torch.cat([fmask[idx * mb:(idx + 1) * mb],
                                   fmask[whole + idx * mb:
                                         whole + (idx + 1) * mb]]),
                        cmask[idx * mb:(idx + 1) * mb]))
        return out

    def train_step(state: TrainState, batch, seed: int = 0):
        dev = state.params[0].device
        batch = checked_batch(_on(batch, dev), accum)
        masks = [None if m is None else tuple(t.to(dev) for t in m)
                 for m in masks_for(batch.image1.shape[0], seed)]
        metrics = compute(state, batch, masks)
        state.step += 1
        return state, metrics

    train_step.compute = compute
    train_step.masks = masks_for
    return train_step


def checked_batch(batch: Batch, accum: int) -> Batch:
    """``batch`` after checking its fields' shapes against each other and
    that ``accum`` divides its batch; raises ValueError otherwise."""
    _check_batch(batch)
    B = batch.image1.shape[0]
    if B % accum:
        raise ValueError(f"batch {B} not divisible by accum_steps {accum}")
    return batch


def step_masks(config: RAFTConfig, batch: int, accum: int, seed: int) -> list:
    """One step's channel-dropout keep masks, per micro-batch k drawn on
    the host from a ``torch.Generator`` seeded ``seed * 1000003 + k``
    (``models/raft.py::draw_dropout_masks``); each None at
    ``config.dropout = 0``, where nothing is drawn."""
    micro = batch // accum
    return [draw_dropout_masks(config, micro, torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + k) % (2 ** 63))) for k in range(accum)]


def make_eval_step(config: RAFTConfig, iters: Optional[int] = None,
                   with_iters: bool = False):
    """``step(model, image1, image2) -> flow`` [B, H, W, 2] (eval mode,
    the final full-resolution flow), or with ``with_iters`` ``(flow,
    iters_used)``: each sample's live GRU iterations."""
    @contract(image1="*[B,H,W,3]", image2="*[B,H,W,3]",
              **({} if with_iters else {"_returns": "*[B,H,W,2]"}))
    def eval_step(model, image1, image2):
        with torch.no_grad(), precision():
            out = raft_forward(model, image1, image2, config, iters=iters,
                               train=False, all_flows=False)
        return (out.flow, out.iters_used) if with_iters else out.flow

    return eval_step


def make_warm_eval_step(config: RAFTConfig, iters: Optional[int] = None,
                        with_iters: bool = False):
    """``step(model, image1, image2, flow_init) -> (flow, flow_lr)``, the
    official Sintel warm-start evaluation step: ``flow_init`` (1/8
    resolution; zeros = a cold start) seeds the recurrence, and the
    low-resolution flow returned is what seeds the next frame of the
    scene.  ``with_iters`` appends ``iters_used``."""
    @contract(image1="*[B,H,W,3]", image2="*[B,H,W,3]",
              flow_init="*[B,HL,WL,2]")
    def eval_step(model, image1, image2, flow_init):
        with torch.no_grad(), precision():
            out = raft_forward(model, image1, image2, config, iters=iters,
                               train=False, all_flows=False,
                               flow_init=flow_init)
        if with_iters:
            return out.flow, out.flow_lr, out.iters_used
        return out.flow, out.flow_lr

    return eval_step
