"""Train and eval steps: the JAX package's ``training/step.py``.

``make_train_step`` returns ``step(state, batch, seed) -> (state,
metrics)``: the training forward (``raft_forward(train=True)``), the
sequence loss, the gradients (autograd; through the kernels' wrappers
their backward is the plain twins' vjp, as the JAX package defines it),
then the optimizer (``training/optim.py``), all on the model's device,
updating the model and the optimizer's state in place.  The metrics are
0-dim device tensors; the step reads nothing back to the host.

Under ``compute_dtype='float32'`` the whole step, forward, backward and
optimizer, runs with TF32 off for cuBLAS and cuDNN (``models/raft.py::
tf32_off``): the switches are process-wide, and the kernels' backward
(matrix products and convolutions of the twins) runs on autograd's own
thread after the forward has returned, so holding them off for the
forward alone would let the backward's products round their operands to
TF32.  ``compute_dtype='bfloat16'`` training raises (ROADMAP item 7b).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..config import RAFTConfig, TrainConfig, adaptive_iters
from ..models.raft import raft_forward, tf32_off
from .loss import sequence_loss
from .optim import Optimizer, all_finite
from .state import TrainState


class Batch(NamedTuple):
    image1: torch.Tensor           # [B, H, W, 3] float in [0, 1]
    image2: torch.Tensor
    flow: torch.Tensor             # [B, H, W, 2]
    valid: torch.Tensor            # [B, H, W] float/bool


def precision(config: RAFTConfig):
    """:func:`tf32_off` for a float32 configuration, else nothing."""
    return (tf32_off() if config.compute_dtype == "float32"
            else contextlib.nullcontext())


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


def make_train_step(config: RAFTConfig, tconfig: TrainConfig,
                    tx: Optimizer):
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
    mean of the samples' live iterations."""
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            "training under compute_dtype='bfloat16' needs float32 master "
            "weights under a bfloat16 forward: ROADMAP item 7b")
    adaptive = adaptive_iters(config.iters_policy)
    accum = tconfig.accum_steps

    def grad_fn(model, params, batch: Batch, generator):
        out = raft_forward(model, batch.image1, batch.image2, config,
                           train=True, freeze_bn=tconfig.freeze_bn,
                           generator=generator)
        loss, metrics = sequence_loss(
            out.flow_iters, batch.flow, batch.valid, gamma=tconfig.gamma,
            max_flow=tconfig.max_flow,
            normalization=tconfig.loss_normalization)
        if adaptive:
            metrics["mean_iters"] = out.iters_used.float().mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)], metrics

    def train_step(state: TrainState, batch, seed: int = 0):
        params = state.params
        batch = _on(batch, params[0].device)
        _check_batch(batch)
        B = batch.image1.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum_steps "
                             f"{accum}")
        gens = [torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + k) % (2 ** 63)) for k in range(accum)]
        with precision(config):
            bn = list(state.bn_state.values())
            before = ([b.clone() for b in bn]
                      if tconfig.skip_nonfinite_updates else None)
            if accum <= 1:
                grads, metrics = grad_fn(state.model, params, batch, gens[0])
            else:
                gsum, mlist = None, []
                for k in range(accum):
                    micro = Batch(*(x[k::accum] for x in batch))
                    g, m = grad_fn(state.model, params, micro, gens[k])
                    gsum = g if gsum is None else [a + b for a, b in
                                                   zip(gsum, g)]
                    mlist.append(m)
                grads = [g / accum for g in gsum]
                metrics = {k: torch.stack([m[k] for m in mlist]).mean()
                           for k in mlist[0]}
            if before is not None:
                finite = all_finite(grads)
                with torch.no_grad():
                    for b, old in zip(bn, before):
                        b.copy_(torch.where(finite, b, old))
            metrics["grad_norm"] = tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(config: RAFTConfig, iters: Optional[int] = None,
                   with_iters: bool = False):
    """``step(model, image1, image2) -> flow`` [B, H, W, 2] (eval mode,
    the final full-resolution flow), or with ``with_iters`` ``(flow,
    iters_used)``: each sample's live GRU iterations."""
    def eval_step(model, image1, image2):
        with torch.no_grad(), precision(config):
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
    def eval_step(model, image1, image2, flow_init):
        with torch.no_grad(), precision(config):
            out = raft_forward(model, image1, image2, config, iters=iters,
                               train=False, all_flows=False,
                               flow_init=flow_init)
        if with_iters:
            return out.flow, out.flow_lr, out.iters_used
        return out.flow, out.flow_lr

    return eval_step
