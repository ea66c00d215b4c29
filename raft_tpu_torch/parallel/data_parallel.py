"""Data-parallel training and evaluation.

The port of the JAX package's ``parallel/data_parallel.py``.  Training:
one process a rank (``torch.distributed``), each holding the whole model
and optimizer state and stepping on its rows of the global batch; the
gradients and the metrics are averaged over the ranks after the backward
and before clipping and the optimizer, and the batch-norm statistics of
the training forward are the global batch's (``ops/norm.py::batch_norm_train``),
so every rank takes the same update and the step equals one step on the
whole batch.  Evaluation: one process, one replica of the captured
inference function a device, each on its share of the batch.

Row-sharded training (:func:`make_pjit_train_step` with a spatial axis,
the JAX package's dp x sp sharding-annotation step): each rank holds its
samples' rows (``mesh.shard_batch(..., spatial_axis=...)``) and runs
``training/step.py::make_train_step(axis=data, spatial=spatial)``, the
global batch's step by explicit collectives.

Captured steps: on CUDA, where every axis of the step is NCCL's (or has
one rank), the step is captured as one CUDA graph
(``training/capture.py``) with its collectives inside it (the
synchronized batch norm in the forward and backward, the halo exchanges
and the ring under row sharding, the gradient all-reduces); under gloo,
whose collectives stage through the host and cannot be captured, it runs
eagerly, its collectives issued from the host.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from ..config import RAFTConfig, TrainConfig
from ..models.raft import (RAFT, make_counted_inference_fn,
                           make_inference_fn)
from ..training.optim import Optimizer
from ..training.step import make_train_step
from .mesh import DATA_AXIS, Mesh, capturable


def make_dp_train_step(config: RAFTConfig, tconfig: TrainConfig,
                       tx: Optimizer, mesh: Mesh, axis: str = DATA_AXIS,
                       donate: bool = True):
    """``step(state, local_batch, seed) -> (state, metrics)`` for the rank
    holding ``state`` (its copy of the replicated state, on
    ``mesh.device``) and ``local_batch`` (its rows of the global batch,
    ``mesh.shard_batch``).  The metrics are the global batch's on every
    rank.  With ``accum_steps > 1`` each rank splits its own rows
    stride-major, as the JAX package's step inside ``shard_map`` does.
    Dropout masks are drawn from ``seed`` over the local batch, the same
    on every rank (JAX's replicated key).  ``donate`` is the JAX API's:
    the state is always updated in place here.  On CUDA over NCCL (or one
    rank) the step is a captured graph, collectives inside; under gloo it
    runs eagerly."""
    del donate
    ax = mesh[axis]
    if capturable(mesh, ax):
        from ..training.capture import GraphedTrainStep
        return GraphedTrainStep(config, tconfig, tx, axis=ax)
    return make_train_step(config, tconfig, tx, axis=ax)


def make_pjit_train_step(config: RAFTConfig, tconfig: TrainConfig,
                         tx: Optimizer, mesh: Mesh,
                         data_axis: str = DATA_AXIS,
                         spatial_axis: Optional[str] = None,
                         donate: bool = True):
    """The JAX package's sharding-annotation step, ``step(state,
    local_batch, seed) -> (state, metrics)``.  Over the data axis alone it
    is :func:`make_dp_train_step` (the global batch's statistics and
    gradient, as XLA's partitioner computes them).  With
    ``spatial_axis`` (a dp x sp mesh, ``make_mesh(axes=(DATA_AXIS,
    SPATIAL_AXIS), shape=(dp, sp))``) each rank's ``local_batch`` is its
    samples' rows (``shard_batch(mesh, batch, data_axis, spatial_axis)``)
    and the step is ``training/step.py::make_train_step(axis=data,
    spatial=spatial)``: the global batch's loss, metrics, gradient,
    batch-norm statistics and update, by explicit collectives around the
    unchanged model code (the port has no partitioner).  H must be a
    multiple of ``parallel/spatial.py::required_h_multiple`` (JAX's step
    takes any H: ROADMAP, "Deviations by design").  Captured on CUDA over
    NCCL, eager under gloo."""
    if spatial_axis is None:
        return make_dp_train_step(config, tconfig, tx, mesh, data_axis,
                                  donate)
    del donate
    dax, sax = mesh[data_axis], mesh[spatial_axis]
    if capturable(mesh, dax, sax):
        from ..training.capture import GraphedTrainStep
        return GraphedTrainStep(config, tconfig, tx, axis=dax, spatial=sax)
    return make_train_step(config, tconfig, tx, axis=dax, spatial=sax)


def replicate(model: RAFT, devices: Sequence) -> List[RAFT]:
    """One model a device for :func:`make_dp_eval_fn`: ``model`` itself
    where a device is its own, a copy elsewhere (one copy per distinct
    device).  A later in-place load into ``model`` reaches only the
    entries that are ``model``."""
    own = next(model.parameters()).device
    copies = {}
    out = []
    for d in map(torch.device, devices):
        if _same(d, own):
            out.append(model)
            continue
        if str(d) not in copies:
            copies[str(d)] = copy.deepcopy(model).to(d)
        out.append(copies[str(d)])
    return out


def _same(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


def make_dp_eval_fn(config: RAFTConfig, devices: Sequence,
                    iters: Optional[int] = None, with_iters: bool = False):
    """``fn(models, image1, image2) -> flow`` (``with_iters``: ``(flow,
    iters_used)``) over ``devices`` in one process: the batch is split into
    ``len(devices)`` equal parts (an indivisible batch raises ValueError,
    as JAX's ``shard_map`` does), part ``i`` runs on ``devices[i]`` through
    that device's inference function (``make_inference_fn``, or
    ``make_counted_inference_fn``: a captured CUDA graph on a card), and
    the parts' outputs are gathered, in order, on ``devices[0]``.
    ``models``: one model per device (:func:`replicate`), or one model
    whose device every entry is.  A device may repeat (two replicas on one
    card, one function and one graph serving both, in turns): that is how
    a one-card machine runs it.  Under ``iters_policy='converge:*'`` each
    replica exits on its own part's convergence, as in JAX.
    ``fn.factories`` lists the per-device functions (their ``graphs``)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_dp_eval_fn needs at least one device")
    make = make_counted_inference_fn if with_iters else make_inference_fn
    factories = {}
    for d in devices:
        if str(d) not in factories:
            factories[str(d)] = make(config, iters=iters, device=d)
    n = len(devices)

    def fn(models, image1, image2):
        reps = (list(models) if isinstance(models, (list, tuple))
                else [models] * n)
        if len(reps) != n:
            raise ValueError(f"{len(reps)} models for {n} devices")
        for m, d in zip(reps, devices):
            if not _same(next(m.parameters()).device, d):
                raise ValueError(f"a replica on {next(m.parameters()).device}"
                                 f" for device {d}: pass replicate(model, "
                                 f"devices)")
        B = image1.shape[0]
        if B % n:
            raise ValueError(f"batch {B} is not divisible by the {n} "
                             f"data-parallel devices")
        per = B // n
        outs = [factories[str(d)](m, image1[i * per:(i + 1) * per],
                                  image2[i * per:(i + 1) * per])
                for i, (m, d) in enumerate(zip(reps, devices))]
        first = devices[0]
        if with_iters:
            return (torch.cat([o[0].to(first) for o in outs]),
                    torch.cat([o[1].to(first) for o in outs]))
        return torch.cat([o.to(first) for o in outs])

    fn.factories = list(factories.values())
    fn.graphs = None
    fn.devices = devices
    return fn
