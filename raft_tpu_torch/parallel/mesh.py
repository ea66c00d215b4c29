"""The device mesh of a multi-process run.

The port of the JAX package's ``parallel/mesh.py``.  JAX shards one
program over the devices of one process (a ``jax.sharding.Mesh``); the
PyTorch idiom is one process a device under ``torch.distributed``, each
running the same program on its share.  So here a :class:`Mesh` is this
rank's view of the mesh: the axis names, each mapped to an
:class:`~raft_tpu_torch.ops.spmd.Axis` (the process group of the ranks
along it, its size, this rank's index), and this rank's device.  The
scale-out axes are the JAX package's: data parallelism over ``data``
(gradients and batch-norm statistics averaged over the ranks) and row
sharding over ``spatial`` (``parallel/spatial.py``).

``compat_shard_map``, ``batch_sharding`` and ``replicated`` of the JAX
module have no counterpart: the first is a shim across jax versions for
``shard_map``, the other two are sharding objects that tell XLA where a
global array lives.  An eager per-rank program has no global arrays: each
rank holds its rows (:func:`shard_batch`) and calls the collectives itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.spmd import Axis

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class Mesh:
    """This rank's view of a mesh: ``axes`` (name -> :class:`Axis`, in
    mesh order), ``shape`` and ``device`` (this rank's)."""

    def __init__(self, axes: Dict[str, Axis], shape: Tuple[int, ...],
                 device: torch.device):
        self.axes = axes
        self.shape = tuple(shape)
        self.device = torch.device(device)

    def __getitem__(self, name: str) -> Axis:
        if name not in self.axes:
            raise KeyError(f"mesh has axes {list(self.axes)}, not {name!r}")
        return self.axes[name]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axes, self.shape))}, "
                f"device={self.device})")


def capturable(mesh: Mesh, *axes) -> bool:
    """Whether work over ``axes`` of ``mesh`` can be captured in a CUDA
    graph: a CUDA device, and no axis gloo's on CUDA tensors (staged
    through the host): each NCCL's or a one-rank axis without a group."""
    return mesh.device.type == "cuda" and not any(
        a is not None and a.staged for a in axes)


def rank_device(rank: int, world: int) -> torch.device:
    """This rank's card, ``cuda:<rank>``; raises when there are fewer
    cards than ranks (two ranks never share a card unless the caller
    passes the device) or no CUDA at all (no rank moves to the CPU
    unasked)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the ranks on the CPU")
    n = torch.cuda.device_count()
    if rank >= n:
        raise RuntimeError(
            f"rank {rank} of {world} has no card of its own ({n} visible): "
            f"pass the device explicitly to place ranks on a shared card")
    return torch.device("cuda", rank)


def make_mesh(axes: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Tuple[int, ...]] = None,
              device=None) -> Mesh:
    """The mesh over every rank of the process group (one rank, and no
    group, when ``torch.distributed`` is not initialized): ``shape``
    (default: all ranks on the first axis) factors the world in row-major
    rank order, as ``np.reshape`` lays out JAX's device array.  Each
    axis's groups are created on every rank in one order (as
    ``dist.new_group`` requires); an axis spanning the whole world uses
    the world group, a one-rank axis of a larger world none.  ``device``:
    this rank's (default :func:`rank_device`); a CUDA device becomes the
    current one, as NCCL needs."""
    axes = tuple(axes)
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} has {int(np.prod(shape))} "
                         f"ranks, the process group {world}")
    dev = torch.device(device) if device is not None else (
        rank_device(rank, world) if on else rank_device(0, 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ids = np.arange(world).reshape(shape)
    out = {}
    for k, name in enumerate(axes):
        if not on:
            out[name] = Axis(name, None)
            continue
        if shape[k] == world:
            out[name] = Axis(name, dist.group.WORLD)
            continue
        mine = None
        lines = np.moveaxis(ids, k, -1).reshape(-1, shape[k])
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if shape[k] > 1 else None
            if rank in ranks:
                mine = group
        out[name] = Axis(name, mine)
    return Mesh(out, shape, dev)


def _rows(x, axis: Axis, device: Optional[torch.device], dim: int = 0,
          what: str = "batch") -> torch.Tensor:
    t = torch.as_tensor(x)
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"{what} {n} is not divisible by the {axis.size} "
                         f"ranks of axis {axis.name!r}")
    per = n // axis.size
    t = t.narrow(dim, axis.index * per, per).contiguous()
    return t if device is None else t.to(device)


def shard_batch(mesh: Mesh, batch, axis: str = DATA_AXIS,
                spatial_axis: Optional[str] = None):
    """This rank's share of a host batch (an array or tensor, or a tuple or
    ``NamedTuple`` of them, leading dim the batch), on this rank's device:
    its samples over ``axis`` and, with ``spatial_axis``, its rows (dim 1,
    H) of them over that axis (JAX's ``P(data, spatial)``); raises
    ValueError when the batch or H does not divide over an axis."""
    ax = mesh[axis]
    sp = None if spatial_axis is None else mesh[spatial_axis]

    def one(x):
        t = _rows(x, ax, None if sp is not None else mesh.device)
        return t if sp is None else _rows(t, sp, mesh.device, 1, "H")
    if isinstance(batch, tuple):
        rows = [one(x) for x in batch]
        return type(batch)(*rows) if hasattr(batch, "_fields") else tuple(rows)
    return one(batch)
