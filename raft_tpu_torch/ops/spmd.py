"""Run-time row-sharding context and the collectives of the parallel layer.

The port of the JAX package's ``ops/spmd.py``.  A row-sharded
(sequence-parallel) run executes the *unchanged* model code on each rank,
its activations holding a slab of the image rows.  Rather than threading a
process group through every op, the ops consult this context: while
:func:`spatial_sharding` is active,

* ``ops/conv.py::conv_nchw`` exchanges a ``kh//2``-row halo with the
  neighbouring ranks and convolves with no H padding,
* ``ops/norm.py::instance_norm`` takes the mean of its statistics over the
  ranks,
* convex upsampling fetches its one-row halo and ``upflow8`` builds
  shard-offset interpolation rows.

JAX's context is a trace-time global read while ``shard_map`` traces; this
one is read at run time, so it lives in a ``contextvars.ContextVar``: a
serving thread never sees another thread's context.

An :class:`Axis` is one axis of a mesh (``parallel/mesh.py``) as this rank
sees it: its name, the ``torch.distributed`` process group of the ranks
along it (None: a one-rank axis, where every collective is the identity),
its size and this rank's index on it.  The collectives (:func:`psum`,
:func:`pmean`, :func:`all_gather`, :func:`ppermute`) are plain functions on
``torch.distributed``.  Under NCCL they take CUDA tensors directly.  Gloo
moves no CUDA data by point-to-point calls, so under gloo a CUDA tensor is
copied to the host, communicated, and copied back: explicitly, here and
nowhere else, for every collective, and counted (:data:`STATS`).  That is
how two ranks share one card in the tests of this layer on the card.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis at run time: ``name``, ``group`` (a process group, or
    None for a one-rank axis with nothing to communicate), ``size``,
    ``index`` (this rank's position on the axis) and ``ranks`` (the global
    ranks along it, by index)."""

    def __init__(self, name: str, group=None):
        self.name = name
        self.group = group
        if group is None:
            self.size, self.index, self.ranks = 1, 0, [0]
            self.staged = False
            return
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.ranks = [dist.get_global_rank(group, i) for i in range(self.size)]
        # NCCL takes CUDA tensors; gloo moves them through the host
        self.staged = "nccl" not in str(dist.get_backend(group)).lower()

    def __repr__(self) -> str:
        return (f"Axis({self.name!r}, size={self.size}, index={self.index}, "
                f"staged={self.staged})")


class Stats:
    """What the collectives did since :func:`reset_stats`: ``calls`` (every
    collective issued over a group), ``staged_calls`` and ``staged_bytes``
    (CUDA tensors copied through the host under gloo: both directions'
    bytes), and, when ``timed``, ``seconds`` of host wall time inside the
    collectives, the card synchronized at each one's start and end (so the
    time is the collective's and its staging's, not the queued compute's
    before it)."""

    def __init__(self):
        self.reset()

    def reset(self, timed: Optional[bool] = None) -> None:
        self.calls = 0
        self.staged_calls = 0
        self.staged_bytes = 0
        self.seconds = 0.0
        if timed is not None or not hasattr(self, "timed"):
            self.timed = bool(timed)

    def snapshot(self) -> dict:
        return {"calls": self.calls, "staged_calls": self.staged_calls,
                "staged_bytes": self.staged_bytes, "seconds": self.seconds}


STATS = Stats()


def reset_stats(timed: Optional[bool] = None) -> None:
    """Zero :data:`STATS`; ``timed`` switches the timing on or off."""
    STATS.reset(timed)


_SPATIAL: ContextVar[Optional[Axis]] = ContextVar("raft_tpu_torch_spatial",
                                                  default=None)


@contextlib.contextmanager
def spatial_sharding(axis: Axis):
    """Row-sharded semantics for the ops run inside this block, on this
    thread (and the contexts copied from it)."""
    token = _SPATIAL.set(axis)
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def spatial_axis() -> Optional[Axis]:
    """The active row-sharding axis, or None."""
    return _SPATIAL.get()


def axis_size(axis: Axis) -> int:
    return axis.size


def axis_index(axis: Axis) -> int:
    """This rank's index on ``axis`` (JAX's ``lax.axis_index``)."""
    return axis.index


@contextlib.contextmanager
def _collective(axis: Axis, tensors: Sequence[torch.Tensor]):
    STATS.calls += 1
    cuda = [t.device for t in tensors if t.is_cuda]
    if STATS.timed and cuda:
        torch.cuda.synchronize(cuda[0])
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if STATS.timed:
            if cuda:
                torch.cuda.synchronize(cuda[0])
            STATS.seconds += time.perf_counter() - t0


def _wire(t: torch.Tensor, axis: Axis, fresh: bool) -> torch.Tensor:
    """``t`` as the backend takes it: a host copy of a CUDA tensor under
    gloo (counted), else ``t`` itself (cloned when ``fresh``: the
    collective writes in place)."""
    t = t.detach().contiguous()
    if t.is_cuda and axis.staged:
        STATS.staged_bytes += t.numel() * t.element_size()
        return t.cpu()
    return t.clone() if fresh else t


def _unwire(h: torch.Tensor, like: torch.Tensor, axis: Axis) -> torch.Tensor:
    if like.is_cuda and axis.staged:
        STATS.staged_bytes += h.numel() * h.element_size()
        return h.to(like.device)
    return h


def _count_staged(axis: Axis, tensors: Iterable[torch.Tensor]) -> None:
    if axis.staged and any(t.is_cuda for t in tensors):
        STATS.staged_calls += 1


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    if axis.group is None:
        return x
    with _collective(axis, [x]):
        _count_staged(axis, [x])
        w = _wire(x, axis, fresh=True)
        dist.all_reduce(w, group=axis.group)
        return _unwire(w, x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis``."""
    if axis.group is None:
        return x
    return psum(x, axis) / axis.size


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (JAX's
    ``all_gather(tiled=True)``)."""
    if axis.group is None:
        return x
    with _collective(axis, [x]):
        _count_staged(axis, [x])
        w = _wire(x, axis, fresh=False)
        parts = [torch.empty_like(w) for _ in range(axis.size)]
        dist.all_gather(parts, w, group=axis.group)
        return _unwire(torch.cat(parts, dim=dim), x, axis)


class Pending:
    """A :func:`ppermute_start` in flight: :meth:`wait` returns the
    received tensors (zeros where this rank receives from no one)."""

    def __init__(self, axis, works, outs, likes, timer):
        self._axis, self._works, self._outs = axis, works, outs
        self._likes, self._timer = likes, timer

    def wait(self) -> List[torch.Tensor]:
        try:
            for w in self._works:
                w.wait()
            return [_unwire(o, like, self._axis)
                    for o, like in zip(self._outs, self._likes)]
        finally:
            self._timer.__exit__(None, None, None)


def ppermute_start(items: Sequence[Tuple[torch.Tensor, Sequence]],
                   axis: Axis) -> Pending:
    """Start the point-to-point exchanges ``items``, each ``(x, perm)``
    with ``perm`` a list of ``(src, dst)`` axis indices (JAX's
    ``ppermute``): this rank sends its ``x`` to ``dst`` where it is a
    ``src``, and receives the ``x`` of its ``src``, or zeros where it is
    no one's ``dst``.  All of them go in one ``batch_isend_irecv`` (no
    ordering of blocking sends can deadlock a ring), tagged by position
    so two exchanges between one pair of ranks never cross."""
    me = axis.index
    tensors = [x for x, _ in items]
    timer = _collective(axis, tensors) if axis.group is not None else \
        contextlib.nullcontext()
    timer.__enter__()
    if axis.group is not None:
        _count_staged(axis, tensors)
    ops, works, outs = [], [], []
    try:
        for tag, (x, perm) in enumerate(items):
            dst = [d for s, d in perm if s == me]
            src = [s for s, d in perm if d == me]
            if len(dst) > 1 or len(src) > 1:
                raise ValueError(f"perm {list(perm)} is not a permutation")
            if src and src[0] == me:        # to itself: no communication
                outs.append(x.detach().clone())
                continue
            w = _wire(x, axis, fresh=False)
            if dst:
                ops.append(dist.P2POp(dist.isend, w, axis.ranks[dst[0]],
                                      axis.group, tag))
            buf = torch.zeros_like(w)
            if src:
                ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[src[0]],
                                      axis.group, tag))
            outs.append(buf)
        if ops:
            works = dist.batch_isend_irecv(ops)
    except BaseException:
        timer.__exit__(None, None, None)
        raise
    # each received buffer comes back to the device of the tensor sent
    return Pending(axis, works, outs, tensors, timer)


def ppermute(x, axis: Axis, perm: Sequence) -> torch.Tensor:
    """One exchange (:func:`ppermute_start`), waited for."""
    return ppermute_start([(x, perm)], axis).wait()[0]


def halo_exchange(x: torch.Tensor, halo: int, axis: Optional[Axis] = None,
                  dim: int = 1) -> torch.Tensor:
    """Pad dimension ``dim`` (H: 1 of NHWC, 2 of NCHW) of a row-sharded
    slab with ``halo`` rows from the neighbouring ranks, zeros at the image
    edges (torch zero padding); the active axis unless ``axis`` is given.
    A halo wider than the slab (tiny maps) cannot come from the
    neighbours alone: then every slab is gathered, padded, and this
    rank's window cut out."""
    if halo == 0:
        return x
    axis = spatial_axis() if axis is None else axis
    if axis is None:
        raise ValueError("halo_exchange needs an axis or an active "
                         "spatial_sharding context")
    n, idx, hl = axis.size, axis.index, x.shape[dim]
    if halo > hl:
        full = all_gather(x, axis, dim)
        shape = list(full.shape)
        shape[dim] = halo
        z = full.new_zeros(shape)
        full = torch.cat([z, full, z], dim=dim)
        return full.narrow(dim, idx * hl, hl + 2 * halo)
    top = x.narrow(dim, 0, halo)            # -> the previous rank's bottom
    bot = x.narrow(dim, hl - halo, halo)    # -> the next rank's top
    # edges receive from no one: zeros, the image boundary's padding
    from_next, from_prev = ppermute_start(
        [(top, [(i, i - 1) for i in range(1, n)]),
         (bot, [(i, i + 1) for i in range(n - 1)])], axis).wait()
    return torch.cat([from_prev, x, from_next], dim=dim)
