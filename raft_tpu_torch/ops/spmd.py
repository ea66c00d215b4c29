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
:func:`pmean`, :func:`all_gather`, :func:`ppermute` and
:func:`halo_exchange`, built of them) run on ``torch.distributed`` and are
differentiable: each is a ``torch.autograd.Function`` whose backward is
its transpose, under one convention (stated above :func:`psum`), so the
row-sharded training step differentiates through them.  A backward that
recomputes under the context enters the axis its forward saw
(:func:`entered`).  Under NCCL they take CUDA tensors directly, and a
capture into a CUDA graph records them.  Gloo moves no CUDA data by
point-to-point calls, so under gloo a CUDA tensor is copied to the host,
communicated, and copied back: explicitly, here and nowhere else, for
every collective, and counted (:data:`STATS`, the forward's and the
backward's apart).  That is how two ranks share one card in the tests of
this layer on the card.
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
    """What the collectives did since :func:`reset_stats`, the forward's
    and the backward's apart: ``calls`` (every collective issued over a
    group), ``staged_calls`` and ``staged_bytes`` (CUDA tensors copied
    through the host under gloo: both directions' bytes), and, when
    ``timed``, ``seconds`` of host wall time inside the collectives, the
    card synchronized at each one's start and end (so the time is the
    collective's and its staging's, not the queued compute's before it);
    ``p2p_calls``, the point-to-point batches that moved data (a ppermute
    with no pair of distinct ranks sends nothing); the same five with a
    ``bwd_`` prefix for the collectives issued by a backward (the
    transposes below); and ``captured_calls``, the backend operations of
    either kind issued while the stream was being captured into a CUDA
    graph (no timer runs there: a capture cannot synchronize)."""

    FIELDS = ("calls", "staged_calls", "staged_bytes", "seconds", "p2p_calls")

    def __init__(self):
        self.reset()

    def reset(self, timed: Optional[bool] = None) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)
            setattr(self, "bwd_" + f, 0)
        self.seconds = self.bwd_seconds = 0.0
        self.captured_calls = 0
        if timed is not None or not hasattr(self, "timed"):
            self.timed = bool(timed)

    def add(self, field: str, n) -> None:
        """Count ``n`` into ``field``, or into its backward twin inside a
        transpose."""
        name = "bwd_" + field if _IN_BACKWARD.get() else field
        setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> dict:
        out = {f: getattr(self, f) for f in self.FIELDS}
        out.update({"bwd_" + f: getattr(self, "bwd_" + f)
                    for f in self.FIELDS})
        out["captured_calls"] = self.captured_calls
        return out


_IN_BACKWARD: ContextVar[bool] = ContextVar("raft_tpu_torch_spmd_bwd",
                                            default=False)
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


@contextlib.contextmanager
def entered(axis: Optional[Axis]):
    """The context exactly as ``axis`` says, on this thread: row-sharded
    over ``axis``, or, for None, unsharded whatever the thread had.  A
    backward that recomputes (a kernel's twin, a remat iteration) enters
    the axis its forward saw (:func:`spatial_axis` at forward time): the
    autograd engine runs the backward of CUDA tensors on a device thread
    of its own, which never entered the forward's context."""
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


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _issued() -> None:
    """A backend operation issued: counted when it records into a graph."""
    if _capturing():
        STATS.captured_calls += 1


@contextlib.contextmanager
def _collective(axis: Axis, tensors: Sequence[torch.Tensor]):
    STATS.add("calls", 1)
    timed = STATS.timed and not _capturing()
    cuda = [t.device for t in tensors if t.is_cuda]
    if timed and cuda:
        torch.cuda.synchronize(cuda[0])
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timed:
            if cuda:
                torch.cuda.synchronize(cuda[0])
            STATS.add("seconds", time.perf_counter() - t0)


@contextlib.contextmanager
def backward_stats(on: bool = True):
    """Count the collectives issued inside as a backward's (``on``): the
    transposes below, and a remat recompute's forward collectives."""
    token = _IN_BACKWARD.set(bool(on))
    try:
        yield
    finally:
        _IN_BACKWARD.reset(token)


def _wire(t: torch.Tensor, axis: Axis, fresh: bool) -> torch.Tensor:
    """``t`` as the backend takes it: a host copy of a CUDA tensor under
    gloo (counted), else ``t`` itself (cloned when ``fresh``: the
    collective writes in place)."""
    t = t.detach().contiguous()
    if t.is_cuda and axis.staged:
        STATS.add("staged_bytes", t.numel() * t.element_size())
        return t.cpu()
    return t.clone() if fresh else t


def _unwire(h: torch.Tensor, like: torch.Tensor, axis: Axis) -> torch.Tensor:
    if like.is_cuda and axis.staged:
        STATS.add("staged_bytes", h.numel() * h.element_size())
        return h.to(like.device)
    return h


def _count_staged(axis: Axis, tensors: Iterable[torch.Tensor]) -> None:
    if axis.staged and any(t.is_cuda for t in tensors):
        STATS.add("staged_calls", 1)


# -- the collectives, each with its transpose --------------------------------
#
# The convention of every backward here: each rank's loss is its share of
# the global loss, and the ranks' losses sum to it (``training/loss.py``
# divides each rank's numerator by the global count).  Under it the
# transpose of a collective is the collective JAX's autodiff gives:
# psum <-> psum (every rank's cotangent of the sum reaches every input),
# pmean <-> pmean, all_gather <-> the sum over the ranks of the cotangent,
# this rank's chunk (a reduce-scatter), ppermute <-> the inverse
# permutation, and a halo exchange (two ppermutes) <-> the halo rows'
# cotangents sent back and added to the neighbours' edge rows, dropped at
# the image's edges (no rank sent them).  A data-parallel step whose ranks
# each take their local mean and average the gradients (``pmean``) is the
# same convention with each rank's share its local loss over the ranks.


def _psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    with _collective(axis, [x]):
        _count_staged(axis, [x])
        w = _wire(x, axis, fresh=True)
        _issued()
        dist.all_reduce(w, group=axis.group)
        return _unwire(w, x, axis)


def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    with _collective(axis, [x]):
        _count_staged(axis, [x])
        w = _wire(x, axis, fresh=False)
        parts = [torch.empty_like(w) for _ in range(axis.size)]
        _issued()
        dist.all_gather(parts, w, group=axis.group)
        return _unwire(torch.cat(parts, dim=dim), x, axis)


class _PSum(torch.autograd.Function):
    """psum, whose transpose is psum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.clone() if axis.group is None else _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis.group is None:
            return g, None
        with backward_stats():
            return _psum(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    """all_gather along ``dim``, whose transpose is the psum of the
    cotangent cut to this rank's chunk (a reduce-scatter: gloo has none
    of its own, so an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return x.clone() if axis.group is None else _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.axis
        if ax.group is not None:
            with backward_stats():
                g = _psum(g.contiguous(), ax)
        return g.narrow(ctx.dim, ax.index * ctx.n, ctx.n), None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor);
    differentiable (its transpose is psum)."""
    if axis.group is None:
        return x
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis``."""
    if axis.group is None:
        return x
    return psum(x, axis) / axis.size


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (JAX's
    ``all_gather(tiled=True)``); differentiable (a reduce-scatter back)."""
    if axis.group is None:
        return x
    return _AllGather.apply(x, axis, dim)


def _inverse(perm: Sequence) -> list:
    return [(d, s) for s, d in perm]


def _start(items: Sequence[Tuple[torch.Tensor, Sequence]], axis: Axis):
    """Post the exchanges ``items`` in one ``batch_isend_irecv``; returns
    (works, the receive buffers, the timer to close at the wait)."""
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
            STATS.add("p2p_calls", 1)
            _issued()
            works = dist.batch_isend_irecv(ops)
    except BaseException:
        timer.__exit__(None, None, None)
        raise
    return works, outs, timer


def _finish(axis: Axis, works, outs, likes, timer) -> List[torch.Tensor]:
    """Wait for the exchanges: under NCCL ``Work.wait`` makes the current
    stream wait for them (no host wait, so it records into a capture);
    under gloo the host waits and the buffers come back to the card."""
    try:
        for w in works:
            w.wait()
        return [_unwire(o, like, axis) for o, like in zip(outs, likes)]
    finally:
        timer.__exit__(None, None, None)


def _ppermute_now(items, axis: Axis) -> List[torch.Tensor]:
    works, outs, timer = _start(items, axis)
    return _finish(axis, works, outs, [x for x, _ in items], timer)


class _Received(torch.autograd.Function):
    """The wait of a :func:`ppermute_start` as autograd sees it: its
    outputs are the received tensors, its inputs the sent ones; the
    transpose sends each output's cotangent back along the inverse
    permutation (zeros where no one sent)."""

    @staticmethod
    def forward(ctx, pending, *xs):
        ctx.axis, ctx.perms = pending._axis, pending._perms
        return tuple(pending._finish())

    @staticmethod
    def backward(ctx, *grads):
        items = [(g.contiguous(), _inverse(p)) for g, p in
                 zip(grads, ctx.perms)]
        with backward_stats():
            return (None, *_ppermute_now(items, ctx.axis))


class Pending:
    """A :func:`ppermute_start` in flight: :meth:`wait` returns the
    received tensors (zeros where this rank receives from no one),
    differentiable with respect to the sent ones (the inverse
    permutation back) when autograd records."""

    def __init__(self, axis, works, outs, xs, perms, timer):
        self._axis, self._works, self._outs = axis, works, outs
        self._xs, self._perms, self._timer = xs, perms, timer

    def _finish(self) -> List[torch.Tensor]:
        return _finish(self._axis, self._works, self._outs, self._xs,
                       self._timer)

    def wait(self) -> List[torch.Tensor]:
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in self._xs):
            return list(_Received.apply(self, *self._xs))
        return self._finish()


def ppermute_start(items: Sequence[Tuple[torch.Tensor, Sequence]],
                   axis: Axis) -> Pending:
    """Start the point-to-point exchanges ``items``, each ``(x, perm)``
    with ``perm`` a list of ``(src, dst)`` axis indices (JAX's
    ``ppermute``): this rank sends its ``x`` to ``dst`` where it is a
    ``src``, and receives the ``x`` of its ``src``, or zeros where it is
    no one's ``dst``.  All of them go in one ``batch_isend_irecv`` (no
    ordering of blocking sends can deadlock a ring), tagged by position
    so two exchanges between one pair of ranks never cross.  Each
    received buffer comes back to the device of the tensor sent."""
    works, outs, timer = _start(items, axis)
    return Pending(axis, works, outs, [x for x, _ in items],
                   [list(p) for _, p in items], timer)


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
    rank's window cut out.  Differentiable: both branches are built of
    the collectives above, so the halo rows' cotangents go back to the
    ranks they came from and add to their edge rows."""
    if halo == 0:
        return x
    axis = _axis_or_active(axis)
    idx, hl = axis.index, x.shape[dim]
    if halo > hl:
        full = all_gather(x, axis, dim)
        shape = list(full.shape)
        shape[dim] = halo
        z = full.new_zeros(shape)
        full = torch.cat([z, full, z], dim=dim)
        return full.narrow(dim, idx * hl, hl + 2 * halo)
    (from_prev, from_next), = _neighbour_rows([x], halo, axis, dim)
    return torch.cat([from_prev, x, from_next], dim=dim)


def _axis_or_active(axis: Optional[Axis]) -> Axis:
    axis = spatial_axis() if axis is None else axis
    if axis is None:
        raise ValueError("a halo needs an axis or an active "
                         "spatial_sharding context")
    return axis


def _neighbour_rows(xs: Sequence[torch.Tensor], halo: int, axis: Axis,
                    dim: int) -> list:
    """For each slab of ``xs``: (the previous rank's last ``halo`` rows,
    the next rank's first), zeros at the image edges, all in one
    exchange."""
    n = axis.size
    up = [(i, i - 1) for i in range(1, n)]      # my top -> the previous rank
    down = [(i, i + 1) for i in range(n - 1)]   # my bottom -> the next rank
    items = []
    for x in xs:
        hl = x.shape[dim]
        items += [(x.narrow(dim, 0, halo), up),
                  (x.narrow(dim, hl - halo, halo), down)]
    got = ppermute_start(items, axis).wait()
    return [(got[2 * k + 1], got[2 * k]) for k in range(len(xs))]


def halo_extend(xs: Sequence[torch.Tensor], halo: int,
                axis: Optional[Axis] = None, dim: int = 1
                ) -> Tuple[List[torch.Tensor], int, int]:
    """Each slab of ``xs`` (one row split) widened by up to ``halo`` rows
    of the interior neighbours on each side, and none beyond the image's
    edges: returns ``(widened, top, bottom)``, the rows added above and
    below (an edge rank's image-edge side adds 0, so a kernel's own zero
    padding is the image's there).  The neighbours' rows of every tensor
    travel in one exchange; where the halo is wider than the slab, each
    tensor's slabs are gathered and this rank's window cut out.
    Differentiable as :func:`halo_exchange`."""
    axis = _axis_or_active(axis)
    n, idx, hl = axis.size, axis.index, xs[0].shape[dim]
    if halo == 0 or n == 1:
        return list(xs), 0, 0
    top = min(halo, idx * hl)
    bottom = min(halo, (n - 1 - idx) * hl)
    if halo > hl:
        return [all_gather(x, axis, dim).narrow(dim, idx * hl - top,
                                                hl + top + bottom)
                for x in xs], top, bottom
    out = []
    for x, (from_prev, from_next) in zip(xs, _neighbour_rows(xs, halo, axis,
                                                             dim)):
        out.append(torch.cat(([from_prev] if top else []) + [x]
                             + ([from_next] if bottom else []), dim=dim))
    return out, top, bottom
