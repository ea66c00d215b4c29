"""The input pipeline: padding and embedding frames on the host (numpy),
batching samples, and staging batches onto the device.

The port's copies of ``pad_to_multiple``, ``pad_to_shape``,
``embed_to_shape``, ``unpad``, ``batch_samples``, ``BatchBuffers``,
``batched``, ``PrefetchLoader`` and ``synthetic_batches`` from the JAX
package's ``data/pipeline.py``.  :class:`PrefetchLoader` stages each batch
in pinned host memory and copies it to the CUDA device on a side stream
(``non_blocking``), optionally augments it there (``augment_fn``, the
device augmentor), and hands the consumer the side stream's event, so a
train step is ordered after its batch's copy and augmentation, which
overlap the step before it.  The evaluation harness pads each frame to a
multiple of its bucket with :func:`pad_to_multiple`.  The serving stack
pads each request to its resolution bucket with :func:`pad_to_shape`
(replicate padding, split between both sides), and under ragged serving
embeds the padded frame corner-anchored into the shared max box with
:func:`embed_to_shape`; :func:`unpad` recovers the request's own
resolution from the flow.  Callers of ``make_ragged_inference_fn`` build
their batches with :func:`embed_to_shape` too.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry.registry import default_registry


def _apply_pads(image: np.ndarray, ph: int, pw: int,
                mode: str) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    if mode == "sintel":
        pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    else:
        pads = (ph, 0, 0, pw)
    t, b, l, r = pads
    width = [(0, 0)] * (image.ndim - 3) + [(t, b), (l, r), (0, 0)]
    return np.pad(image, width, mode="edge"), pads


def pad_to_multiple(image: np.ndarray, multiple: int = 8,
                    mode: str = "sintel"
                    ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Replicate-pad [..., H, W, C] so H and W divide ``multiple``: mode
    'sintel' splits the padding between both sides, 'kitti' pads top and
    right only.  Returns (padded, (top, bottom, left, right)), which
    :func:`unpad` inverts."""
    h, w = image.shape[-3], image.shape[-2]
    return _apply_pads(image, (-h) % multiple, (-w) % multiple, mode)


def pad_to_shape(image: np.ndarray, target_hw: Tuple[int, int],
                 mode: str = "sintel"
                 ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Replicate-pad [..., H, W, C] up to an exact (H, W): mode 'sintel'
    splits the padding between both sides, 'kitti' pads top/right only.
    Returns (padded, (top, bottom, left, right)), which :func:`unpad`
    inverts.  Raises when the image exceeds the target."""
    h, w = image.shape[-3], image.shape[-2]
    th, tw = target_hw
    if h > th or w > tw:
        raise ValueError(f"image ({h}, {w}) exceeds pad target ({th}, {tw})")
    return _apply_pads(image, th - h, tw - w, mode)


def embed_to_shape(arr: np.ndarray,
                   target_hw: Tuple[int, int]) -> np.ndarray:
    """Corner-anchor [..., H, W, C] into an exact (H, W) max box by
    ZERO-padding bottom/right only — the ragged-batch embed.  The content is
    neither centred nor replicated: the ragged model path needs the live
    crop at (0, 0) (it re-masks the dead region itself, so the zeros are a
    contract, not a numerics requirement).  Invert by slicing
    ``out[..., :h, :w, :]``.  Raises when the image exceeds the target."""
    h, w = arr.shape[-3], arr.shape[-2]
    th, tw = target_hw
    if h > th or w > tw:
        raise ValueError(f"image ({h}, {w}) exceeds embed target ({th}, {tw})")
    width = [(0, 0)] * (arr.ndim - 3) + [(0, th - h), (0, tw - w), (0, 0)]
    return np.pad(arr, width)


def unpad(arr: np.ndarray, pads: Tuple[int, int, int, int]) -> np.ndarray:
    """Crop [..., H, W, C] by ``pads`` = (top, bottom, left, right), the
    inverse of :func:`pad_to_shape`."""
    t, b, l, r = pads
    h, w = arr.shape[-3], arr.shape[-2]
    return arr[..., t:h - b if b else h, l:w - r if r else w, :]


def _pipeline_metrics(registry=None):
    """The input pipeline's metrics on the process-default registry."""
    reg = registry or default_registry()
    return {
        "wait": reg.get_or_histogram(
            "raft_data_wait_seconds",
            "Seconds the consumer (train step) blocked waiting for a "
            "staged batch — the starvation signal"),
        "depth": reg.get_or_gauge(
            "raft_data_queue_depth",
            "Staged device batches currently buffered ahead of the consumer"),
        "partial": reg.get_or_counter(
            "raft_data_partial_batches_total",
            "Epoch-final batches smaller than batch_size (dropped unless "
            "drop_remainder=False)"),
        "batches": reg.get_or_counter(
            "raft_data_batches_total",
            "Batches staged onto device by PrefetchLoader"),
    }


def batch_samples(samples: Sequence[Tuple[np.ndarray, ...]]
                  ) -> Tuple[np.ndarray, ...]:
    """Stack a list of per-sample tuples into batched arrays."""
    return tuple(np.stack([s[i] for s in samples])
                 for i in range(len(samples[0])))


class BatchBuffers:
    """Pre-allocated collation buffers: samples are copied row by row into
    a ring of reusable batch arrays instead of ``np.stack`` allocating
    fresh ones every batch.  ``depth`` bounds how many emitted batches may
    be alive at once (the prefetch queue, one being staged, one being
    consumed); :meth:`for_loader` sizes it as ``prefetch_depth + 3``."""

    def __init__(self, batch_size: int, depth: int = 6):
        assert batch_size >= 1 and depth >= 2
        self.batch_size = batch_size
        self.depth = depth
        self._rings: Optional[Tuple[Tuple[np.ndarray, ...], ...]] = None
        self._k = 0

    @classmethod
    def for_loader(cls, batch_size: int, prefetch_depth: int) -> "BatchBuffers":
        return cls(batch_size, depth=prefetch_depth + 3)

    def _ensure(self, sample: Tuple[np.ndarray, ...]) -> None:
        if self._rings is None:
            self._rings = tuple(
                tuple(np.empty((self.batch_size,) + np.shape(f),
                               dtype=np.asarray(f).dtype) for f in sample)
                for _ in range(self.depth))

    def add(self, i: int, sample: Tuple[np.ndarray, ...]) -> None:
        """Copy ``sample`` into row ``i`` of the current batch buffer."""
        self._ensure(sample)
        for buf, field in zip(self._rings[self._k], sample):
            buf[i] = field

    def emit(self, count: int) -> Tuple[np.ndarray, ...]:
        """The filled batch (its first ``count`` rows if partial); the
        ring advances."""
        bufs = self._rings[self._k]
        self._k = (self._k + 1) % self.depth
        if count == self.batch_size:
            return bufs
        return tuple(b[:count] for b in bufs)


def batched(sample_iter: Iterator, batch_size: int,
            drop_remainder: bool = True,
            collator: Optional[BatchBuffers] = None) -> Iterator:
    """Group samples into batches (``np.stack``, or copy-on-arrival into a
    :class:`BatchBuffers` ``collator``).  An epoch-final partial batch is
    dropped unless ``drop_remainder=False``; either way it counts in
    ``raft_data_partial_batches_total``."""
    metrics = _pipeline_metrics()
    n = 0
    buf = []
    for s in sample_iter:
        if collator is not None:
            collator.add(n, s)
        else:
            buf.append(s)
        n += 1
        if n == batch_size:
            yield collator.emit(n) if collator is not None else \
                batch_samples(buf)
            n = 0
            buf = []
    if n:
        metrics["partial"].inc()
        if not drop_remainder:
            yield collator.emit(n) if collator is not None else \
                batch_samples(buf)


class PrefetchLoader:
    """A daemon thread that stages batches (tuples of numpy arrays) onto
    ``device`` ahead of the consumer, at most ``buffer_size`` in the queue.

    On a CUDA device each array is copied into a pinned host buffer (a
    ring of ``buffer_size + 2`` sets, a set reused only after its last
    copy has completed), then to the device with ``non_blocking=True`` on
    a side stream; the consumer gets the device tensors once its current
    stream waits on the copy's event (and the tensors are marked as used
    on that stream), so the step that reads a batch is ordered after its
    copy, while the next batch's copy overlaps it.  A captured train step
    (``training/capture.py``) copies the batch into its static buffers on
    that stream, after the wait; the staged tensors, once the caller drops
    them, return to the allocator only after the stream has passed that
    copy and the replay issued after it.  On the CPU the arrays
    are copied into fresh tensors (the collation buffers are reused).

    ``augment_fn(batch, generator) -> batch`` runs on each staged batch
    (device tensors) on the side stream, after its copy, with a
    ``torch.Generator`` on the device seeded from ``augment_seed`` and the
    batch's index (deterministic per run): the device-side augmentation
    hook (``data/augment_device.py::make_batch_augment_fn``), overlapping
    the consumer's step as the copy does.

    Iterate to exhaustion, or :meth:`close` (also a context manager) on
    early exit: it stops the thread, drops what is staged and joins the
    thread with a timeout.  Telemetry (process-default registry):
    ``raft_data_wait_seconds``, ``raft_data_queue_depth``,
    ``raft_data_batches_total``."""

    def __init__(self, batch_iter: Iterable, device, buffer_size: int = 2,
                 augment_fn: Optional[Callable] = None,
                 augment_seed: int = 0):
        self._iter = iter(batch_iter)
        self._device = torch.device(device)
        self._augment_fn = augment_fn
        self._augment_seed = augment_seed
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._pinned = [None] * (max(1, buffer_size) + 2)
        self._events = [None] * len(self._pinned)
        self._done = object()
        self._error = None
        self._stop = threading.Event()
        self._metrics = _pipeline_metrics()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _augment(self, staged, index: int):
        if self._augment_fn is None:
            return staged
        gen = torch.Generator(device=self._device).manual_seed(
            (self._augment_seed * 1_000_003 + index) % (2 ** 63))
        return tuple(self._augment_fn(staged, gen))

    def _stage(self, batch, index: int):
        if not self._cuda:
            staged = tuple(torch.tensor(np.asarray(x)) for x in batch)
            return self._augment(staged, index), None
        k = index % len(self._pinned)
        if self._events[k] is not None:
            self._events[k].synchronize()       # its last copy has landed
        bufs = self._pinned[k]
        if bufs is None or [tuple(b.shape) for b in bufs] != \
                [tuple(np.shape(x)) for x in batch]:
            bufs = [torch.empty(np.shape(x), dtype=torch.from_numpy(
                np.asarray(x)[:0]).dtype, pin_memory=True) for x in batch]
            self._pinned[k] = bufs
        for b, x in zip(bufs, batch):
            b.numpy()[...] = x
        with torch.cuda.stream(self._stream):
            staged = tuple(b.to(self._device, non_blocking=True) for b in bufs)
            staged = self._augment(staged, index)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[k] = event
        return staged, event

    def _put(self, item) -> bool:
        """A bounded put that gives up when close() is racing."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self):
        try:
            for index, batch in enumerate(self._iter):
                if self._stop.is_set():
                    return
                if not self._put(self._stage(batch, index)):
                    return
                self._metrics["batches"].inc()
                self._metrics["depth"].set(self._q.qsize())
        except BaseException as e:   # surfaced in the consumer
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.monotonic()
        item = self._q.get()
        self._metrics["wait"].observe(time.monotonic() - t0)
        self._metrics["depth"].set(self._q.qsize())
        if item is self._done:
            if self._error is not None:
                raise RuntimeError("input pipeline worker failed") \
                    from self._error
            raise StopIteration
        staged, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in staged:
                t.record_stream(current)
        return staged

    def close(self) -> None:
        """Stop the thread, drop staged batches, join it (5 s timeout).
        Idempotent; safe mid-iteration."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=5)
        self._metrics["depth"].set(0)
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def synthetic_batches(batch_size: int, size: Tuple[int, int], seed: int = 0,
                      max_flow: float = 10.0) -> Iterator:
    """Endless random (im1, im2, flow, valid) batches: smoke-test input
    with no flow structure."""
    rng = np.random.RandomState(seed)
    h, w = size
    while True:
        im1 = rng.rand(batch_size, h, w, 3).astype(np.float32)
        im2 = rng.rand(batch_size, h, w, 3).astype(np.float32)
        flow = (rng.rand(batch_size, h, w, 2).astype(np.float32) - 0.5) \
            * max_flow
        valid = np.ones((batch_size, h, w), np.float32)
        yield im1, im2, flow, valid
