"""Admission queue: bounded, deadline-aware, per-bucket FIFO.

One global depth bound gives the backpressure contract — a submission past
``queue_depth`` waiting requests is shed immediately with :class:`QueueFull`
(the HTTP layer turns that into 429) instead of growing an unbounded backlog
whose tail would all miss its deadlines anyway.  Inside the bound, requests
are FIFO per resolution bucket so the micro-batcher can coalesce same-shape
neighbors without head-of-line blocking across buckets.

Deadlines use ``time.monotonic``.  A request whose deadline passes while it
still waits is completed with :class:`DeadlineExceeded` (HTTP 504) by the
batcher's purge pass — it never reaches the device.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..lint.concurrency import guarded_by
from ..telemetry.watchdogs import watched_lock


class RejectedError(Exception):
    """Base: request refused before reaching the device.  ``retry_after``
    (seconds, None = don't advertise) rides to the HTTP layer as a
    ``Retry-After`` header on 429/503 responses — the docstrings always
    promised "retry with backoff"; now the wire says when.
    ``trace_status`` is the request-trace disposition this rejection maps
    to (telemetry/spans.py status taxonomy)."""
    http_status = 500
    retry_after: Optional[float] = None
    trace_status = "shed"


class QueueFull(RejectedError):
    """Admission queue at capacity — shed, try again later (429)."""
    http_status = 429
    retry_after = 1.0


class Draining(RejectedError):
    """Server is shutting down; no new work accepted (503)."""
    http_status = 503
    retry_after = 5.0


class DeadlineExceeded(RejectedError):
    """Deadline passed while the request waited (504)."""
    http_status = 504
    trace_status = "timeout"


_ids = itertools.count(1)


class Request:
    """One image pair in flight.  The submitting (HTTP handler) thread
    blocks on ``wait()``; the batcher thread delivers via ``resolve``/
    ``fail``."""

    __slots__ = ("id", "image1", "image2", "bucket", "rbucket", "pads",
                 "deadline", "enqueued_at", "dequeued_at", "finished_at",
                 "_done", "result", "error", "batch_real", "batch_padded",
                 "iters_used", "trace")

    def __init__(self, image1: np.ndarray, image2: np.ndarray,
                 bucket: Tuple[int, int], pads: Tuple[int, int, int, int],
                 deadline: float,
                 rbucket: Optional[Tuple[int, int]] = None):
        self.id = next(_ids)
        self.image1 = image1          # padded [1, BH, BW, 3] float32
        self.image2 = image2
        self.bucket = bucket
        # routed bucket: the resolution this request was routed to before
        # any ragged max-box embedding.  == bucket in dense mode; under
        # --ragged, bucket is the shared max box (so the FIFO coalesces
        # across resolutions) and rbucket is the live extent the batcher
        # passes as the row's sizes.
        self.rbucket = bucket if rbucket is None else rbucket
        self.pads = pads
        self.deadline = deadline      # monotonic seconds
        self.enqueued_at = time.monotonic()
        self.dequeued_at: Optional[float] = None
        # stamped at resolve/fail: the respond span starts here, so the
        # event-wake gap (resolve -> handler thread scheduled) is
        # attributed to response delivery, not lost
        self.finished_at: Optional[float] = None
        self._done = threading.Event()
        self.result: Optional[np.ndarray] = None   # unpadded [h, w, 2]
        self.error: Optional[BaseException] = None
        self.batch_real = 0
        self.batch_padded = 0
        # GRU iterations this request's sample actually spent (set by the
        # batcher under --iters-policy converge:*; None under 'fixed')
        self.iters_used: Optional[int] = None
        # request-scoped trace (telemetry.spans.RequestTrace) attached by
        # the server at admission; None when tracing is sampled out
        self.trace = None

    @property
    def done(self) -> bool:
        """Resolved or failed (the supervisor's in-flight check)."""
        return self._done.is_set()

    def resolve(self, flow: np.ndarray) -> None:
        self.result = flow
        self.finished_at = time.monotonic()
        self._done.set()

    def fail(self, err: BaseException) -> None:
        self.error = err
        self.finished_at = time.monotonic()
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise DeadlineExceeded(f"request {self.id} still pending after "
                                   f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class RequestQueue:
    """Bounded multi-bucket FIFO shared by submitters and the batcher.

    Thread model: HTTP handler threads ``submit``; the batcher thread
    ``take_batch``es (and waits on ``_cond``, which wraps — i.e. aliases —
    ``_lock``).  Everything mutable is guarded by ``_lock``; a stream
    handler submits while holding its session lock, so in the declared
    hierarchy this lock sits INSIDE ``Session.lock`` (SERVING.md)."""

    _by_bucket = guarded_by("_lock")
    _size = guarded_by("_lock")
    _closed = guarded_by("_lock")

    def __init__(self, depth: int):
        self.depth = depth
        self._lock = watched_lock("RequestQueue._lock")
        self._cond = threading.Condition(self._lock)
        self._by_bucket: Dict[Tuple[int, int], List[Request]] = {}
        self._size = 0
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return self._size

    def submit(self, req: Request) -> None:
        """Admit or shed.  Raises QueueFull / Draining; never blocks."""
        with self._lock:
            if self._closed:
                raise Draining("server is draining; not accepting requests")
            if self._size >= self.depth:
                raise QueueFull(f"queue at capacity ({self.depth} waiting)")
            self._by_bucket.setdefault(req.bucket, []).append(req)
            self._size += 1
            self._cond.notify()

    def close(self) -> None:
        """Stop admitting; wakes the batcher so it can drain and exit."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @guarded_by("_lock")
    def _purge_expired_locked(self, now: float) -> List[Request]:
        expired = []
        for bucket, fifo in list(self._by_bucket.items()):
            keep = []
            for r in fifo:
                (expired if r.deadline <= now else keep).append(r)
            if len(keep) != len(fifo):
                # drop emptied keys: stream requests key per SESSION, so a
                # long-lived server would otherwise accrete one dead list
                # per session ever seen
                if keep:
                    self._by_bucket[bucket] = keep
                else:
                    del self._by_bucket[bucket]
        self._size -= len(expired)
        return expired

    def take_batch(self, max_batch: int, max_wait: float):
        """Batcher side: block until a batch is ready, then pop it.

        Returns (batch, expired) where ``batch`` is a same-bucket FIFO run
        of up to ``max_batch`` requests (None when the queue closed empty)
        and ``expired`` are requests whose deadline passed while queued —
        the caller fails those with DeadlineExceeded.  A batch is ready
        when some bucket holds max_batch requests, when the oldest waiting
        request has aged ``max_wait`` seconds, or when the queue is closed
        (drain: flush immediately, ignore max_wait).
        """
        with self._lock:
            while True:
                now = time.monotonic()
                expired = self._purge_expired_locked(now)
                best, best_head = None, None
                for bucket, fifo in self._by_bucket.items():
                    if not fifo:
                        continue
                    head = fifo[0].enqueued_at
                    if best is None or head < best_head:
                        best, best_head = bucket, head
                if best is not None:
                    fifo = self._by_bucket[best]
                    full = len(fifo) >= max_batch
                    aged = now - best_head >= max_wait
                    if full or aged or self._closed:
                        batch = fifo[:max_batch]
                        rest = fifo[len(batch):]
                        if rest:
                            self._by_bucket[best] = rest
                        else:           # see _purge_expired_locked
                            del self._by_bucket[best]
                        self._size -= len(batch)
                        for r in batch:
                            r.dequeued_at = now
                        return batch, expired
                    timeout = best_head + max_wait - now
                elif self._closed:
                    return None, expired
                else:
                    timeout = None
                if expired:
                    # deliver timeouts promptly rather than after the wait
                    return [], expired
                self._cond.wait(timeout)

    def drain_remaining(self) -> List[Request]:
        """Pop everything still queued (used on hard shutdown)."""
        with self._lock:
            out = [r for fifo in self._by_bucket.values() for r in fifo]
            self._by_bucket.clear()
            self._size = 0
            return out
