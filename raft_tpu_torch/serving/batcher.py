"""Dynamic micro-batcher: coalesce, pad, execute, deliver — and contain.

One daemon thread pulls same-bucket FIFO runs from the admission queue
(``RequestQueue.take_batch``: full batch, aged ``max_wait_ms``, or drain —
whichever first), pads the group up to the next declared batch step by
repeating the last pair (any filler works — per-sample inference is
independent; repetition keeps values finite for the instance norms), runs
the warm engine, slices real rows back out, unpads each to its request's
original resolution, and resolves the waiting handler threads.

The engine is injected as a callable ``run(bucket, im1, im2) -> flow`` so
tests can drive the batching policy with a stub (slow / counting / failing)
engine and never touch a compile.

Failure containment (SERVING.md "Failure modes & degradation ladder"):

* **Non-finite sentinel** — every flow output is row-checked host-side;
  a NaN/Inf row fails only ITS request (HTTP 500, status ``poisoned``,
  ``raft_nonfinite_outputs_total``) while co-batched neighbors resolve.
* **Poisoned-batch bisection** — an engine exception is first retried
  (transient device errors heal under backoff), then the batch is
  split-and-retried so only the guilty request fails with
  :class:`PoisonedRequest`; innocents succeed.  Sub-groups pad to the
  declared batch steps, so bisection never compiles a new shape.  Total
  engine calls per batch are capped by a budget (~2x the group size per
  attempt), so a sick engine cannot trap the thread in retry storms.
* **Crash surface** — an exception escaping the loop itself fails any
  in-flight requests and is handed to the server's supervisor, which
  restarts the thread (``server.BatcherSupervisor``).  KeyboardInterrupt/
  SystemExit are re-raised after failing the batch, never swallowed.

Streaming steps (serving/stream.py) share this thread — ONE owner of the
device.  Session OPENS execute solo via the injected ``stream_fn`` (the
queue keys them per session id: an open runs the encode executable and
has nothing to coalesce with); ADVANCES key per bucket and coalesce
across *different* sessions exactly like pairwise work — a popped run
of them goes to ``stream_group_fn`` (the coordinator's continuous-
batched step: one device call advances the whole group, per-row
non-finite sentinel + degrade-to-cold heal inside).  A popped run is
always homogeneous: all-pairwise, all-advances (one bucket), or one
open — the keys guarantee it.

Thread model (SERVING.md "Threading model"): the batcher deliberately
holds **no lock of its own** — single ownership IS its synchronization.
``batches``/``served``/``timed_out`` and ``_inflight_batch`` are written
only on the loop thread (``restart()`` builds a new thread only after
the old one has died, so single-writer holds across restarts); other
threads only ever read them (serve_cli's exit line, /healthz, tests),
which is why raftlint's C1/C6 — scoped to lock-HOLDING classes — do not
apply here.  Everything shared it touches synchronizes on the owner's
lock: the queue's (take_batch), the breaker's (record), the store's
(attach/demote, inside stream_fn) — always one at a time, so the
batcher thread can never hold two locks and can never deadlock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..data.pipeline import unpad
from ..telemetry import events as tlm_events
from ..telemetry import spans as tlm_spans
from .queue import DeadlineExceeded, RequestQueue


class PoisonedRequest(RuntimeError):
    """The bisected-guilty request of a failing batch: the engine fails
    whenever this request is present, after retries (HTTP 500, error
    class ``poisoned``)."""
    trace_status = tlm_spans.POISONED


class NonFiniteOutput(RuntimeError):
    """The engine produced NaN/Inf flow for this request's row (HTTP 500,
    error class ``poisoned``) — inputs were validated at the HTTP edge
    (http.py), so a non-finite *output* is an engine-side failure."""
    trace_status = tlm_spans.POISONED


class BatcherCrashed(RuntimeError):
    """The batcher thread died while this request was in flight; the
    supervisor restarts the loop — retry the request."""
    trace_status = tlm_spans.ERROR


def _fresh_error(e: BaseException) -> BaseException:
    """Clone a group-wide failure per waiter: the HTTP layer stamps the
    request's trace id onto the exception it receives, so a SHARED
    instance would cross-wire ids between co-batched clients.  A
    constructor that rejects its own args (kwarg-only shutdown wrappers)
    falls back to the shared instance — still a correct failure;
    stamp-if-absent keeps the first trace id."""
    try:
        return type(e)(*e.args)
    except Exception:
        return e


class MicroBatcher:
    def __init__(self, queue: RequestQueue, run_fn: Callable,
                 pad_batch_to: Callable[[int], int], max_batch: int,
                 max_wait_ms: float, metrics: Optional[Dict] = None,
                 stream_fn: Optional[Callable] = None,
                 stream_group_fn: Optional[Callable] = None,
                 breaker=None, faults=None, retries: int = 1,
                 retry_backoff_s: float = 0.02, on_crash=None,
                 ragged: bool = False, ragged_batch_pixels: int = 0):
        self.queue = queue
        self.run_fn = run_fn
        # ragged mixed-resolution mode (SERVING.md "Ragged serving"):
        # every pairwise request is queued under the shared max-box
        # bucket (so the FIFO coalesces across resolutions for free) and
        # run_fn is called with a 4th arg — per-row [b, 2] int32 live
        # sizes built from each request's routed bucket (Request.rbucket).
        # ragged_batch_pixels > 0 bounds one device batch's LIVE-pixel
        # footprint: a popped run is greedily chunked so co-batched live
        # pixels never exceed the budget (a 1080p row can't starve a
        # group of thumbnails); 0 = unbounded.
        self.ragged = ragged
        self.ragged_batch_pixels = ragged_batch_pixels
        # streaming steps (serving/stream.py) ride the same queue and the
        # same device-owning thread: stream_fn takes ONE StreamRequest
        # (session open / solo fallback) and returns (padded flow or
        # None, iters_used or None); stream_group_fn takes a coalesced
        # LIST of same-bucket advances and returns per-row
        # (flow, iters_used, err) tuples (the continuous-batched path)
        self.stream_fn = stream_fn
        self.stream_group_fn = stream_group_fn
        self.pad_batch_to = pad_batch_to
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.metrics = metrics or {}
        self.breaker = breaker            # CircuitBreaker or None
        self.faults = faults              # FaultInjector or None (chaos)
        self.retries = retries            # same-group retries before bisect
        self.retry_backoff_s = retry_backoff_s
        self.on_crash = on_crash          # supervisor hook: (exception) ->
        self.batches = 0
        self.served = 0
        self.timed_out = 0
        self._inflight_batch = None       # the popped-but-unresolved batch
        self._thread = self._new_thread()

    def _new_thread(self) -> threading.Thread:
        return threading.Thread(target=self._thread_main, daemon=True,
                                name="raft-serving-batcher")

    def start(self) -> None:
        self._thread.start()

    def restart(self) -> None:
        """Supervisor hook: bring up a fresh loop thread after a crash."""
        self._thread = self._new_thread()
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _observe(self, name: str, *args) -> None:
        m = self.metrics.get(name)
        if m is None:
            return
        if args and hasattr(m, "observe"):
            m.observe(args[0])
        elif hasattr(m, "labels") and len(args) == 2:
            m.labels(args[0]).inc(args[1])
        elif hasattr(m, "inc"):
            m.inc(*args)

    def _observe_waste(self, group, padded: int) -> None:
        """raft_batch_padding_waste_ratio: the fraction of one device
        batch's pixels that is padding — batch-fill rows plus, under
        --ragged, each row's dead embedding beyond its routed resolution
        (``pads`` are relative to the device box in both modes, so live
        pixels fall straight out of them).  Dense same-bucket batches
        report only the batch-fill share; the ragged sweep compares the
        two."""
        bh, bw = group[0].bucket[-2:]
        box = float(bh * bw)
        live = sum((bh - p[0] - p[1]) * (bw - p[2] - p[3])
                   for p in (r.pads for r in group))
        self._observe("padding_waste", (padded * box - live) / (padded * box))

    def _chunks(self, batch):
        """Split a popped run so one chunk's live-pixel footprint stays
        under ``ragged_batch_pixels`` (never splitting below one row);
        identity in dense mode or with the budget unset."""
        if not self.ragged or self.ragged_batch_pixels <= 0 \
                or len(batch) < 2:
            return [batch]
        out, cur, acc = [], [], 0
        for r in batch:
            h, w = r.rbucket
            px = h * w
            if cur and acc + px > self.ragged_batch_pixels:
                out.append(cur)
                cur, acc = [], 0
            cur.append(r)
            acc += px
        if cur:
            out.append(cur)
        return out

    def _fail_expired(self, expired) -> None:
        now = time.monotonic()
        for r in expired:
            self.timed_out += 1
            self._observe("requests", "timeout", 1)
            if r.trace is not None:
                # the whole life of an expired request WAS queue wait
                r.trace.span("queue_wait", r.enqueued_at, now,
                             status=tlm_spans.TIMEOUT)
            r.fail(DeadlineExceeded(
                f"deadline exceeded after "
                f"{time.monotonic() - r.enqueued_at:.3f}s in queue"))

    def _execute_stream(self, r) -> None:
        """One SOLO sessionful step — session opens (keyed per session:
        nothing to coalesce with) and the no-group-executor fallback.
        It observes the stream-step families at its real width (batch 1,
        occupancy 1.0); coalesced advances go through
        :meth:`_execute_stream_group` instead, which also folds into the
        shared batch-size/occupancy histograms."""
        if self.stream_fn is None:
            r.fail(RuntimeError("stream request on a batcher without a "
                                "stream executor"))
            return
        if r.abandoned:
            # the handler gave up waiting (already counted status=timeout)
            # and released the session lock: executing now would mutate
            # session state a retry may be racing — drop the step instead
            r.fail(DeadlineExceeded(
                f"stream step {r.id} abandoned by its handler"))
            return
        tr = r.trace
        if tr is not None:
            tr.span("queue_wait", r.enqueued_at, r.dequeued_at)
            tlm_spans.set_device_slot([])
        self._observe("inflight", 1)
        t0 = time.monotonic()
        err, flow, iters_used = None, None, None
        try:
            flow, iters_used = self.stream_fn(r)
        except BaseException as e:
            # the stream executor already retried cold internally; a step
            # failing here is terminal for this frame.  Never swallow a
            # shutdown signal: fail the request, then let KeyboardInterrupt
            # / SystemExit keep propagating.
            err = e
        calls = tlm_spans.take_device_slot()
        t1 = time.monotonic()
        self._observe("inflight", -1)
        self._observe("batch_latency", t1 - t0)
        self._observe("stream_steps")
        self._observe("stream_step_seconds", t1 - t0)
        self._observe("stream_step_batch", 1.0)
        self._observe("stream_step_occupancy", 1.0)
        if tr is not None:
            # spans BEFORE resolve/fail: the handler wakes on either and
            # finishes the trace — a late span would hit a closed trace
            eid = tr.span("execute", t0, t1,
                          status=(tlm_spans.OK if err is None
                                  else tlm_spans.status_of(err)),
                          batch_real=1, batch_padded=1)
            for kind, c0, c1, c2 in calls or ():
                tr.span("execute_dispatch", c0, c1, parent=eid, call=kind)
                tr.span("execute_block", c1, c2, parent=eid, call=kind)
        if err is not None:
            if self.breaker is not None:
                self.breaker.record(False)
            self._observe("requests", "error", 1)
            r.fail(err)
            if not isinstance(err, Exception):
                raise err
            return
        if self.breaker is not None:
            self.breaker.record(True)
        r.batch_real = r.batch_padded = 1
        if iters_used is not None:
            r.iters_used = int(np.asarray(iters_used).reshape(-1)[0])
            self._observe("iters_used", float(r.iters_used))
        now = time.monotonic()
        self._observe("queue_latency", r.dequeued_at - r.enqueued_at)
        self._observe("request_latency", now - r.enqueued_at)
        self._observe("requests", "ok", 1)
        self.served += 1
        if flow is None:                 # session open: no pair yet
            r.resolve(None)
        else:
            self._observe("pairs", 1.0)
            r.resolve(unpad(flow[:1], r.pads)[0])

    # -- continuous-batched stream advances --------------------------------

    def _execute_stream_group(self, batch) -> None:
        """A coalesced run of same-bucket stream ADVANCES: one batched
        device call for the whole group (serving/stream.py
        ``execute_group`` — per-row sentinel and degrade-to-cold heal
        inside), then per-row resolve/fail here.  Folds into the SAME
        batch-size/occupancy histograms as pairwise batches (a stream
        step is now a first-class device batch) and reports the
        ``raft_stream_step_*`` families at the group's real width."""
        group = []
        for r in batch:
            if r.abandoned:
                # the handler gave up waiting (already counted
                # status=timeout) and released the session lock:
                # executing now would mutate session state a retry may
                # be racing — drop the row, keep its batch-mates
                r.fail(DeadlineExceeded(
                    f"stream step {r.id} abandoned by its handler"))
                continue
            group.append(r)
        if not group:
            return
        n = len(group)
        padded = self.pad_batch_to(min(n, self.max_batch))
        traced = [r for r in group if r.trace is not None]
        t_form1 = time.monotonic()
        for r in traced:
            r.trace.span("queue_wait", r.enqueued_at, r.dequeued_at)
            r.trace.span("batch_form", r.dequeued_at, t_form1, group=n)
        self._observe_waste(group, padded)
        self._observe("inflight", 1)
        if traced:
            tlm_spans.set_device_slot([])
        t0 = time.monotonic()
        err, outcomes = None, None
        try:
            outcomes = self.stream_group_fn(group)
        except BaseException as e:
            # the group executor contains per-row failures itself; an
            # exception escaping it is a crash or a shutdown signal —
            # fail every row (fresh same-type instance each: the HTTP
            # layer stamps per-request trace ids), then let
            # KeyboardInterrupt / SystemExit keep propagating
            err = e
        calls = tlm_spans.take_device_slot() if traced else ()
        t1 = time.monotonic()
        self._observe("inflight", -1)
        self._observe("batch_latency", t1 - t0)
        self._observe("stream_step_seconds", t1 - t0)
        if err is None:
            # honest device-step accounting: only rows whose result came
            # from the batched call report its width (r.warm, set by the
            # coordinator); demoted/healed rows ran solo cold restarts
            # and report width-1 steps — raft_stream_step_batch and the
            # shared batch histograms can never claim coalescing the
            # device didn't actually do
            warm_rows = sum(1 for r in group if r.warm)
            cold_rows = n - warm_rows
            if warm_rows:
                self._observe("stream_steps")
                self._observe("stream_step_batch", float(warm_rows))
                self._observe("stream_step_occupancy", warm_rows / padded)
                self._observe("batch_size", float(warm_rows))
                self._observe("batch_occupancy", warm_rows / padded)
            if cold_rows:
                self._observe("stream_steps", cold_rows)
                for _ in range(cold_rows):
                    self._observe("stream_step_batch", 1.0)
                    self._observe("stream_step_occupancy", 1.0)
        exec_sid = tlm_spans.new_span_id()

        def _exec_span(tr, status):
            tr.span("execute", t0, t1, status=status, span_id=exec_sid,
                    batch_real=n, batch_padded=padded)
            for kind, c0, c1, c2 in calls or ():
                tr.span("execute_dispatch", c0, c1, parent=exec_sid,
                        call=kind)
                tr.span("execute_block", c1, c2, parent=exec_sid,
                        call=kind)

        if err is not None:
            if self.breaker is not None:
                self.breaker.record(False)
            for r in group:
                if r.trace is not None:
                    _exec_span(r.trace, tlm_spans.status_of(err))
                self._observe("requests", "error", 1)
                r.fail(_fresh_error(err))
            if not isinstance(err, Exception):
                raise err
            return
        now = time.monotonic()
        served = 0
        for r, (flow, iters_used, rerr) in zip(group, outcomes):
            self._observe("queue_latency", r.dequeued_at - r.enqueued_at)
            self._observe("request_latency", now - r.enqueued_at)
            r.batch_real, r.batch_padded = n, padded
            if rerr is not None:
                status = ("poisoned"
                          if getattr(rerr, "trace_status", None)
                          == tlm_spans.POISONED else "error")
                if r.trace is not None:
                    _exec_span(r.trace, tlm_spans.status_of(rerr))
                self._observe("requests", status, 1)
                r.fail(rerr)
                continue
            if r.trace is not None:
                _exec_span(r.trace, tlm_spans.OK)
            if iters_used is not None:
                r.iters_used = int(iters_used)
                self._observe("iters_used", float(r.iters_used))
            self._observe("requests", "ok", 1)
            self.served += 1
            served += 1
            r.resolve(unpad(flow[:1], r.pads)[0])
        if served:
            self._observe("pairs", float(served))

    # -- pairwise execution: retry -> bisect -> sentinel -------------------

    def _bisect_budget(self, n: int) -> int:
        """Engine-call cap for one batch's recovery: a full binary
        bisection of an all-poisoned group of n costs 2n-1 calls; allow
        that at every retry attempt, nothing more."""
        return (self.retries + 1) * 2 * n

    def _execute(self, batch) -> None:
        op = getattr(batch[0], "stream_op", None)
        if op is not None:
            if op == "advance" and self.stream_group_fn is not None:
                self._execute_stream_group(batch)
            else:
                for r in batch:
                    self._execute_stream(r)
            return
        for r in batch:
            if r.trace is not None:
                r.trace.span("queue_wait", r.enqueued_at, r.dequeued_at)
        for group in self._chunks(batch):
            n = len(group)
            padded = self.pad_batch_to(min(n, self.max_batch))
            self._observe("batch_size", float(n))
            self._observe("batch_occupancy", n / padded)
            self._observe_waste(group, padded)
            self._observe("inflight", 1)
            t0 = time.monotonic()
            try:
                budget = [self._bisect_budget(n)]
                self._run_group(group, budget)
            finally:
                self._observe("inflight", -1)
                self._observe("batch_latency", time.monotonic() - t0)

    def _run_group(self, group, budget, formed: bool = False) -> None:
        """Run one same-bucket group; on persistent engine failure, split
        and retry halves so only the guilty request(s) fail.  ``budget``
        is the batch-wide engine-call allowance (mutable 1-list);
        ``formed`` marks bisection sub-groups (the batch_form span is
        recorded once, on the original group)."""
        n = len(group)
        padded = self.pad_batch_to(min(n, self.max_batch))
        traced = [r for r in group if r.trace is not None]
        t_form1 = time.monotonic()
        if not formed:
            for r in traced:
                r.trace.span("batch_form", r.dequeued_at, t_form1, group=n)
        im1 = np.concatenate([r.image1 for r in group]
                             + [group[-1].image1] * (padded - n))
        im2 = np.concatenate([r.image2 for r in group]
                             + [group[-1].image2] * (padded - n))
        t_pad1 = time.monotonic()
        for r in traced:
            r.trace.span("pad", t_form1, t_pad1, padded=padded)
        out, err, attempts = None, None, 0
        t_exec0 = time.monotonic()
        if traced:
            tlm_spans.set_device_slot([])
        while attempts <= self.retries and budget[0] > 0:
            attempts += 1
            budget[0] -= 1
            try:
                if self.ragged:
                    # per-row live sizes from each request's routed
                    # bucket; filler rows repeat the last request's, to
                    # match its repeated pixels
                    rb = ([r.rbucket for r in group]
                          + [group[-1].rbucket] * (padded - n))
                    out = self.run_fn(group[0].bucket, im1, im2,
                                      np.asarray(rb, np.int32))
                else:
                    out = self.run_fn(group[0].bucket, im1, im2)
            except Exception as e:
                # transient device errors heal under a short backoff;
                # persistent ones fall through to bisection below
                if self.breaker is not None:
                    self.breaker.record(False)
                err = e
                if attempts <= self.retries and budget[0] > 0:
                    time.sleep(self.retry_backoff_s)
                continue
            except BaseException as e:
                # shutdown (KeyboardInterrupt/SystemExit): fail the group
                # so no handler hangs, then keep propagating — swallowing
                # it here would eat Ctrl-C.  Same type per waiter, but a
                # FRESH instance each (_fresh_error)
                t_x = time.monotonic()
                tlm_spans.take_device_slot()
                sid = tlm_spans.new_span_id()
                for r in group:
                    if r.trace is not None:
                        r.trace.span("execute", t_exec0, t_x,
                                     status=tlm_spans.ERROR, span_id=sid,
                                     batch_real=n, batch_padded=padded)
                    self._observe("requests", "error", 1)
                    r.fail(_fresh_error(e))
                raise
            if self.breaker is not None:
                self.breaker.record(True)
            err = None
            break
        calls = tlm_spans.take_device_slot() if traced else ()
        t_exec1 = time.monotonic()
        # co-batched requests SHARE one execute span id (the join key
        # across their traces); each trace holds its own copy with its
        # own queue spans around it
        exec_sid = tlm_spans.new_span_id()

        def _exec_span(tr, status):
            tr.span("execute", t_exec0, t_exec1, status=status,
                    span_id=exec_sid, batch_real=n, batch_padded=padded,
                    attempts=attempts)
            for kind, c0, c1, c2 in calls or ():
                tr.span("execute_dispatch", c0, c1, parent=exec_sid,
                        call=kind)
                tr.span("execute_block", c1, c2, parent=exec_sid,
                        call=kind)

        if out is None and err is None:
            # budget ran dry before this sub-group got a single attempt
            err = RuntimeError("bisection budget exhausted before this "
                               "sub-group could execute")
        if err is not None:
            if n == 1 and attempts:
                # bisected down to the guilty request: the 'poisoned'
                # error class — co-batched neighbors already succeeded
                if group[0].trace is not None:
                    _exec_span(group[0].trace, tlm_spans.POISONED)
                self._observe("requests", "poisoned", 1)
                group[0].fail(PoisonedRequest(
                    f"request {group[0].id} poisons its batch: engine "
                    f"failed after {attempts} attempt(s): {err}"))
                return
            if budget[0] <= 0:
                # retry budget exhausted mid-bisection: the engine is
                # sick, not one request — fail the remainder as plain
                # errors (the breaker is already counting these).  Each
                # request gets its OWN exception instance: the HTTP
                # layer stamps the request's trace id onto it, and a
                # shared instance would cross-wire ids between
                # co-batched clients
                for r in group:
                    if r.trace is not None:
                        _exec_span(r.trace, tlm_spans.ERROR)
                    self._observe("requests", "error", 1)
                    r.fail(RuntimeError(
                        f"engine failing across requests (retry budget "
                        f"exhausted): {err}"))
                return
            # the failed attempt stays visible in every trace (status
            # "retry"); the sub-groups record their own execute spans
            for r in traced:
                _exec_span(r.trace, "retry")
            mid = n // 2
            self._run_group(group[:mid], budget, formed=True)
            self._run_group(group[mid:], budget, formed=True)
            return
        # converge-policy engines return (flows, per-row iters_used); only
        # REAL rows are accounted — padding rows repeat the last request
        # and would skew the raft_iters_used distribution
        iters_used = None
        flows = out
        if isinstance(flows, tuple):
            flows, iters_used = flows
        flows = np.asarray(flows)
        # non-finite OUTPUT sentinel: inputs were validated at the HTTP
        # edge, so a NaN/Inf row here is the engine's failure — fail that
        # row alone, its neighbors are fine (per-sample independence)
        row_ok = np.isfinite(flows[:n].reshape(n, -1)).all(axis=1)
        now = time.monotonic()
        served = 0
        # every row's bookkeeping first, then the wake-ups in one tight
        # loop: a handler woken early competes with this thread for the
        # interpreter lock, so resolving row by row made each later row
        # wait for its earlier neighbours' responses
        deliver = []
        for i, r in enumerate(group):
            r.batch_real, r.batch_padded = n, padded
            if iters_used is not None:
                r.iters_used = int(iters_used[i])
                self._observe("iters_used", float(iters_used[i]))
            self._observe("queue_latency", r.dequeued_at - r.enqueued_at)
            self._observe("request_latency", now - r.enqueued_at)
            if row_ok[i]:
                if r.trace is not None:
                    _exec_span(r.trace, tlm_spans.OK)
                self._observe("requests", "ok", 1)
                self.served += 1
                served += 1
                deliver.append((r.resolve,
                                unpad(flows[i:i + 1], r.pads)[0]))
            else:
                if r.trace is not None:
                    _exec_span(r.trace, tlm_spans.POISONED)
                self._observe("nonfinite")
                self._observe("requests", "poisoned", 1)
                log = tlm_events.current()
                if log is not None:
                    # joinable to the request trace (chaos drills): the
                    # sentinel's run-log record carries the trace id
                    log.event("nonfinite_output", request=r.id,
                              trace_id=(r.trace.trace_id
                                        if r.trace is not None else None))
                deliver.append((r.fail, NonFiniteOutput(
                    f"non-finite flow output for request {r.id} "
                    f"(poisoned row in an otherwise-healthy batch)")))
        for finish, value in deliver:
            finish(value)
        if served:
            self._observe("pairs", float(served))

    # -- the loop + its crash surface --------------------------------------

    def _loop(self) -> None:
        while True:
            batch, expired = self.queue.take_batch(self.max_batch,
                                                   self.max_wait)
            self._fail_expired(expired)
            if batch is None:        # queue closed and empty: drained
                return
            if batch:
                self.batches += 1
                # cleared only on the success path: an exception escaping
                # here must leave the batch visible to _thread_main's
                # crash handler (it fails whatever is not yet done)
                self._inflight_batch = batch
                # ambient trace ids for this batch: out-of-band
                # diagnostics fired from under here (fault_injected,
                # lock_violation, the non-finite sentinel) become
                # joinable to the request traces they hit
                tlm_spans.set_current_trace_ids(tuple(
                    r.trace.trace_id for r in batch
                    if r.trace is not None))
                try:
                    if self.faults is not None:
                        self.faults.maybe_kill()   # chaos: thread-death arm
                    self._execute(batch)
                finally:
                    tlm_spans.set_current_trace_ids(())
                self._inflight_batch = None

    def _thread_main(self) -> None:
        try:
            self._loop()
        except BaseException as e:
            # the crash surface: fail whatever was popped but unresolved
            # (handler threads must never hang on a dead batcher), then
            # hand an Exception to the supervisor for restart; shutdown
            # signals propagate — threading's excepthook reports them
            for r in (self._inflight_batch or []):
                if not r.done:
                    self._observe("requests", "error", 1)
                    if r.trace is not None:
                        # finish (idempotent) BEFORE failing: the
                        # supervisor dumps the flight recorder on this
                        # thread right after, and the crashed trace must
                        # already be in the ring — the woken handler's
                        # own finish becomes a no-op
                        r.trace.finish(tlm_spans.ERROR)
                    r.fail(BatcherCrashed(
                        f"batcher thread died mid-batch ({e!r}); "
                        f"the supervisor restarts it — retry"))
            self._inflight_batch = None
            if self.on_crash is not None and isinstance(e, Exception):
                self.on_crash(e)
            else:
                raise
