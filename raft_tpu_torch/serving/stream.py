"""Sessionful streaming flow: the machinery behind ``POST /v1/stream``.

Protocol (wire format parsed in http.py): a client *opens* a session with
its first frame, *advances* it one frame at a time — each advance returns
flow(prev -> cur) — and *closes* it.  Per advance the server runs ONE
encoder pass (the current frame's; the previous frame's fmap/context maps
are cached device-side in the session's SLOT of the per-bucket batch
buffers — serving/session.SlotPool) and warm-starts the recurrence from
the previous flow forward-projected along itself
(ops/warmstart.warm_start_seed — RAFT's own Sintel video protocol), so a
``converge:eps`` iteration policy exits in a fraction of the cold count.

**Continuous batching** (ROADMAP item 1, the Ragged-Paged-Attention
recipe from PAPERS.md): advances are keyed per BUCKET in the admission
queue, so concurrent stream steps from *different* sessions coalesce —
up to max_batch / max_wait, exactly like pairwise requests — into ONE
batched stream executable (models/raft.make_stream_batch_step_fn) that
gathers each row's cached maps + warm-start seed from its pool slot,
advances every session in one device call, and scatters the updated
rows back.  Rows join and leave the batch every step as sessions open,
advance and close; padding rows are inactive (scratch slot, converged
from iteration 0, excluded from all metrics).  Session opens and the
cold-restart path stay solo calls (keyed per session): they run the
``encode`` executable, which has no batch-mates to share.

Stream steps ride the SAME admission queue and batcher thread as
``/v1/flow`` (bounded depth -> 429, deadlines -> 504, graceful drain);
the session lock serializes frames within a session (a concurrent
advance on the same session answers 409 rather than reordering the
recurrence) — which is also why a coalesced group can never hold the
same session twice, so the commit scatter's real slot indices are
always unique.

Thread model (SERVING.md "Threading model"): the handler thread holds
``Session.lock`` across the WHOLE advance — including ``queue.submit``
(which takes the queue lock) and the blocking wait — which is why the
declared hierarchy orders ``Session.lock`` OUTSIDE
``RequestQueue._lock``.  The coordinator itself holds no lock: session
state is mutated only in :meth:`execute`/:meth:`execute_group` on the
batcher thread, while the handler's session lock keeps any second frame
of the same session out; slot transitions go through the store
(store lock → pool lock, the declared edge).

Failure containment, per ROW of a batched step: a warm row that faults —
the batched call raising, or that row's output failing the non-finite
sentinel (e.g. a poisoned slot) — is demoted and healed through the SAME
transparent cold-restart path an evicted session takes, in the same
advance; its co-batched neighbors keep their warm results.  This is the
stream path's form of poisoned-row isolation: the pairwise path bisects
because it has no finer fallback, the stream path degrades straight to
per-row cold restarts (finer blame, bounded at two engine calls per
row).  A cold attempt that faults is terminal for that frame only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.pipeline import embed_to_shape, pad_to_shape
from ..ops.warmstart import warm_start_seed
from ..telemetry import events as tlm_events
from ..telemetry import spans as tlm_spans
from .batcher import NonFiniteOutput
from .queue import (DeadlineExceeded, Draining, RejectedError, Request,
                    RequestQueue)
from .session import Session, SessionStore


class UnknownSession(RejectedError):
    """Session id never existed, was closed, or aged out (TTL) — reopen."""
    http_status = 404


class SessionBusy(RejectedError):
    """A frame for this session is already in flight (advances are
    strictly sequential: frame t's flow seeds frame t+1)."""
    http_status = 409


class StreamRequest(Request):
    """One stream step in flight.  ``bucket`` is the queue key —
    advances key per BUCKET (``("stream", H, W)``) so concurrent steps
    from different sessions coalesce into one batched device call, while
    opens key per session (``("stream-open", sid)``): they run the solo
    encode executable and have nothing to coalesce with.  Neither key
    ever collides with a pairwise ``(H, W)`` bucket."""

    __slots__ = ("session", "stream_op", "warm", "frame", "abandoned")

    def __init__(self, session: Session, op: str, image_padded, pads,
                 deadline: float,
                 qbucket: Optional[Tuple[int, int]] = None):
        # qbucket: the (H, W) the advance key coalesces on — the
        # session's routed bucket in dense mode; under --ragged the
        # coordinator passes the shared max box, so advances from
        # DIFFERENT resolutions land in one FIFO and one batched step.
        kb = tuple(session.bucket if qbucket is None else qbucket)
        key = (("stream",) + kb if op == "advance"
               else ("stream-open", session.id))
        super().__init__(image_padded, None, key, pads, deadline,
                         rbucket=tuple(session.bucket))
        self.session = session
        self.stream_op = op              # "open" | "advance"
        self.warm = False                # set at execute time
        self.frame = 0
        # set by the handler when wait() gives up (batcher stalled past
        # the deadline margin): the batcher must then SKIP the step
        # instead of mutating session state after the session lock was
        # released — a late orphaned step would otherwise consume the
        # frame a client retry is about to resubmit
        self.abandoned = False


class StreamCoordinator:
    """Owns the session store + slot pool policy and the stream-step
    device recipe.

    Handler threads call :meth:`open`/:meth:`advance`/:meth:`close`
    (validate, lock the session, enqueue, block); the batcher thread
    calls :meth:`execute` (opens) and :meth:`execute_group` (coalesced
    advances) — the only places device state moves.
    """

    def __init__(self, store: SessionStore, sconfig, queue: RequestQueue,
                 metrics: Dict, count_fn, faults=None, nonfinite=None,
                 breaker=None, tracer=None):
        self.store = store
        self.pool = store.pool
        self.sconfig = sconfig
        self.queue = queue
        self.metrics = metrics           # make_stream_metrics families
        self.count = count_fn            # FlowServer.count_request
        self.faults = faults             # chaos injector (session arm)
        self.nonfinite = nonfinite       # raft_nonfinite_outputs_total
        self.breaker = breaker           # CircuitBreaker or None
        self.tracer = tracer             # telemetry.spans.Tracer or None
        # ragged mixed-resolution mode (SERVING.md "Ragged serving"):
        # every device call runs at the shared max-box arena bucket with
        # per-row live sizes; sessions keep their ROUTED bucket for
        # protocol/routing purposes
        self.ragged = bool(getattr(sconfig, "ragged", False))
        self.dev_box = sconfig.max_box if self.ragged else None

    def _dev(self, s: Session) -> Tuple[int, int]:
        """The bucket device calls run at: the session's routed bucket,
        or the shared max-box arena under --ragged."""
        return s.bucket if self.dev_box is None else self.dev_box

    def _mask_seed(self, seed: np.ndarray,
                   bucket: Tuple[int, int]) -> np.ndarray:
        """Zero a warm-start seed outside the session's live 1/8-scale
        extent: warm_start_seed forward-splats flow along itself, so
        un-masked dead-embedding flow could leak into the live region of
        the NEXT step's init (deterministically, but noise all the
        same)."""
        if self.dev_box is None:
            return seed
        bh, bw = bucket
        seed = np.asarray(seed).copy()
        seed[..., bh // 8:, :, :] = 0.0
        seed[..., :, bw // 8:, :] = 0.0
        return seed

    def _demote_shared(self, reason: str = "degraded") -> None:
        """Ragged twin of ``store.demote_bucket``: a failed commit killed
        the ARENA buffers every resolution shares, so every declared
        bucket's sessions must demote (in-flight included — same
        single-batcher-thread safety argument)."""
        for b in self.sconfig.buckets:
            self.store.demote_bucket(tuple(b), reason)

    # -- handler-thread API ------------------------------------------------

    def open(self, image: np.ndarray, deadline_ms: Optional[float],
             trace_id: Optional[str] = None,
             finish_trace: bool = True) -> Dict:
        from .http import BadRequest    # circular-free: http imports us not
        self.store.sweep()
        h, w = image.shape[0], image.shape[1]
        bucket = self.sconfig.route(h, w)
        if bucket is None:
            raise BadRequest(
                f"no declared bucket fits ({h}, {w}); buckets: "
                f"{[f'{bh}x{bw}' for bh, bw in self.sconfig.buckets]}")
        s = self.store.open(bucket)
        try:
            with s.lock:
                req = self._run_step(s, "open", image, deadline_ms,
                                     trace_id=trace_id,
                                     finish_trace=finish_trace)
        except BaseException:
            # no half-open sessions — but close AFTER releasing s.lock:
            # store.close takes the store lock, which the hierarchy orders
            # OUTSIDE the session lock (the id never reached the client,
            # so nothing can race the record between release and close)
            self.store.close(s.id)
            raise
        self.metrics["opens"].inc()
        res = {"session": s.id, "frame": 0,
               "meta": {"bucket": list(bucket)}, "_trace": req.trace,
               "_finished_at": req.finished_at}
        if req.trace is not None:
            res["meta"]["trace_id"] = req.trace.trace_id
        return res

    def advance(self, sid: Optional[str], image: np.ndarray,
                deadline_ms: Optional[float],
                trace_id: Optional[str] = None,
                finish_trace: bool = True) -> Dict:
        from .http import BadRequest
        self.store.sweep()
        s = self.store.get(sid) if sid else None
        if s is None:
            self.count("unknown_session")
            raise UnknownSession(
                f"unknown session {sid!r} (closed, expired after "
                f"{self.sconfig.session_ttl_s:.0f}s idle, or never "
                f"opened) — open a new one")
        if not s.lock.acquire(blocking=False):
            self.count("session_busy")
            raise SessionBusy(f"session {sid} already has a frame in "
                              f"flight; advances are sequential")
        try:
            h, w = image.shape[0], image.shape[1]
            if self.sconfig.route(h, w) != s.bucket:
                raise BadRequest(
                    f"frame ({h}, {w}) does not route to this session's "
                    f"bucket {s.bucket}; resolution changes mid-stream "
                    f"need a new session")
            req = self._run_step(s, "advance", image, deadline_ms,
                                 trace_id=trace_id,
                                 finish_trace=finish_trace)
        finally:
            s.lock.release()
            # a close() that raced this advance deferred the slot free
            # to us (see SessionStore.close)
            self.store.reclaim_if_closed(s)
        meta = {"bucket": list(s.bucket), "warm": req.warm,
                "batch_real": req.batch_real,
                "batch_padded": req.batch_padded}
        if req.iters_used is not None:
            meta["iters_used"] = req.iters_used
        if req.trace is not None:
            meta["trace_id"] = req.trace.trace_id
        return {"session": s.id, "frame": req.frame, "flow": req.result,
                "meta": meta, "_trace": req.trace,
                "_finished_at": req.finished_at}

    def close(self, sid: Optional[str]) -> Dict:
        s = self.store.close(sid) if sid else None
        if s is None:
            self.count("unknown_session")
            raise UnknownSession(f"unknown session {sid!r}")
        return {"session": sid, "closed": True, "frames": s.frames}

    def _run_step(self, s: Session, op: str, image: np.ndarray,
                  deadline_ms: Optional[float],
                  trace_id: Optional[str] = None,
                  finish_trace: bool = True) -> StreamRequest:
        """Pad, enqueue, block until the batcher resolves — the stream
        twin of FlowServer.infer, same deadline/shed/drain accounting and
        the same trace lifecycle: the trace closes HERE on every failure
        path (status from the exception); on success the HTTP handler
        finishes it after the respond span (``finish_trace=False``), or
        this method does for direct callers."""
        from .http import BadRequest
        tr = (self.tracer.start("stream", trace_id)
              if self.tracer is not None else None)
        t0 = time.monotonic()
        try:
            dl = (self.sconfig.default_deadline_ms if deadline_ms is None
                  else min(deadline_ms, self.sconfig.default_deadline_ms))
            if dl <= 0:
                raise BadRequest(f"deadline_ms must be positive, got {dl}")
            imp, pads = pad_to_shape(image[None].astype(np.float32),
                                     s.bucket)
            if self.dev_box is not None:
                # ragged: zero-embed the routed-bucket frame corner-
                # anchored into the max-box arena and fold the embedding
                # into pads, so unpad() recovers the original resolution
                # straight from the max-box flow
                (bh, bw), (mh, mw) = s.bucket, self.dev_box
                imp = embed_to_shape(imp, self.dev_box)
                t, b_, l_, r_ = pads
                pads = (t, b_ + mh - bh, l_, r_ + mw - bw)
            req = StreamRequest(s, op, imp, pads,
                                deadline=time.monotonic() + dl / 1000.0,
                                qbucket=self.dev_box)
            req.trace = tr
            if tr is not None:
                tr.span("admit", t0, time.monotonic(), op=op,
                        session=s.id)
            try:
                self.queue.submit(req)
            except Draining:
                self.count("draining")
                raise
            except Exception:           # QueueFull: overload shed, HTTP 429
                self.count("shed")
                raise
            try:
                req.wait(timeout=dl / 1000.0 + max(30.0, dl / 1000.0))
            except DeadlineExceeded:
                # the step may still be queued (or mid-execution on a
                # stalled device): mark it so the batcher drops it instead
                # of advancing the session after this thread releases its
                # lock
                req.abandoned = True
                if req.error is None:
                    self.count("timeout")
                raise
        except BaseException as e:
            if tr is not None:
                # stamp-if-absent (see FlowServer.infer): never overwrite
                # another request's id on a shared exception instance
                if getattr(e, "trace_id", None) is None:
                    e.trace_id = tr.trace_id
                tr.finish(tlm_spans.status_of(e))
            raise
        if finish_trace and tr is not None:
            tr.finish()
        return req

    # -- batcher-thread API ------------------------------------------------

    def execute(self, req: StreamRequest, engine):
        """Run one SOLO stream step on the device (session open, or a
        lone advance routed outside the group path).  Returns (padded
        flow or None, iters_used or None); all session/cache mutation
        happens here or in :meth:`execute_group`, on the single thread
        that owns the device."""
        s = req.session
        if req.stream_op == "open":
            fmap, cnet = engine.run_encode(self._dev(s), req.image1)
            self._attach(s, engine, fmap, cnet, flow_lr=None)
            s.last_image = req.image1
            return None, None
        [(flow, iters_used, err)] = self.execute_group([req], engine)
        if err is not None:
            raise err
        return flow, iters_used

    def execute_group(self, group: List[StreamRequest], engine):
        """Advance a coalesced same-bucket group of sessions: ONE batched
        device call for the warm rows (gather slots → step → masked
        commit), solo cold restarts for demoted rows and for warm rows
        that faulted (the per-row degradation ladder — see the module
        docstring).  Returns ``[(padded flow, iters_used, err)]`` aligned
        with ``group``; exactly one of flow/err is set per row.  Session
        host state (frames, last_image) moves only for rows that
        succeeded."""
        if self.faults is not None:
            for r in group:
                self.faults.corrupt_session(r.session, engine)
        results: List[Optional[tuple]] = [None] * len(group)
        warm_idx = [i for i, r in enumerate(group)
                    if r.session.has_features]
        heal_idx: List[int] = []
        if warm_idx:
            rows = self._warm_batch([group[i] for i in warm_idx], engine)
            for i, row in zip(warm_idx, rows):
                if row is None:          # faulted warm row: degrade, heal
                    heal_idx.append(i)
                else:
                    results[i] = row
        cold_idx = [i for i, r in enumerate(group)
                    if not r.session.has_features and i not in heal_idx]
        for i in sorted(cold_idx + heal_idx):
            r = group[i]
            try:
                flow, iters_used = self._cold_advance(r.session, r, engine)
                r.warm = False
                if iters_used is not None:
                    iters_used = int(np.asarray(iters_used).reshape(-1)[0])
                results[i] = (flow, iters_used, None)
            except Exception as e:
                if self.breaker is not None:
                    self.breaker.record(False)
                results[i] = (None, None, e)
        for r, (flow, _iters, err) in zip(group, results):
            if err is None:
                r.session.frames += 1
                r.frame = r.session.frames
                self.metrics["frames"].inc()
        return results

    def _warm_batch(self, reqs: List[StreamRequest], engine):
        """One batched stream step over the warm rows.  Returns a list
        aligned with ``reqs``: ``(padded flow, iters_used, None)`` for
        rows whose output passed the sentinel (their slots are
        committed), or None for rows that must heal cold (their slots
        are dropped; nothing poisoned is ever cached)."""
        s0 = reqs[0].session
        bucket = self._dev(s0)
        n = len(reqs)
        padded = self.sconfig.pad_batch_to(min(n, self.sconfig.max_batch))
        images = np.concatenate([r.image1 for r in reqs]
                                + [reqs[-1].image1] * (padded - n))
        slots = np.asarray([r.session.slot for r in reqs]
                           + [self.pool.scratch] * (padded - n), np.int32)
        active = np.asarray([True] * n + [False] * (padded - n), bool)
        sizes = None
        if self.dev_box is not None:
            # per-row live extents: each session's ROUTED bucket (filler
            # rows repeat the last, matching their repeated pixels)
            sizes = np.asarray([r.session.bucket for r in reqs]
                               + [reqs[-1].session.bucket] * (padded - n),
                               np.int32)
        try:
            flow, flow_lr, fmap_rows, cnet_rows, iters_used = \
                engine.run_stream_batch(bucket, images, slots, active,
                                        sizes=sizes)
        except Exception:
            # the batched call itself faulted: every row degrades to the
            # cold-restart path (the solo semantics, batched — no retry:
            # a warm step has a finer fallback than re-running the whole
            # group, and the cold heal isolates the guilty row).  The
            # failed call still counts against the breaker: it measures
            # engine-call health, and a 100%-warm-failure mode must stay
            # visible even though every advance heals.
            if self.breaker is not None:
                self.breaker.record(False)
            for r in reqs:
                self._degrade(r)
            return [None] * n
        if self.breaker is not None:
            self.breaker.record(True)
        h, w = bucket
        row_ok = np.array([np.isfinite(flow[i]).all()
                           and np.isfinite(flow_lr[i]).all()
                           for i in range(n)], bool)
        # commit BEFORE touching host state, AFTER the sentinel: finite
        # rows scatter their updated maps + next-frame warm-start seed
        # into their slots; rejected and padding rows write their old
        # values back (mask), so a poisoned output can never be cached
        seeds = np.zeros((padded, h // 8, w // 8, 2), np.float32)
        for i in np.flatnonzero(row_ok):
            seeds[i] = self._mask_seed(
                warm_start_seed(flow_lr[i:i + 1], (h // 8, w // 8))[0],
                reqs[i].session.bucket)
        mask = active.copy()
        mask[:n] &= row_ok
        try:
            engine.commit_stream(bucket, slots, fmap_rows, cnet_rows,
                                 seeds, mask)
        except Exception:
            # a failed commit leaves the (donated) bucket buffers dead;
            # commit_stream already rebuilt them zeroed — now demote
            # EVERY session of the bucket, in-flight/queued ones
            # included (demote_bucket overrides the skip-the-locked
            # convention precisely because a kept slot would gather the
            # zeros and serve finite garbage), then heal this group cold.
            # Under --ragged every resolution shares the arena buffers,
            # so EVERY declared bucket demotes.
            if self.dev_box is not None:
                self._demote_shared()
            else:
                self.store.demote_bucket(bucket)
            for r in reqs:
                self._degrade(r)
            return [None] * n
        out = []
        for i, r in enumerate(reqs):
            if not row_ok[i]:
                if self.nonfinite is not None:
                    self.nonfinite.inc()
                log = tlm_events.current()
                if log is not None:
                    log.event("nonfinite_output", session=r.session.id,
                              warm=True,
                              trace_id=(r.trace.trace_id
                                        if r.trace is not None else None))
                self._degrade(r)
                out.append(None)
                continue
            r.session.last_image = r.image1
            r.warm = True
            self.metrics["fnet_hits"].inc()
            out.append((flow[i:i + 1],
                        None if iters_used is None else int(iters_used[i]),
                        None))
        return out

    def _degrade(self, req: StreamRequest) -> None:
        """Drop one faulted warm row's slot so its heal (and every later
        advance until re-promotion) runs the transparent cold-restart
        path; the client still gets a 200, the trace says what it cost."""
        self.store.demote(req.session, "degraded")
        self.metrics["degraded"].inc()
        if req.trace is not None:
            # degraded outranks ok and is always recorder-retained
            req.trace.set_status(tlm_spans.DEGRADED)

    def _cold_advance(self, s: Session, req: StreamRequest, engine):
        """Cold two-encoder restart from the retained previous frame —
        pairwise cost, correct flow.  Session state (slot, last_image) is
        mutated only AFTER the output passes the non-finite sentinel, so
        a faulted attempt leaves the session exactly where it was."""
        ab = self._dev(s)
        H, W = ab
        fmap_p, cnet_p = engine.run_encode(ab, s.last_image)
        init = np.zeros((1, H // 8, W // 8, 2), np.float32)
        self.metrics["fnet_misses"].inc()
        sizes = (np.asarray([s.bucket], np.int32)
                 if self.dev_box is not None else None)
        flow, flow_lr, fmap_c, cnet_c, iters_used = engine.run_stream(
            ab, req.image1, fmap_p, cnet_p, init, sizes=sizes)
        if not (np.isfinite(flow).all() and np.isfinite(flow_lr).all()):
            # non-finite OUTPUT sentinel (inputs were validated at the
            # HTTP edge): never cache poisoned maps or a poisoned seed
            if self.nonfinite is not None:
                self.nonfinite.inc()
            log = tlm_events.current()
            if log is not None:
                log.event("nonfinite_output", session=s.id, warm=False,
                          trace_id=(req.trace.trace_id
                                    if req.trace is not None else None))
            raise NonFiniteOutput(
                f"non-finite stream output for session {s.id} on a "
                f"cold step")
        self._attach(s, engine, fmap_c, cnet_c, flow_lr)
        s.last_image = req.image1
        return flow, iters_used

    def _attach(self, s: Session, engine, fmap, cnet, flow_lr) -> None:
        """Install fresh maps + the next advance's warm-start seed into
        the session's slot (promoting it — LRU demotion happens inside
        the store if the pool is at capacity).  ``promote`` returning
        None (every slot pinned by an in-flight session) leaves the
        session cold: correct, just the pairwise cost next frame.  A
        FAILED commit must not fail the advance either — the flow is
        already computed and correct — but its donated buffers are dead
        (rebuilt zeroed by the engine), so the whole bucket demotes
        before anything can gather the zeros."""
        slot = self.store.promote(s)
        if slot is None:
            return
        ab = self._dev(s)
        H, W = ab
        seed = self._mask_seed(warm_start_seed(flow_lr, (H // 8, W // 8)),
                               s.bucket)
        try:
            engine.commit_row(ab, slot, fmap, cnet, seed)
            self.pool.set_extent(s.bucket, slot, s.bucket)
        except Exception:
            if self.dev_box is not None:
                self._demote_shared()
            else:
                self.store.demote_bucket(s.bucket)
