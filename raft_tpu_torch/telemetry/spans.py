"""Request-scoped spans: ID-carrying traces for the serving plane.

:mod:`trace` names *stages* (``raft/fnet``, ``serve/batch`` …) so device
profiles are readable; this module extends that to **per-request
attribution**: every request through the serving stack carries a
``trace_id`` (minted server-side or accepted from an ``X-Raft-Trace-Id``
header) and accumulates timed **spans** — ``admit``, ``queue_wait``,
``batch_form``, ``pad``, ``execute`` (with ``execute_dispatch`` /
``execute_block`` children: async dispatch means wall-clock at the call
site lies about device time), ``respond`` — each with parent links and a
status (``ok`` / ``poisoned`` / ``shed`` / ``degraded`` / ``timeout`` /
``error``).  Co-batched requests share ONE ``execute`` span id (the join
key) with their own queue spans, so a slow p99 is attributable: queue
wait vs batch formation vs device vs response, per request.

Three consumers sit on top:

* **FlightRecorder** — a bounded ring of the last N completed traces plus
  a separate bounded ring of root-cause-evidence traces
  (error/poisoned/timeout/degraded), dumped to a ``.jsonl`` on
  batcher crash / breaker open / watchdog fire / SIGTERM and on demand
  via ``GET /debug/traces`` — every incident leaves a self-contained
  artifact (``tools/tlm.py trace`` renders the waterfall).
* **SLOTracker** — per-class (pair/stream) latency objectives; completed
  traces feed ``raft_slo_burn_rate{class=}`` and
  ``raft_slo_violations_total{class=}`` — the autoscaling/routing signals
  ROADMAP item 3 wants.
* the active run log — sampled-in (and all error) traces append
  ``{"event": "trace", ...}`` records to ``events.jsonl``.

Cost discipline: ``Tracer(sample=0)`` returns ``None`` from
:func:`Tracer.start` and every instrumentation site is a single
``is not None`` check — tracing sampled out costs nothing measurable and
``/metrics`` gains no families.  With ``0 < sample < 1`` every request
still records spans (cheap host-side appends — the response's
``meta.timings`` stays available) but only the sampled fraction is
*retained* (recorder + run log); error-status traces are always retained.

No jax anywhere: pure stdlib, importable by ``tools/tlm.py``.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import events as _events

# The trace-status taxonomy (SERVING.md): terminal disposition of one
# request.  ``degraded`` is a SUCCESS whose warm path faulted (the stream
# cold-restart heal) — retained by the recorder like an error, answered
# like an ok.  ``bad_request`` is the CLIENT's mistake (400): it neither
# burns the replica's SLO budget nor crowds the error-trace ring — a junk
# storm must not evict the genuine engine-failure evidence or page the
# autoscaler about a healthy replica.
OK = "ok"
SHED = "shed"            # 429 queue full / 503 breaker open / 503 draining
TIMEOUT = "timeout"      # 504 deadline exceeded
POISONED = "poisoned"    # bisected-guilty or non-finite-output request
DEGRADED = "degraded"    # stream warm step faulted, healed via cold restart
BAD_REQUEST = "bad_request"   # client-side 400 after the trace was minted
ERROR = "error"          # engine/batcher failure

_TRACE_ID_RE = re.compile(r"^[0-9a-fA-F-]{1,64}$")


def new_trace_id() -> str:
    # 128 random bits as 32 hex digits, the width of uuid4().hex, for a
    # fifth of its cost
    return os.urandom(16).hex()


# Span ids: 16 hex digits, a per-process random half and a counter half
# (itertools.count is atomic under the interpreter lock).  Unique within a
# process and, by the random half, across the processes of a fleet whose
# traces a router joins; minting one costs no system call (a pairwise
# request mints ten or more on the serving threads).
_SPAN_PREFIX = os.urandom(4).hex()
_span_counter = itertools.count(1)


def new_span_id() -> str:
    return f"{_SPAN_PREFIX}{next(_span_counter) & 0xFFFFFFFF:08x}"


def _ms(seconds: float) -> float:
    """Seconds -> milliseconds to 3 decimals (what ``round(x * 1000, 3)``
    gives, at a fifth of its cost; a trace renders 15-20 of them)."""
    return int(seconds * 1e6 + (0.5 if seconds >= 0 else -0.5)) / 1000.0


def clean_trace_id(tid: Optional[str]) -> str:
    """Accept a client-supplied trace id (hex/dash, bounded) or mint one —
    never let arbitrary header bytes into logs and metrics labels."""
    if tid and _TRACE_ID_RE.match(tid):
        return tid.lower()
    return new_trace_id()


def status_of(exc: BaseException) -> str:
    """Exception -> trace status.  The serving exception classes carry a
    ``trace_status`` class attribute (queue.RejectedError = shed,
    DeadlineExceeded = timeout, PoisonedRequest/NonFiniteOutput =
    poisoned, ...); anything unannotated is an ``error``."""
    return getattr(exc, "trace_status", ERROR)


# -- thread-local plumbing --------------------------------------------------
#
# Two ambient channels keep the engine and the diagnostics decoupled from
# the span objects themselves:
#
# * the DEVICE SLOT: the batcher opens a list before an engine call; the
#   engine appends (kind, t0, t_dispatched, t_blocked) per device call —
#   dispatch and block-until-ready separated at the only place that can
#   tell them apart — and the batcher turns them into child spans.
# * the CURRENT TRACE IDS: the trace ids of the batch being executed, so
#   out-of-band diagnostics (fault_injected, lock_violation, non-finite
#   sentinel run-log events) are joinable to their request traces.

_tls = threading.local()


def set_device_slot(slot: Optional[list]) -> None:
    _tls.device_slot = slot


def take_device_slot() -> Optional[list]:
    slot = getattr(_tls, "device_slot", None)
    _tls.device_slot = None
    return slot


def record_device_call(kind: str, t0: float, t_dispatched: float,
                       t_blocked: float) -> None:
    """Engine-side hook: one device call's dispatch/block timing.  A
    single thread-local read when tracing is off."""
    slot = getattr(_tls, "device_slot", None)
    if slot is not None:
        slot.append((kind, t0, t_dispatched, t_blocked))


def set_current_trace_ids(ids: Tuple[str, ...]) -> None:
    _tls.trace_ids = tuple(ids)


def current_trace_ids() -> Tuple[str, ...]:
    return getattr(_tls, "trace_ids", ())


# -- the trace itself -------------------------------------------------------

class RequestTrace:
    """One request's span accumulator.  Handler threads and the batcher
    thread both write (guarded by a private lock); after :meth:`finish`
    every further ``span()``/``set_status`` is a no-op, so a late batcher
    (e.g. after the handler's wait timed out) cannot resurrect a closed
    trace."""

    __slots__ = ("tracer", "trace_id", "kind", "sampled", "t0",
                 "status", "_spans", "_lock", "_closed")

    def __init__(self, tracer: "Tracer", trace_id: str, kind: str,
                 sampled: bool):
        self.tracer = tracer
        self.trace_id = trace_id
        self.kind = kind                 # request class: "pair" | "stream"
        self.sampled = sampled
        self.t0 = time.monotonic()
        self.status: Optional[str] = None
        self._spans: List[tuple] = []
        self._lock = threading.Lock()
        self._closed = False

    def span(self, name: str, t0: float, t1: float, status: str = OK,
             parent: Optional[str] = None, span_id: Optional[str] = None,
             **attrs) -> Optional[str]:
        """Record one completed span (monotonic endpoints).  Returns its
        span id (pass a shared ``span_id`` to join co-batched traces on
        one device span), or None if the trace already closed.  The
        record stays a tuple until :meth:`finish` renders it, so the
        serving threads pay one append per span."""
        sid = span_id or new_span_id()
        with self._lock:
            if self._closed:
                return None
            self._spans.append((name, sid, parent, t0, t1, status, attrs))
        return sid

    def set_status(self, status: str) -> None:
        """Escalate-only: a non-ok status sticks (a degraded advance that
        later succeeds stays degraded)."""
        with self._lock:
            if not self._closed and self.status in (None, OK):
                self.status = status

    def timings_ms(self) -> Dict[str, float]:
        """{span name: total ms} — the response's ``meta.timings`` view
        (same-name spans sum, e.g. bisection re-pads)."""
        out: Dict[str, float] = {}
        with self._lock:
            spans = list(self._spans)
        for name, _sid, _parent, t0, t1, _status, _attrs in spans:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return {k: _ms(v) for k, v in out.items()}

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def finish(self, status: Optional[str] = None) -> Optional[dict]:
        """Close the trace (idempotent — the first caller wins) and hand
        it to the tracer: SLO accounting, flight recorder, run log."""
        return self.tracer._finish(self, status)


class Tracer:
    """Mints and finalizes request traces for one server.

    ``sample`` is the RETENTION fraction: systematic (exact-rate,
    deterministic) sampling decides which completed ok-traces reach the
    recorder/run log; error traces always do.  ``sample == 0`` disables
    tracing outright: :meth:`start` returns None.  ``open_traces`` counts
    started-but-unfinished traces — the span-leak observable the tests
    assert back to zero."""

    def __init__(self, sample: float = 1.0, recorder=None, slo=None):
        self.sample = float(sample)
        self.recorder = recorder          # FlightRecorder or None
        self.slo = slo                    # SLOTracker or None
        self._lock = threading.Lock()
        self._acc = 0.0                   # systematic-sampling accumulator
        self._open = 0
        self.finished = 0

    @property
    def open_traces(self) -> int:
        with self._lock:
            return self._open

    def start(self, kind: str,
              trace_id: Optional[str] = None) -> Optional[RequestTrace]:
        s = self.sample
        if s <= 0.0:
            return None
        with self._lock:
            self._open += 1
            if s >= 1.0:
                sampled = True
            else:
                self._acc += s
                sampled = self._acc >= 1.0 - 1e-9
                if sampled:
                    self._acc -= 1.0
        return RequestTrace(self, clean_trace_id(trace_id), kind, sampled)

    def _finish(self, trace: RequestTrace,
                status: Optional[str] = None) -> Optional[dict]:
        with trace._lock:
            if trace._closed:
                return None
            trace._closed = True
            final = status or trace.status or OK
            spans = list(trace._spans)
        end = time.monotonic()
        root_id = new_span_id()
        t_base = trace.t0
        recs = [{"name": "request", "span": root_id, "parent": None,
                 "start_ms": 0.0,
                 "dur_ms": _ms(end - t_base),
                 "status": final}]
        for name, sid, parent, t0, t1, status, attrs in spans:
            rec = {"name": name, "span": sid, "parent": parent or root_id,
                   "start_ms": _ms(t0 - t_base),
                   "dur_ms": _ms(t1 - t0),
                   "status": status}
            if attrs:
                rec.update(attrs)
            recs.append(rec)
        spans = recs
        rec = {"event": "trace", "t": round(time.time(), 3),
               "trace_id": trace.trace_id, "kind": trace.kind,
               "status": final, "dur_ms": spans[0]["dur_ms"],
               "sampled": trace.sampled, "spans": spans}
        with self._lock:
            self._open -= 1
            self.finished += 1
        if self.slo is not None:
            self.slo.observe(trace.kind, final, end - trace.t0)
        if trace.sampled or final not in (OK, BAD_REQUEST):
            if self.recorder is not None:
                self.recorder.add(rec)
            log = _events.current()
            if log is not None:
                log.event("trace", **{k: v for k, v in rec.items()
                                      if k not in ("event", "t")})
        return rec


# -- flight recorder --------------------------------------------------------

class FlightRecorder:
    """Bounded in-memory ring of completed traces + a separate bounded
    ring of root-cause-evidence traces (error/poisoned/timeout/degraded —
    a shed or traffic storm cannot evict the traces that explain it),
    with one-call dumps.  ``dump()`` rewrites ``path`` wholesale — the
    rings are the bound, the file is a snapshot — so repeated triggers
    (crash, breaker flaps) converge on the freshest view."""

    def __init__(self, capacity: int = 64, path=None):
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._errors: deque = deque(maxlen=max(1, capacity))
        self.path = Path(path) if path else None
        self._lock = threading.Lock()
        # dumps fire from different threads (supervisor on the dying
        # batcher, breaker on its recording thread, SIGTERM on the main
        # thread) — a separate lock serializes the file write without
        # making add() wait on I/O
        self._dump_lock = threading.Lock()
        self.dumps = 0

    # statuses whose traces are ROOT-CAUSE evidence and get the protected
    # error ring.  Sheds deliberately stay in the recency ring: a breaker
    # open emits one shed trace per rejected request, and a minute of
    # shedding must not evict the handful of error/poisoned traces that
    # explain WHY the breaker opened.
    EVIDENCE_STATUSES = (ERROR, POISONED, TIMEOUT, DEGRADED)

    def add(self, rec: dict) -> None:
        with self._lock:
            (self._errors if rec.get("status") in self.EVIDENCE_STATUSES
             else self._ring).append(rec)

    def snapshot(self) -> List[dict]:
        """Errors + recent ok traces, oldest first."""
        with self._lock:
            recs = list(self._errors) + list(self._ring)
        return sorted(recs, key=lambda r: r.get("t", 0.0))

    def counts(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._ring), len(self._errors)

    def dump(self, reason: str, path=None) -> Optional[str]:
        """Write the current rings as JSONL (header record first); returns
        the path written, or None when no path is configured."""
        dest = Path(path) if path else self.path
        if dest is None:
            return None
        with self._dump_lock:
            recs = self.snapshot()
            with self._lock:
                self.dumps += 1
            dest.parent.mkdir(parents=True, exist_ok=True)
            with open(dest, "w") as f:
                f.write(json.dumps({"event": "flightrec_dump",
                                    "t": round(time.time(), 3),
                                    "reason": reason,
                                    "traces": len(recs)}) + "\n")
                for rec in recs:
                    f.write(json.dumps(rec, default=str) + "\n")
        return str(dest)


# -- SLO accounting ---------------------------------------------------------

class SLOTracker:
    """Per-class latency objectives over a sliding count window.

    A completed request *burns budget* when it misses its class objective
    or terminates non-ok (shed/timeout/poisoned/error all count — from the
    client's seat they are failures; ``degraded`` answers count by their
    latency alone).  ``burn_rate(cls)`` = violating fraction of the window
    / allowed budget fraction: 1.0 = burning exactly the budget, >> 1 =
    the replica cannot meet its objective — the autoscaling signal."""

    def __init__(self, objectives: Dict[str, float], budget: float = 0.01,
                 window: int = 256):
        self.objectives = {k: float(v) for k, v in objectives.items()
                           if v and v > 0}
        self.budget = float(budget)
        self.window = int(window)
        self._lock = threading.Lock()
        self._win = {k: deque(maxlen=self.window) for k in self.objectives}
        self.violations = None    # labeled counter, wired by make_slo_metrics

    def observe(self, cls: str, status: str, dur_s: float) -> None:
        win = self._win.get(cls)
        if win is None or status == BAD_REQUEST:
            # a client's malformed request says nothing about whether
            # THIS replica can meet its objective — no budget burned
            return
        bad = (status not in (OK, DEGRADED)
               or dur_s > self.objectives[cls])
        with self._lock:
            win.append(bad)
        if bad and self.violations is not None:
            self.violations.labels(cls).inc()

    def burn_rate(self, cls: str) -> float:
        with self._lock:
            win = self._win.get(cls)
            if not win:
                return 0.0
            frac = sum(1 for b in win if b) / len(win)
        return frac / self.budget if self.budget else 0.0
