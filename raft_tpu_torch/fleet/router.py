"""Admission router: one front door over N FlowServer replicas.

The port's copy of the JAX package's ``fleet/router.py``: the same
endpoints, routing rules and wire formats, and one endpoint more, ``POST
/admin/scale?replicas=N`` (``ReplicaManager.scale_to`` over HTTP, which
the JAX package offers in Python only).  It forwards over one kept-alive
HTTP/1.1 connection per replica per handler thread
(:meth:`FleetRouter._conn`): a connection per request was seen to leave
a connect unanswered for 60 s on the card's machine.

The router exposes the UNCHANGED single-replica API — ``POST /v1/flow``,
``POST /v1/stream``, ``GET /healthz``, ``GET /metrics``, ``GET
/debug/traces`` — plus ``POST /admin/reload`` (fleet-wide rolling weight
hot-swap, controller.py), ``GET /metrics/fleet`` (every replica's last
scrape re-labeled ``replica="<idx>"`` + summed ``replica="all"``
rollups), and ``GET /debug/history`` (per-replica derived time-series
from the router's :class:`~raft_tpu_torch.telemetry.timeseries.ScrapeHistory`
over the health-poll scrapes, ``?window=`` seconds; includes the
currently skew-drained replica list).  Clients cannot tell a fleet from
a replica except by reading ``meta.replica``.

Routing rules (SERVING.md "Fleet"):

* ``/v1/flow`` — least-loaded: the replica with the fewest router-side
  in-flight forwards (tie-broken by scraped queue fill).  Pure pairwise
  inference is idempotent, so a forward that dies at the connection
  level is replayed on another replica (``raft_fleet_retries_total``).
* ``/v1/stream`` — session affinity: the router mints ITS OWN session
  ids and maps each to ``(replica, backend session id, prev frame)``.
  Advances forward to the pinned replica; the previous frame is retained
  host-side after every forward.  When the pinned replica is dead (or
  lost the session), the router MIGRATES: ``open(prev frame)`` on a
  healthy replica, re-pin, then forward the advance.  The replica's
  first advance after an open runs the zero-init cold path, so a
  migrated frame's flow is the pairwise flow of the same two frames
  (stream.py ``_cold_advance``; in the port another graph computes it, so
  equal up to float rounding, which random weights amplify over many
  iterations), and the client only sees ``meta.migrated: true``.

Router-side request traces (``route`` / ``forward`` / ``retry`` /
``migrate`` spans, each carrying the replica index) propagate
``X-Raft-Trace-Id`` to the replica, so ``tlm trace`` can join the
router's view with the replica's request trace into one waterfall.

Thread model: handler threads race on the session map
(``FleetSessionMap._lock``), per-session state (``FleetSession.lock`` —
held across a whole advance, the same exclusivity contract as the
replica's ``Session.lock``), the replica table (``ReplicaManager._lock``)
and the in-flight counters (``FleetRouter._lock``), declared in exactly
that order in SERVING_LOCK_HIERARCHY.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.client import HTTPConnection
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..lint.concurrency import guarded_by
from ..serving.http import (BadRequest, _Handler, parse_stream_request,
                            serve_in_thread)
from ..serving.metrics import Registry
from ..telemetry import spans as tlm_spans
from ..telemetry.anomaly import LATENCY, replica_skew
from ..telemetry.log import get_logger
from ..telemetry.timeseries import ScrapeHistory
from ..telemetry.watchdogs import watched_lock
from .config import FleetConfig
from .manager import ReplicaManager
from .metrics import make_fleet_metrics

_log = get_logger("fleet")

FORWARD_TIMEOUT_S = 300.0     # safety net; replica deadlines fire first


class NoReplica(Exception):
    """No routable replica — the fleet twin of Draining (HTTP 503)."""


class ForwardError(Exception):
    """Connection-level forward failure (replica dead or dying)."""


def status_class(status: int) -> str:
    """HTTP status -> the raft_fleet_requests_total / trace status
    taxonomy (matches the replica's own request statuses)."""
    if status == 200:
        return "ok"
    if status in (429, 503):
        return "shed"
    if status == 504:
        return "timeout"
    if 400 <= status < 500:
        return "bad_request"
    return "error"


def _trace_status(status: int) -> str:
    cls = status_class(status)
    return tlm_spans.OK if cls == "ok" else cls


class FleetSession:
    """Router-side record of one streaming session: the affinity pin
    (replica + backend session id) and the migration seed (host copy of
    the previous frame).  ``lock`` is held across a whole advance — one
    frame in flight per session, the replica's own contract."""

    def __init__(self, rsid: str, replica_idx: int, backend_sid: str,
                 prev_frame: np.ndarray):
        self.rsid = rsid
        self.replica_idx = replica_idx
        self.backend_sid = backend_sid
        self.prev_frame = prev_frame
        self.frame = 0
        self.migrations = 0
        self.last_used = time.monotonic()
        self.lock = watched_lock("FleetSession.lock", budget_s=None)


class FleetSessionMap:
    """rsid -> FleetSession.  The router mints its own ids so a session
    survives its replica: the backend id changes on migration, the
    router id never does."""

    _sessions = guarded_by("_lock")

    def __init__(self):
        self._lock = watched_lock("FleetSessionMap._lock")
        self._sessions: Dict[str, FleetSession] = {}

    def create(self, replica_idx: int, backend_sid: str,
               prev_frame: np.ndarray) -> FleetSession:
        rsid = os.urandom(8).hex()
        s = FleetSession(rsid, replica_idx, backend_sid, prev_frame)
        with self._lock:
            self._sessions[rsid] = s
        return s

    def get(self, rsid: str) -> Optional[FleetSession]:
        with self._lock:
            s = self._sessions.get(rsid)
        if s is not None:
            s.last_used = time.monotonic()
        return s

    def remove(self, rsid: str) -> Optional[FleetSession]:
        with self._lock:
            return self._sessions.pop(rsid, None)

    def count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def on_replica(self, replica_idx: int) -> List[FleetSession]:
        with self._lock:
            return [s for s in self._sessions.values()
                    if s.replica_idx == replica_idx]

    def reap(self, ttl_s: float) -> int:
        """Drop sessions idle past ``ttl_s`` (the replicas TTL-reap their
        side independently; this bounds the router's map)."""
        cutoff = time.monotonic() - ttl_s
        with self._lock:
            dead = [k for k, s in self._sessions.items()
                    if s.last_used < cutoff]
            for k in dead:
                del self._sessions[k]
        return len(dead)


def _stream_npz(op: str, session: Optional[str] = None,
                image: Optional[np.ndarray] = None,
                deadline_ms: Optional[float] = None) -> bytes:
    """Canonical replica-facing stream body: the router always talks npz
    to replicas regardless of the client's encoding (binary, no float
    round-trip through JSON)."""
    buf = io.BytesIO()
    arrays = {"op": np.asarray(op)}
    if session is not None:
        arrays["session"] = np.asarray(session)
    if image is not None:
        arrays["image"] = np.asarray(image, np.float32)
    if deadline_ms is not None:
        arrays["deadline_ms"] = np.asarray(deadline_ms, np.float64)
    np.savez(buf, **arrays)
    return buf.getvalue()


def _parse_stream_npz(body: bytes) -> dict:
    out = {}
    with np.load(io.BytesIO(body)) as z:
        for name in z.files:
            out[name] = z[name]
    return out


class FleetRouter:
    """The fleet's front door (stdlib http.server, the serving-plane
    idiom).  Owns the session map, the per-replica in-flight counters,
    the ``raft_fleet_*`` registry, and the router-side tracer."""

    _inflight = guarded_by("_lock")
    _skewed = guarded_by("_lock")

    def __init__(self, config: FleetConfig, manager: ReplicaManager,
                 out_dir: Optional[str] = None, run_log=None,
                 verbose: bool = False):
        self.config = config
        self.manager = manager
        self.run_log = run_log
        self.verbose = verbose
        self._lock = watched_lock("FleetRouter._lock")
        self._inflight: Dict[int, int] = {}
        self._skewed: Set[int] = set()    # latency outliers, soft-drained
        self.sessions = FleetSessionMap()
        self.registry = Registry()
        self.metrics = make_fleet_metrics(
            self.registry, manager=manager,
            sessions_fn=self.sessions.count,
            inflight_fn=self.total_inflight,
            skew_fn=self.skew_count)
        self.fleet_history = ScrapeHistory(window=config.history_window)
        self.flightrec = None
        if config.trace_sample > 0:
            path = (os.path.join(out_dir, "flightrec.jsonl")
                    if out_dir else None)
            self.flightrec = tlm_spans.FlightRecorder(path=path)
        self.tracer = tlm_spans.Tracer(sample=config.trace_sample,
                                       recorder=self.flightrec)
        self.updater = None               # RollingUpdater (controller.py)
        self._local = threading.local()   # per-thread replica connections
        self._httpd = None
        self._http_thread = None
        self._draining = threading.Event()
        manager.on_death(self._replica_died)
        manager.on_poll(self._replica_polled)

    # -- plumbing ----------------------------------------------------------

    def count_request(self, status: str) -> None:
        self.metrics["requests"].labels(status).inc()

    def total_inflight(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def skew_count(self) -> int:
        with self._lock:
            return len(self._skewed)

    def skewed(self) -> List[int]:
        """Replica indexes currently judged latency-skewed (sorted)."""
        with self._lock:
            return sorted(self._skewed)

    def _replica_polled(self, rep) -> None:
        """Manager poll callback (poll thread): ingest the fresh
        ``/metrics`` scrape into the per-replica history ring, then
        re-judge latency skew across the fleet — the one fetch the
        manager already made feeds the load view, the autoscaler AND
        the router's time-series."""
        if not rep.prom:
            return
        self.fleet_history.ingest(str(rep.idx), rep.prom)
        self._check_skew()

    def _check_skew(self) -> None:
        """Cross-replica p95 comparison (telemetry.anomaly.replica_skew):
        one replica running hot while its siblings are fine is a replica
        problem, not a load problem, so :meth:`_pick` steers NEW pairwise
        work away (soft-drain, the rolling updater's ``updating`` idiom
        — pinned sessions and in-flight forwards finish normally) until
        its windowed p95 rejoins the fleet."""
        cfg = self.config
        p95s = {src: self.fleet_history.percentile(
                    src, LATENCY, 0.95, window_s=cfg.skew_window_s)
                for src in self.fleet_history.sources()}
        outliers = {int(s) for s in replica_skew(
            p95s, factor=cfg.skew_factor, floor_s=cfg.skew_floor_s)}
        with self._lock:
            rising = outliers - self._skewed
            falling = self._skewed - outliers
            self._skewed = outliers
        for idx in sorted(rising):
            p95 = p95s.get(str(idx))
            _log.warning(f"replica {idx} latency-skewed "
                         f"(p95 {p95 * 1e3:.1f}ms vs fleet): steering "
                         f"new picks away")
            if self.run_log is not None:
                self.run_log.event("fleet_replica_skew", replica=idx,
                                   edge="fire",
                                   p95_ms=round(p95 * 1e3, 3))
        for idx in sorted(falling):
            _log.info(f"replica {idx} latency skew cleared")
            if self.run_log is not None:
                self.run_log.event("fleet_replica_skew", replica=idx,
                                   edge="clear")

    def _replica_died(self, rep) -> None:
        """Manager death callback (poll thread): nothing to do eagerly —
        migration is lazy, on each pinned session's next advance — but
        the pinned count is worth a line and an event.  The dead
        replica's scrape history is dropped (its successor restarts the
        counters) and any skew verdict on it is moot."""
        self.fleet_history.forget(str(rep.idx))
        with self._lock:
            self._skewed.discard(rep.idx)
        pinned = len(self.sessions.on_replica(rep.idx))
        if pinned:
            _log.warning(f"replica {rep.idx} died with {pinned} pinned "
                         f"session(s); they migrate on their next advance")
        if self.run_log is not None:
            self.run_log.event("fleet_sessions_orphaned",
                               replica=rep.idx, sessions=pinned)

    def _pick(self, exclude=()) -> "object":
        """Least-loaded routable replica (fewest router-side in-flight
        forwards, then scraped queue fill); reserves an in-flight slot —
        callers MUST pair with :meth:`_unpick`.  Latency-skewed replicas
        (:meth:`_check_skew`) are steered around SOFTLY: preferred out
        when healthy siblings exist, still picked when they are all
        that's left — skew is a preference, drain is not an outage."""
        cands = [r for r in self.manager.routable() if r.idx not in exclude]
        if not cands:
            # every replica is updating/draining: route to any live one
            # rather than shed (the hot-swap path never pauses serving)
            cands = [r for r in self.manager.replicas()
                     if r.routable and r.idx not in exclude]
        if not cands:
            raise NoReplica("no routable replica")
        with self._lock:
            unskewed = [r for r in cands if r.idx not in self._skewed]
            if unskewed:
                cands = unskewed
            rep = min(cands, key=lambda r: (self._inflight.get(r.idx, 0),
                                            r.queue_fill(), r.idx))
            self._inflight[rep.idx] = self._inflight.get(rep.idx, 0) + 1
        return rep

    def _unpick(self, idx: int) -> None:
        with self._lock:
            self._inflight[idx] = max(0, self._inflight.get(idx, 0) - 1)

    # -- the forwarding client ---------------------------------------------

    def _conn(self, rep, fresh: bool = False) -> HTTPConnection:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        cached = conns.get(rep.idx)
        if not fresh and cached is not None and cached[0] == rep.url:
            return cached[1]
        if cached is not None:
            try:
                cached[1].close()
            except Exception:
                pass
        u = urlsplit(rep.url)
        conn = HTTPConnection(u.hostname, u.port, timeout=FORWARD_TIMEOUT_S)
        conns[rep.idx] = (rep.url, conn)
        return conn

    def _drop_conn(self, rep) -> None:
        conns = getattr(self._local, "conns", None)
        cached = conns.pop(rep.idx, None) if conns else None
        if cached is not None:
            try:
                cached[1].close()
            except Exception:
                pass

    def _http(self, rep, method: str, path: str, body: Optional[bytes],
              headers: Dict[str, str]) -> Tuple[int, dict, bytes]:
        """One replica round-trip over a kept-alive per-thread connection.
        A stale keep-alive fails at send/first-read — before the replica
        processed anything — so ONE silent fresh-connection replay is
        safe even for non-idempotent bodies; a fresh connection failing
        means the replica is gone (ForwardError, caller's policy)."""
        for fresh in (False, True):
            conn = self._conn(rep, fresh=fresh)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.getheaders()), data
            except Exception as e:
                self._drop_conn(rep)
                if fresh:
                    raise ForwardError(f"replica {rep.idx} unreachable: "
                                       f"{e}") from e
        raise AssertionError("unreachable")

    def _forward(self, rep, path: str, body: bytes,
                 headers: Dict[str, str]) -> Tuple[int, dict, bytes]:
        """Reserved-slot forward with latency + per-replica accounting.
        The caller already holds the reservation from :meth:`_pick` (or
        takes one here for affinity forwards)."""
        t0 = time.monotonic()
        try:
            st, rh, rb = self._http(rep, "POST", path, body, headers)
        finally:
            self.metrics["forward_latency"].observe(time.monotonic() - t0)
        self.metrics["forwards"].labels(str(rep.idx)).inc()
        return st, rh, rb

    # -- /v1/flow: least-loaded with replay-on-death -----------------------

    def route_flow(self, body: bytes, content_type: str, accept: str,
                   trace_id: Optional[str]) -> Tuple[int, dict, bytes]:
        """Forward one pairwise request; replays on another replica after
        a connection-level failure (pure inference: replay-safe).
        Returns (status, response headers, response body) verbatim from
        the replica, plus the router's trace id."""
        tr = self.tracer.start("pair", trace_id)
        headers = {"Content-Type": content_type or "application/json"}
        if accept:
            headers["Accept"] = accept
        if tr is not None:
            headers["X-Raft-Trace-Id"] = tr.trace_id
        elif trace_id:
            headers["X-Raft-Trace-Id"] = trace_id
        tried = set()
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                rep = self._pick(exclude=tried)
            except NoReplica:
                self.count_request("no_replica")
                if tr is not None:
                    tr.finish(tlm_spans.SHED)
                return self._json(503, {"error": "no routable replica"},
                                  retry_after=self.config.health_poll_s)
            if tr is not None:
                tr.span("route", t0, time.monotonic(), replica=rep.idx,
                        attempt=attempt)
            t1 = time.monotonic()
            try:
                st, rh, rb = self._forward(rep, "/v1/flow", body, headers)
            except ForwardError as e:
                self._unpick(rep.idx)
                tried.add(rep.idx)
                attempt += 1
                self.metrics["retries"].inc()
                if tr is not None:
                    tr.span("retry", t1, time.monotonic(), replica=rep.idx,
                            status=tlm_spans.ERROR, error=str(e))
                if attempt > self.config.forward_retries:
                    self.count_request("error")
                    if tr is not None:
                        tr.finish(tlm_spans.ERROR)
                    return self._json(502, {"error": f"forward failed "
                                            f"after {attempt} replica(s): "
                                            f"{e}"})
                continue
            self._unpick(rep.idx)
            if tr is not None:
                tr.span("forward", t1, time.monotonic(), replica=rep.idx,
                        http_status=st)
                tr.finish(_trace_status(st))
            self.count_request(status_class(st))
            out_headers = self._passthrough_headers(rh)
            if tr is not None:
                out_headers["X-Raft-Trace-Id"] = tr.trace_id
            out_headers["X-Raft-Replica"] = str(rep.idx)
            return st, out_headers, rb

    @staticmethod
    def _passthrough_headers(rh: dict) -> dict:
        out = {}
        for k in ("Content-Type", "Retry-After", "X-Raft-Trace-Id",
                  "X-Raft-Timings"):
            for hk, hv in rh.items():
                if hk.lower() == k.lower():
                    out[k] = hv
        return out

    @staticmethod
    def _json(status: int, obj: dict,
              retry_after: Optional[float] = None) -> Tuple[int, dict, bytes]:
        headers = {"Content-Type": "application/json"}
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after + 0.999)))
        return status, headers, json.dumps(obj).encode()

    # -- /v1/stream: session affinity with transparent migration ----------

    def route_stream(self, body: bytes, content_type: str, accept: str,
                     trace_id: Optional[str]) -> Tuple[int, dict, bytes]:
        op, rsid, image, deadline_ms = parse_stream_request(
            body, content_type)        # BadRequest propagates to the handler
        if op == "open":
            return self._stream_open(image, deadline_ms, accept, trace_id)
        if op == "close":
            return self._stream_close(rsid, accept)
        return self._stream_advance(rsid, image, deadline_ms, accept,
                                    trace_id)

    def _replica_headers(self, tr, trace_id) -> dict:
        headers = {"Content-Type": "application/octet-stream",
                   "Accept": "application/octet-stream"}
        if tr is not None:
            headers["X-Raft-Trace-Id"] = tr.trace_id
        elif trace_id:
            headers["X-Raft-Trace-Id"] = trace_id
        return headers

    def _stream_open(self, image, deadline_ms, accept,
                     trace_id) -> Tuple[int, dict, bytes]:
        tr = self.tracer.start("stream", trace_id)
        headers = self._replica_headers(tr, trace_id)
        body = _stream_npz("open", image=image, deadline_ms=deadline_ms)
        tried = set()
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                rep = self._pick(exclude=tried)
            except NoReplica:
                self.count_request("no_replica")
                if tr is not None:
                    tr.finish(tlm_spans.SHED)
                return self._json(503, {"error": "no routable replica"},
                                  retry_after=self.config.health_poll_s)
            if tr is not None:
                tr.span("route", t0, time.monotonic(), replica=rep.idx,
                        attempt=attempt)
            t1 = time.monotonic()
            try:
                st, rh, rb = self._forward(rep, "/v1/stream", body, headers)
            except ForwardError as e:
                self._unpick(rep.idx)
                tried.add(rep.idx)
                attempt += 1
                self.metrics["retries"].inc()
                if tr is not None:
                    tr.span("retry", t1, time.monotonic(), replica=rep.idx,
                            status=tlm_spans.ERROR, error=str(e))
                if attempt > self.config.forward_retries:
                    self.count_request("error")
                    if tr is not None:
                        tr.finish(tlm_spans.ERROR)
                    return self._json(502, {"error": f"open failed: {e}"})
                continue
            finally:
                if rep.idx not in tried:
                    self._unpick(rep.idx)
            if tr is not None:
                tr.span("forward", t1, time.monotonic(), replica=rep.idx,
                        http_status=st)
            break
        if st != 200:
            self.count_request(status_class(st))
            if tr is not None:
                tr.finish(_trace_status(st))
            return st, self._passthrough_headers(rh), rb
        resp = _parse_stream_npz(rb)
        backend_sid = str(resp["session"])
        fs = self.sessions.create(rep.idx, backend_sid, image)
        self.count_request("ok")
        if tr is not None:
            tr.finish()
        if self.run_log is not None:
            self.run_log.event("fleet_session_opened", session=fs.rsid,
                               replica=rep.idx)
        return self._stream_response(
            accept, fs.rsid, frame=int(resp.get("frame", 0)),
            replica=rep.idx, migrated=False,
            trace_id=tr.trace_id if tr else None)

    def _stream_close(self, rsid, accept) -> Tuple[int, dict, bytes]:
        fs = self.sessions.remove(rsid)
        if fs is None:
            self.count_request("bad_request")
            return self._json(404, {"error": f"unknown session {rsid}"})
        with fs.lock:
            rep = self.manager.get(fs.replica_idx)
            if rep is not None and rep.routable:
                try:
                    self._forward(rep, "/v1/stream",
                                  _stream_npz("close",
                                              session=fs.backend_sid),
                                  self._replica_headers(None, None))
                except ForwardError:
                    pass              # replica gone: nothing left to close
        self.count_request("ok")
        return self._stream_response(accept, rsid, frame=fs.frame,
                                     replica=fs.replica_idx, migrated=False,
                                     closed=True)

    def _stream_advance(self, rsid, image, deadline_ms, accept,
                        trace_id) -> Tuple[int, dict, bytes]:
        fs = self.sessions.get(rsid)
        if fs is None:
            self.count_request("bad_request")
            return self._json(404, {"error": f"unknown session {rsid} "
                                    f"(expired or never opened)"})
        tr = self.tracer.start("stream", trace_id)
        headers = self._replica_headers(tr, trace_id)
        with fs.lock:
            migrated = False
            attempts = 0
            while True:
                rep = self.manager.get(fs.replica_idx)
                if rep is None or not rep.routable:
                    try:
                        self._migrate(fs, tr, exclude={fs.replica_idx},
                                      deadline_ms=deadline_ms)
                    except (NoReplica, ForwardError) as e:
                        self.count_request("no_replica")
                        if tr is not None:
                            tr.finish(tlm_spans.SHED)
                        return self._json(
                            503, {"error": f"session migration failed: "
                                           f"{e}"},
                            retry_after=self.config.health_poll_s)
                    migrated = True
                    continue
                body = _stream_npz("advance", session=fs.backend_sid,
                                   image=image, deadline_ms=deadline_ms)
                t1 = time.monotonic()
                try:
                    st, rh, rb = self._forward(rep, "/v1/stream", body,
                                               headers)
                except ForwardError:
                    # pinned replica died mid-advance: its device state is
                    # gone either way, so the prev-frame replay both heals
                    # AND makes the retry idempotent — migrate, then loop
                    attempts += 1
                    if tr is not None:
                        tr.span("retry", t1, time.monotonic(),
                                replica=rep.idx, status=tlm_spans.ERROR)
                    self.metrics["retries"].inc()
                    if attempts > 1 + self.config.forward_retries:
                        self.count_request("error")
                        if tr is not None:
                            tr.finish(tlm_spans.ERROR)
                        return self._json(502, {"error": "advance failed: "
                                                "replicas keep dying"})
                    try:
                        self._migrate(fs, tr, exclude={fs.replica_idx},
                                      deadline_ms=deadline_ms)
                    except (NoReplica, ForwardError) as e:
                        self.count_request("no_replica")
                        if tr is not None:
                            tr.finish(tlm_spans.SHED)
                        return self._json(
                            503, {"error": f"session migration failed: "
                                           f"{e}"},
                            retry_after=self.config.health_poll_s)
                    migrated = True
                    continue
                if tr is not None:
                    tr.span("forward", t1, time.monotonic(),
                            replica=rep.idx, http_status=st)
                if st == 404 and attempts <= self.config.forward_retries:
                    # the replica lost the session (TTL reap / restarted
                    # replica): same heal as a death — replay prev, re-pin
                    attempts += 1
                    try:
                        self._migrate(fs, tr, exclude=(),
                                      deadline_ms=deadline_ms)
                    except (NoReplica, ForwardError) as e:
                        self.count_request("no_replica")
                        if tr is not None:
                            tr.finish(tlm_spans.SHED)
                        return self._json(503, {"error": f"session "
                                                f"migration failed: {e}"})
                    migrated = True
                    continue
                break
            if st != 200:
                self.count_request(status_class(st))
                if tr is not None:
                    tr.finish(_trace_status(st))
                return st, self._passthrough_headers(rh), rb
            resp = _parse_stream_npz(rb)
            fs.prev_frame = image         # the next migration's seed
            fs.frame = int(resp.get("frame", fs.frame + 1))
        self.count_request("ok")
        if tr is not None:
            tr.finish()
        flow = resp.get("flow")
        extras = {}
        if "warm" in resp:
            extras["warm"] = bool(resp["warm"])
        if "iters_used" in resp:
            extras["iters_used"] = np.asarray(resp["iters_used"]).tolist()
        return self._stream_response(
            accept, rsid, frame=fs.frame, replica=fs.replica_idx,
            migrated=migrated, flow=flow,
            trace_id=tr.trace_id if tr else None, **extras)

    def _migrate(self, fs: FleetSession, tr, exclude,
                 deadline_ms=None) -> None:
        """Re-pin ``fs`` onto a healthy replica by replaying its previous
        frame: ``open(prev)`` builds fresh device features there, and the
        NEXT advance runs the replica's zero-init first-advance path —
        flow equals pairwise, which is what makes migration transparent.
        Caller holds ``fs.lock`` (FleetSession.lock precedes the manager
        and router locks in SERVING_LOCK_HIERARCHY)."""
        t0 = time.monotonic()
        rep = self._pick(exclude=exclude)
        try:
            st, rh, rb = self._forward(
                rep, "/v1/stream",
                _stream_npz("open", image=fs.prev_frame,
                            deadline_ms=deadline_ms),
                self._replica_headers(tr, None))
        finally:
            self._unpick(rep.idx)
        if st != 200:
            raise ForwardError(f"migration open on replica {rep.idx} "
                               f"returned {st}: {rb[:200]!r}")
        resp = _parse_stream_npz(rb)
        old = fs.replica_idx
        fs.replica_idx = rep.idx
        fs.backend_sid = str(resp["session"])
        fs.migrations += 1
        self.metrics["migrations"].inc()
        if tr is not None:
            tr.span("migrate", t0, time.monotonic(), replica=rep.idx,
                    from_replica=old)
        _log.info(f"session {fs.rsid} migrated: replica {old} -> {rep.idx}")
        if self.run_log is not None:
            self.run_log.event("fleet_session_migrated", session=fs.rsid,
                               from_replica=old, to_replica=rep.idx)

    def _stream_response(self, accept: str, rsid: str, frame: int,
                         replica: int, migrated: bool, flow=None,
                         closed: bool = False, trace_id=None,
                         **extras) -> Tuple[int, dict, bytes]:
        headers = {"X-Raft-Replica": str(replica)}
        if trace_id:
            headers["X-Raft-Trace-Id"] = trace_id
        if "application/octet-stream" in (accept or ""):
            buf = io.BytesIO()
            arrays = {"session": np.asarray(rsid),
                      "frame": np.asarray(frame, np.int32),
                      "migrated": np.asarray(migrated)}
            if flow is not None:
                arrays["flow"] = np.asarray(flow)
            for k, v in extras.items():
                arrays[k] = np.asarray(v)
            np.savez(buf, **arrays)
            headers["Content-Type"] = "application/octet-stream"
            return 200, headers, buf.getvalue()
        res = {"session": rsid, "frame": frame,
               "meta": {"replica": replica, "migrated": migrated, **extras}}
        if closed:
            res["closed"] = True
        if flow is not None:
            res["flow"] = np.asarray(flow).tolist()
        headers["Content-Type"] = "application/json"
        return 200, headers, json.dumps(res).encode()

    # -- aggregation + admin -----------------------------------------------

    def health(self) -> Tuple[int, dict]:
        """Fleet /healthz: aggregate over the replica table.  200 while
        at least one replica is routable; 'degraded' when any replica is
        down or the fleet is below its desired size."""
        reps = self.manager.describe()
        ready = sum(r["state"] in ("ready", "degraded") for r in reps)
        desired = self.manager.desired
        if self._draining.is_set():
            return 503, {"status": "draining"}
        if ready == 0:
            return 503, {"status": "no_replicas", "replicas": reps,
                         "desired": desired}
        status = "ok"
        if ready < desired or any(r["state"] not in ("ready", "stopped")
                                  for r in reps):
            status = "degraded"
        return 200, {
            "status": status, "ready": ready, "desired": desired,
            "sessions": self.sessions.count(),
            "inflight": self.total_inflight(),
            "replicas": reps,
        }

    def render_fleet_metrics(self) -> str:
        """``GET /metrics/fleet``: every replica's last scraped
        exposition re-labeled with ``replica="<idx>"``, plus fleet
        rollups — the per-sample SUM across replicas (exact for
        counters and histogram buckets, additive for gauges like queue
        depth) — as ``replica="all"``.  One scrape target yields both
        per-replica and total series, derived from the manager's cached
        polls: no extra replica round-trips at scrape time."""
        lines: List[str] = []
        rollup: Dict[str, float] = {}
        for rep in sorted(self.manager.replicas(), key=lambda r: r.idx):
            if not rep.routable or not rep.prom:
                continue
            for key in sorted(rep.prom):
                val = rep.prom[key]
                name, _, rest = key.partition("{")
                labels = rest.rstrip("}")
                merged = (f'replica="{rep.idx}"'
                          + ("," + labels if labels else ""))
                lines.append(f"{name}{{{merged}}} {val:.10g}")
                rollup[key] = rollup.get(key, 0.0) + val
        for key in sorted(rollup):
            name, _, rest = key.partition("{")
            labels = rest.rstrip("}")
            merged = 'replica="all"' + ("," + labels if labels else "")
            lines.append(f"{name}{{{merged}}} {rollup[key]:.10g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def admin_reload(self, body: bytes,
                     tag: Optional[str]) -> Tuple[int, dict, bytes]:
        """Fleet-wide rolling hot-swap: delegate to the RollingUpdater
        (controller.py), one replica at a time."""
        if self.updater is None:
            return self._json(503, {"error": "no rolling updater wired "
                                    "(fleet controller not running)"})
        results = self.updater.roll(body, tag=tag)
        ok = all(r.get("status") == "reloaded" for r in results)
        # the aborting replica's status IS the roll's status (a 409
        # mismatch must surface as 409; skipped replicas carry none)
        worst = 200 if ok else max((r.get("http_status", 500)
                                    for r in results
                                    if r.get("status") == "failed"),
                                   default=500)
        return self._json(worst if not ok else 200,
                          {"status": "reloaded" if ok else "partial",
                           "replicas": results})

    def admin_scale(self, query: str) -> Tuple[int, dict, bytes]:
        """``POST /admin/scale?replicas=N``: :meth:`ReplicaManager.scale_to`
        (clamped to [min_replicas, max_replicas]; a shrink retires the
        highest-index replicas gracefully, a growth spawns and waits for
        the new replicas).  Returns the new desired size and the table."""
        raw = (parse_qs(query).get("replicas") or [None])[0]
        try:
            n = int(raw)
        except (TypeError, ValueError):
            return self._json(400, {"error": f"replicas must be an "
                                    f"integer, got {raw!r}"})
        desired = self.manager.scale_to(n, reason="admin")
        return self._json(200, {"desired": desired,
                                "replicas": self.manager.describe()})

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        from http.server import ThreadingHTTPServer

        from ..telemetry import events as tlm_events
        from ..telemetry import watchdogs as tlm_watchdogs
        if tlm_watchdogs.lock_watch_enabled():
            from ..lint.concurrency import SERVING_LOCK_HIERARCHY
            v = tlm_watchdogs.export_lock_metrics(
                self.registry, run_log=tlm_events.current())
            v.declare_order(SERVING_LOCK_HIERARCHY)
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"server_app": self})
        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), handler)
        self._httpd.daemon_threads = True
        self._http_thread = serve_in_thread(self._httpd)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def stop(self) -> None:
        self._draining.set()
        if self.flightrec is not None:
            try:
                self.flightrec.dump("shutdown")
            except Exception as e:  # noqa: BLE001
                _log.warning(f"flight-recorder dump failed: {e}")
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


class _RouterHandler(_Handler):
    """Router HTTP surface — inherits the serving handler's plumbing
    (_send/_send_json/_read_body/log_message) and replaces the
    endpoints; ``server_app`` is the FleetRouter."""

    def do_GET(self):
        router = self.server_app
        path = self.path.split("?")[0]
        if path == "/healthz":
            status, payload = router.health()
            headers = ({"Retry-After": "5"} if status == 503 else None)
            self._send_json(status, payload, headers=headers)
        elif path == "/metrics":
            self._send(200, router.registry.render().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/metrics/fleet":
            self._send(200, router.render_fleet_metrics().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/history":
            qs = parse_qs(self.path.partition("?")[2])
            window = None
            raw = (qs.get("window") or [None])[0]
            if raw is not None:
                try:
                    window = float(raw)
                    if window <= 0:
                        raise ValueError
                except ValueError:
                    self._send_json(400, {"error": f"window must be a "
                                          f"positive number of seconds, "
                                          f"got {raw!r}"})
                    return
            out = router.fleet_history.window_json(window)
            out["skewed"] = router.skewed()
            self._send_json(200, out)
        elif path == "/debug/traces":
            if router.flightrec is None:
                self._send_json(404, {"error": "tracing disabled "
                                      "(trace_sample 0)"})
                return
            ring, errors = router.flightrec.counts()
            self._send_json(200, {
                "open_traces": router.tracer.open_traces,
                "finished": router.tracer.finished,
                "retained_ok": ring, "retained_error": errors,
                "traces": router.flightrec.snapshot()})
        else:
            self._send_json(404, {"error": f"no handler for {path}"})

    def do_POST(self):
        router = self.server_app
        path = self.path.split("?")[0]
        if path not in ("/v1/flow", "/v1/stream", "/admin/reload",
                        "/admin/scale"):
            self._send_json(404, {"error": f"no handler for {path}"})
            return
        if router.draining:
            router.count_request("shed")
            self._send_json(503, {"error": "router is draining"},
                            headers={"Retry-After": "5"})
            return
        body = self._read_body()
        if body is None:
            return
        ct = self.headers.get("Content-Type", "application/json")
        accept = self.headers.get("Accept") or ""
        tid = self.headers.get("X-Raft-Trace-Id")
        try:
            if path == "/v1/flow":
                st, headers, rb = router.route_flow(body, ct, accept, tid)
            elif path == "/v1/stream":
                st, headers, rb = router.route_stream(body, ct, accept, tid)
            elif path == "/admin/scale":
                st, headers, rb = router.admin_scale(
                    self.path.partition("?")[2])
            else:
                st, headers, rb = router.admin_reload(
                    body, self.headers.get("X-Raft-Weight-Tag"))
        except BadRequest as e:
            router.count_request("bad_request")
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — router must answer, always
            router.count_request("error")
            self._send_json(500, {"error": f"router error: {e}"})
            return
        content_type = headers.pop("Content-Type", "application/json")
        self._send(st, rb, content_type, headers=headers)
