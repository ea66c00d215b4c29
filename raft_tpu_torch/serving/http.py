"""HTTP surface of the serving stack — stdlib ``http.server`` only.

The port's copy of the JAX package's ``serving/http.py``: the same
endpoints and request and response formats.

Endpoints:

  POST /v1/flow       infer optical flow for one image pair
  POST /v1/stream     sessionful video flow: open / advance / close
  POST /admin/reload  weight reload: body is the native params npz
                      ('/'-joined keys, the checkpoint format both packages
                      read); the engine checks, probes and copies the
                      weights in place (engine.reload).
                      200 with the new weight version on success, 409 when
                      the pushed tree doesn't match the serving template
                      (shape/dtype/structure), 400 on an unreadable body.
                      Optional X-Raft-Weight-Tag header names the push;
                      default tag is the body's sha256 prefix.
  GET  /healthz       liveness/readiness (503 while draining)
  GET  /metrics       Prometheus text exposition
  GET  /debug/traces  flight-recorder view: recent + error request traces
                      (optionally ?trace_id=<prefix>; 404 when tracing is
                      off via --trace-sample 0)
  GET  /debug/history windowed time-series JSON derived from the metric
                      history ring (?window=<seconds> clips; 404 when the
                      history is off via --history-interval 0).  Series:
                      pairs_per_s, p50/p95_ms, occupancy, queue_depth,
                      burn, sessions, cache-miss rates, anomalies —
                      OBSERVABILITY.md "Time-series & anomaly detection".
  POST /debug/profile on-demand torch.profiler capture of the next ?ms=
                      (default 500, max 60000) milliseconds on the LIVE
                      replica; single-flight (409 while one runs), 200
                      returns the trace_dir and the Chrome trace written.
  POST /admin/cache/prestage  write every warm key's entry and the
                      manifest into the attached AOT engine cache
                      (serving/aot_cache.py); 409 without a cache
                      (--engine-cache-dir).

Request tracing (OBSERVABILITY.md): every traced request carries a
``trace_id`` — minted server-side, or adopted from an ``X-Raft-Trace-Id``
request header — returned in the response (``meta.trace_id`` + the
``X-Raft-Trace-Id`` header) along with the server-side latency breakdown:
``meta.timings`` / the ``X-Raft-Timings`` header, per-span milliseconds
(admit, queue_wait, batch_form, pad, execute, execute_dispatch,
execute_block).  Error responses carry the trace id too when the request
got far enough to mint one.

``/v1/flow`` accepts two encodings:

* ``application/json``: ``{"image1": [[[...]]], "image2": [[[...]]],
  "deadline_ms": 500}`` — images as [H][W][3] nested lists of floats in
  [0, 1] (uint8 values 0-255 also accepted and rescaled).  Response JSON
  carries ``flow`` ([H][W][2]) plus routing/latency metadata.
* ``application/octet-stream``: an ``.npz`` body with ``image1``/``image2``
  arrays ([H, W, 3], float32 in [0, 1] or uint8) and optional scalar
  ``deadline_ms``.  With ``Accept: application/octet-stream`` the response
  is an ``.npz`` holding ``flow`` — the cheap path for real clients and
  the load bench.

``/v1/stream`` (SERVING.md streaming section) speaks the same two
encodings.  One field set drives three ops: ``op`` = ``open`` (first
frame of a session; default when no ``session`` is given), ``advance``
(next frame — returns flow(prev -> cur); default with a ``session``), or
``close``.  ``open``/``advance`` require ``image`` ([H, W, 3], same value
conventions as /v1/flow); ``advance``/``close`` require ``session`` (the
hex id ``open`` returned).  npz bodies carry ``op``/``session`` as 0-d
string arrays.

Error statuses: 400 malformed/unroutable input, 404 unknown path or
unknown/expired stream session, 409 stream session busy (a frame already
in flight), 413 body too large, 429 queue full (shed — retry with
backoff), 500 inference failure (including the ``poisoned`` class: a
bisected-guilty or non-finite-output request), 503 draining or circuit
breaker open, 504 deadline exceeded.  429 and 503 responses carry a
``Retry-After`` header (seconds) — honor it; hammering a shedding server
only deepens the storm.  Every terminal status increments
``raft_serving_requests_total{status=...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from ..telemetry import spans as tlm_spans
from ..telemetry.log import get_logger
from .queue import RejectedError

_log = get_logger("serve")

MAX_BODY_BYTES = 256 * 2**20   # one 4K pair is ~100 MB as float32 JSON


class BadRequest(Exception):
    # the client's mistake, not the replica's: no SLO burn, no seat in
    # the error-trace ring (telemetry/spans.py status taxonomy)
    trace_status = tlm_spans.BAD_REQUEST


def _decode_image(obj, name: str) -> np.ndarray:
    arr = np.asarray(obj, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise BadRequest(f"{name} must have shape [H, W, 3], "
                         f"got {list(arr.shape)}")
    if arr.shape[0] < 1 or arr.shape[1] < 1:
        raise BadRequest(f"{name} is empty: shape {list(arr.shape)}")
    if not np.isfinite(arr).all():
        raise BadRequest(f"{name} contains non-finite values")
    if arr.max() > 1.5:                    # uint8-range payload
        arr = arr / 255.0
    return arr


def parse_flow_request(body: bytes, content_type: str):
    """-> (image1, image2, deadline_ms or None).  Raises BadRequest."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct == "application/octet-stream":
        try:
            with np.load(io.BytesIO(body)) as z:
                if "image1" not in z or "image2" not in z:
                    raise BadRequest("npz body must contain image1 and image2")
                im1 = _decode_image(z["image1"], "image1")
                im2 = _decode_image(z["image2"], "image2")
                dl = float(z["deadline_ms"]) if "deadline_ms" in z else None
        except BadRequest:
            raise
        except Exception as e:
            raise BadRequest(f"could not read npz body: {e}")
        return im1, im2, dl
    # default: JSON
    try:
        payload = json.loads(body)
    except Exception as e:
        raise BadRequest(f"invalid JSON body: {e}")
    if not isinstance(payload, dict):
        raise BadRequest("JSON body must be an object")
    for k in ("image1", "image2"):
        if k not in payload:
            raise BadRequest(f"missing field {k!r}")
    try:
        im1 = _decode_image(payload["image1"], "image1")
        im2 = _decode_image(payload["image2"], "image2")
    except BadRequest:
        raise
    except Exception as e:
        raise BadRequest(f"could not decode images: {e}")
    dl = payload.get("deadline_ms")
    if dl is not None:
        try:
            dl = float(dl)
        except (TypeError, ValueError):
            raise BadRequest("deadline_ms must be a number")
    return im1, im2, dl


def parse_stream_request(body: bytes, content_type: str):
    """-> (op, session_id or None, image or None, deadline_ms or None).
    Raises BadRequest.  ``op`` defaults from the fields present: no
    session -> ``open``, session given -> ``advance``."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct == "application/octet-stream":
        try:
            with np.load(io.BytesIO(body)) as z:
                op = str(z["op"]) if "op" in z else None
                sid = str(z["session"]) if "session" in z else None
                image = (_decode_image(z["image"], "image")
                         if "image" in z else None)
                dl = float(z["deadline_ms"]) if "deadline_ms" in z else None
        except BadRequest:
            raise
        except Exception as e:
            raise BadRequest(f"could not read npz body: {e}")
    else:
        try:
            payload = json.loads(body)
        except Exception as e:
            raise BadRequest(f"invalid JSON body: {e}")
        if not isinstance(payload, dict):
            raise BadRequest("JSON body must be an object")
        op = payload.get("op")
        sid = payload.get("session")
        if sid is not None and not isinstance(sid, str):
            raise BadRequest("session must be a string id")
        image = None
        if "image" in payload:
            try:
                image = _decode_image(payload["image"], "image")
            except BadRequest:
                raise
            except Exception as e:
                raise BadRequest(f"could not decode image: {e}")
        dl = payload.get("deadline_ms")
        if dl is not None:
            try:
                dl = float(dl)
            except (TypeError, ValueError):
                raise BadRequest("deadline_ms must be a number")
    if op is None:
        op = "advance" if sid else "open"
    if op not in ("open", "advance", "close"):
        raise BadRequest(f"op must be 'open', 'advance' or 'close', "
                         f"got {op!r}")
    if op in ("open", "advance") and image is None:
        raise BadRequest(f"op {op!r} requires an image")
    if op in ("advance", "close") and not sid:
        raise BadRequest(f"op {op!r} requires a session id")
    return op, sid, image, dl


@contextlib.contextmanager
def _traced_send(tr, t_resp0: float):
    """One definition of stamping a trace onto a 200 response (both
    endpoints, both encodings): yields ``(headers, timings)`` — the
    X-Raft-* response headers and the per-span milliseconds for
    ``meta.timings`` (both None untraced) — and on exit, even if the
    client disconnected mid-write, records the respond span from
    ``t_resp0`` and finishes the trace so it cannot leak open."""
    headers = timings = None
    if tr is not None:
        # timings snapshot BEFORE the respond span lands: the span is
        # still being written while the body goes out
        timings = tr.timings_ms()
        headers = {"X-Raft-Trace-Id": tr.trace_id,
                   "X-Raft-Timings": json.dumps(timings)}
    try:
        yield headers, timings
    finally:
        if tr is not None:
            tr.span("respond", t_resp0, time.monotonic())
            tr.finish()


class _Handler(BaseHTTPRequestHandler):
    # the FlowServer instance; set on the subclass by make_http_server
    server_app = None
    protocol_version = "HTTP/1.1"

    # -- plumbing ---------------------------------------------------------

    def log_message(self, fmt, *args):   # route through the app, not stderr
        app = self.server_app
        if app is not None and app.verbose:
            _log.info(f"{self.address_string()} {fmt % args}")

    def _send(self, status: int, body: bytes, content_type: str,
              headers=None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj, headers=None) -> None:
        self._send(status, json.dumps(obj).encode(),
                   "application/json", headers=headers)

    def _send_rejection(self, e) -> None:
        """RejectedError -> its HTTP status; 429/503 advertise
        ``Retry-After`` (whole seconds, >= 1) so clients back off
        instead of retrying into the shed.  A rejection that got as far
        as minting a trace carries its id back (the exception's
        ``trace_id``, stamped where the trace was closed)."""
        headers = {}
        body = {"error": str(e)}
        retry_after = getattr(e, "retry_after", None)
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(-(-retry_after // 1))))
        tid = getattr(e, "trace_id", None)
        if tid is not None:
            headers["X-Raft-Trace-Id"] = tid
            body["trace_id"] = tid
        self._send_json(e.http_status, body, headers=headers or None)

    def _send_error(self, status: int, message: str, e) -> None:
        """400/500 twin of :meth:`_send_rejection`: one definition of
        'stamp the trace id onto an error response' (body + header)."""
        body = {"error": message}
        headers = None
        tid = getattr(e, "trace_id", None)
        if tid is not None:
            body["trace_id"] = tid
            headers = {"X-Raft-Trace-Id": tid}
        self._send_json(status, body, headers=headers)

    # -- endpoints --------------------------------------------------------

    def do_GET(self):
        app = self.server_app
        path = self.path.split("?")[0]
        if path == "/healthz":
            if app.draining:
                self._send_json(503, {"status": "draining"},
                                headers={"Retry-After": "5"})
            else:
                health = {
                    "status": app.health_status(),
                    "buckets": [list(b) for b in app.sconfig.buckets],
                    "batch_steps": list(app.sconfig.batch_steps),
                    "iters_policy": getattr(app.engine, "iters_policy",
                                            "fixed"),
                    "queue_depth": len(app.queue),
                    "executables": app.engine_executables(),
                    "batcher": {
                        "alive": app.batcher.alive,
                        "restarts": app.supervisor.restarts,
                    },
                }
                # stub engines (tests) may not carry the hot-swap surface
                winfo = getattr(app.engine, "weight_info", None)
                if winfo is not None:
                    health["weights"] = winfo()
                if app.breaker is not None:
                    health["breaker"] = {"state": app.breaker.state,
                                         "opens": app.breaker.opens}
                if app.flightrec is not None:
                    health["tracing"] = {
                        "sample": app.sconfig.trace_sample,
                        "open_traces": app.tracer.open_traces,
                    }
                cache = getattr(app, "engine_cache", None)
                if cache is not None:
                    # the fleet's stagger-skip reads this: misses == 0 with
                    # hits > 0 means the replica booted from the cache
                    ec = cache.stats.as_dict()
                    ec["dir"] = str(cache.dir)
                    ec["kernels"] = cache.kernels
                    ec["compiler_runs"] = cache.compiler_runs()
                    health["engine_cache"] = ec
                anomaly = getattr(app, "anomaly", None)
                if anomaly is not None:
                    # CI smoke gate: a clean run must report {} here; the
                    # chaos drill asserts a rule appears and then clears
                    health["anomalies"] = anomaly.active()
                streams = getattr(app, "streams", None)
                if streams is not None:
                    health["stream"] = {
                        "max_sessions": app.sconfig.max_sessions,
                        "session_ttl_s": app.sconfig.session_ttl_s,
                        "sessions_active": streams.store.active_count(),
                        "sessions_resident": streams.store.resident_count(),
                    }
                self._send_json(200, health)
        elif path == "/metrics":
            self._send(200, app.registry.render().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/traces":
            # on-demand flight-recorder view: recent ok traces + all
            # retained error traces, optionally ?trace_id=<prefix>
            if app.flightrec is None:
                self._send_json(404, {"error": "tracing disabled "
                                      "(--trace-sample 0)"})
                return
            qs = parse_qs(self.path.partition("?")[2])
            traces = app.flightrec.snapshot()
            want = (qs.get("trace_id") or [None])[0]
            if want:
                # stored ids are lowercase (spans.clean_trace_id); match
                # the exact header value a client sent, any case
                want = want.lower()
                traces = [t for t in traces
                          if t.get("trace_id", "").startswith(want)]
            ring, errors = app.flightrec.counts()
            self._send_json(200, {
                "open_traces": app.tracer.open_traces,
                "finished": app.tracer.finished,
                "retained_ok": ring, "retained_error": errors,
                "dumps": app.flightrec.dumps,
                "traces": traces})
        elif path == "/debug/history":
            history = getattr(app, "history", None)
            if history is None:
                self._send_json(404, {"error": "metric history disabled "
                                      "(--history-interval 0)"})
                return
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
            out = history.window_json(window)
            anomaly = getattr(app, "anomaly", None)
            if anomaly is not None:
                out["anomalies_active"] = anomaly.active()
            self._send_json(200, out)
        else:
            self._send_json(404, {"error": f"no handler for {path}"})

    def _read_body(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self.server_app.count_request("bad_request")
            self._send_json(413, {"error": "bad or oversized Content-Length"})
            return None
        return self.rfile.read(length)

    def do_POST(self):
        app = self.server_app
        path = self.path.split("?")[0]
        if path == "/v1/stream":
            self._post_stream()
            return
        if path == "/admin/reload":
            self._post_admin_reload()
            return
        if path == "/admin/cache/prestage":
            self._post_admin_cache_prestage()
            return
        if path == "/debug/profile":
            self._post_debug_profile()
            return
        if path != "/v1/flow":
            self._send_json(404, {"error": f"no handler for {path}"})
            return
        body = self._read_body()
        if body is None:
            return
        try:
            im1, im2, deadline_ms = parse_flow_request(
                body, self.headers.get("Content-Type", "application/json"))
            if im1.shape != im2.shape:
                raise BadRequest(f"image shapes differ: {list(im1.shape)} "
                                 f"vs {list(im2.shape)}")
        except BadRequest as e:
            app.count_request("bad_request")
            self._send_json(400, {"error": str(e)})
            return
        try:
            req = app.infer(im1, im2, deadline_ms,
                            trace_id=self.headers.get("X-Raft-Trace-Id"),
                            finish_trace=False)
        except RejectedError as e:
            # rejected/timeout accounting happens where the decision is
            # made (submit / batcher purge / wait timeout / breaker);
            # just translate to HTTP (+ Retry-After + trace id) here
            self._send_rejection(e)
            return
        except BadRequest as e:
            app.count_request("bad_request")
            self._send_error(400, str(e), e)
            return
        except Exception as e:
            # engine/batcher failure (already counted status="error" where
            # the batch died): a proper 500, not a dropped socket
            self._send_error(500, f"inference failed: {e}", e)
            return
        meta = {
            "bucket": list(req.bucket),
            "batch_real": req.batch_real,
            "batch_padded": req.batch_padded,
        }
        if req.iters_used is not None:     # converge policy: compute spent
            meta["iters_used"] = req.iters_used
        tr = req.trace
        # the respond span starts when the batcher resolved the request:
        # event-wake + marshal + socket write are all response delivery
        t_resp0 = req.finished_at or time.monotonic()
        with _traced_send(tr, t_resp0) as (headers, timings):
            if timings is not None:
                # meta.timings (SERVING.md); npz clients read the header
                meta["trace_id"] = tr.trace_id
                meta["timings"] = timings
            if "application/octet-stream" in (self.headers.get("Accept")
                                              or ""):
                buf = io.BytesIO()
                np.savez(buf, flow=req.result,
                         bucket=np.asarray(req.bucket, np.int32))
                self._send(200, buf.getvalue(), "application/octet-stream",
                           headers=headers)
            else:
                self._send_json(200, {"flow": req.result.tolist(),
                                      "meta": meta}, headers=headers)

    def _post_admin_reload(self):
        """Weight reload: npz body -> engine.reload (check + probe + copy
        in place, under the engine's device lock).  Runs on THIS handler
        thread; the batcher waits for the device lock meanwhile."""
        import hashlib

        from ..convert.weights import from_jax_params, load_params_npz
        from .engine import ReloadMismatch
        app = self.server_app
        body = self._read_body()
        if body is None:
            return
        try:
            params = from_jax_params(load_params_npz(io.BytesIO(body)))
            if not params:
                raise ValueError("npz body holds no arrays")
        except Exception as e:
            app.count_request("bad_request")
            self._send_json(400, {"error": f"could not read params npz: "
                                           f"{e}"})
            return
        tag = (self.headers.get("X-Raft-Weight-Tag")
               or hashlib.sha256(body).hexdigest()[:12])
        try:
            info = app.reload_params(params, tag=tag)
        except ReloadMismatch as e:
            self._send_json(409, {"error": str(e)})
            return
        except Exception as e:
            self._send_json(500, {"error": f"reload failed: {e}"})
            return
        self._send_json(200, {"status": "reloaded", "weights": info})

    def _post_admin_cache_prestage(self):
        """Write every warm key's entry and the manifest into the
        attached cache directory (serving/aot_cache.py)
        — what the rolling updater calls on one healthy replica BEFORE
        flipping weights, so a later spawn boots from a full directory.
        Runs on this handler thread like /admin/reload."""
        app = self.server_app
        if getattr(app, "engine_cache", None) is None:
            self._send_json(409, {"error": "no engine cache attached "
                                           "(--engine-cache-dir)"})
            return
        try:
            info = app.prestage_cache()
        except Exception as e:
            self._send_json(500, {"error": f"prestage failed: {e}"})
            return
        self._send_json(200, {"status": "prestaged", "cache": info})

    def _post_debug_profile(self):
        """On-demand profiler capture (?ms=, default 500): the handler
        thread blocks for the capture window while the batcher keeps
        serving — exactly what gets profiled.  Single-flight process-wide;
        a concurrent capture gets 409 (torch.profiler is a singleton)."""
        from ..telemetry.trace import MAX_CAPTURE_MS, CaptureBusy
        app = self.server_app
        qs = parse_qs(self.path.partition("?")[2])
        raw = (qs.get("ms") or ["500"])[0]
        try:
            ms = float(raw)
            if not 0 < ms <= MAX_CAPTURE_MS:
                raise ValueError
        except ValueError:
            self._send_json(400, {"error": f"ms must be in "
                                  f"(0, {MAX_CAPTURE_MS:g}], got {raw!r}"})
            return
        try:
            info = app.profile_capture(ms)
        except CaptureBusy as e:
            self._send_json(409, {"error": str(e)},
                            headers={"Retry-After": str(max(
                                1, int(ms / 1000.0 + 1)))})
            return
        except Exception as e:
            self._send_json(500, {"error": f"profiler capture failed: {e}"})
            return
        self._send_json(200, {"status": "captured", **info})

    def _post_stream(self):
        app = self.server_app
        body = self._read_body()
        if body is None:
            return
        try:
            op, sid, image, deadline_ms = parse_stream_request(
                body, self.headers.get("Content-Type", "application/json"))
        except BadRequest as e:
            app.count_request("bad_request")
            self._send_json(400, {"error": str(e)})
            return
        try:
            res = app.stream_call(op, sid, image, deadline_ms,
                                  trace_id=self.headers.get(
                                      "X-Raft-Trace-Id"),
                                  finish_trace=False)
        except RejectedError as e:
            # includes UnknownSession (404) and SessionBusy (409) — the
            # status (and any Retry-After + trace id) rides the exception
            self._send_rejection(e)
            return
        except BadRequest as e:
            app.count_request("bad_request")
            self._send_error(400, str(e), e)
            return
        except Exception as e:
            self._send_error(500, f"inference failed: {e}", e)
            return
        tr = res.pop("_trace", None)
        t_resp0 = res.pop("_finished_at", None) or time.monotonic()
        flow = res.pop("flow", None)
        with _traced_send(tr, t_resp0) as (headers, timings):
            if timings is not None:
                meta = res.get("meta")
                if meta is not None:
                    meta["timings"] = timings
            if "application/octet-stream" in (self.headers.get("Accept")
                                              or ""):
                buf = io.BytesIO()
                arrays = {"session": np.asarray(res["session"]),
                          "frame": np.asarray(res.get("frame", 0),
                                              np.int32)}
                if flow is not None:
                    arrays["flow"] = flow
                meta = res.get("meta") or {}
                if "warm" in meta:
                    arrays["warm"] = np.asarray(meta["warm"])
                if "iters_used" in meta:
                    arrays["iters_used"] = np.asarray(meta["iters_used"],
                                                      np.int32)
                np.savez(buf, **arrays)
                self._send(200, buf.getvalue(), "application/octet-stream",
                           headers=headers)
            else:
                if flow is not None:
                    res["flow"] = flow.tolist()
                self._send_json(200, res, headers=headers)


def make_http_server(app, host: str, port: int) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"server_app": app})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def serve_in_thread(httpd: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="raft-serving-http")
    t.start()
    return t
