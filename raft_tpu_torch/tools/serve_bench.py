"""Load generator for the port's serving stack:
``python -m raft_tpu_torch.tools.serve_bench``.

The port of the JAX package's ``tools/serve_bench.py``.  It drives a
``raft_tpu_torch.serving.FlowServer`` over real HTTP (keep-alive
``http.client`` connections, npz bodies) in either loop mode:

* ``--mode closed`` (default): C client threads, each back to back;
* ``--mode open``: Poisson arrivals at ``--rate`` req/s handed to a worker
  pool, so overload shows as 429 sheds, not as flattered latencies.

The server runs in-process (the ``-m serve`` knobs: buckets, max-batch,
max-wait, queue-depth) on the card, or on the CPU with ``--cpu``;
``--url`` benches an external server instead.  Each run prints one JSON
record (p50/p95/p99/mean latency, pairs/s, device-batch size and
occupancy, shed and timeout counts, captures after warm-up) and appends it
to ``--out`` (default ``build/port_tools/serve_bench.jsonl``), with the
card's name and power limit.

``--smoke`` is the fast path (raft-small, 32x48, 2 iterations, a few dozen
requests, a converge policy): it fails if the batcher never coalesced or a
graph was captured after warm-up, and it audits the observability planes:
tracing must cost under 5% of pairs/s and the metric history under 2%
(each against a control phase with it off; an apparent failure re-measures
once), ``/debug/traces`` must account for >= 95% of each request's server
time, a live ``POST /debug/profile``
must write a readable ``torch.profiler`` Chrome trace (holding CUDA kernel
events on the card) with no capture in its window, and no anomaly
sentinel may fire.  The static budget analyzer's warm grid must equal the
engine's keys.

The arms, each gated under ``--smoke``: ``--video`` (pairwise vs
``/v1/stream`` on the same frames, lockstep sessions, continuous batching),
``--chaos SPEC`` (a fault storm, then recovery: every failure attributable,
restarts visible, healthz back to ok, the sentinels fire and clear),
``--coldstart`` (a cold boot against an empty engine cache vs a cached boot
of a new server), ``--fleet`` (replica subprocesses behind the port's
router: scaling, a replica kill with session migration, a rolling
hot-swap under load) and ``--ragged-sweep`` (dense vs ragged servers on a
mixed-resolution load).

Two JAX gates do not carry over (ROADMAP "Deviations by design"): a CUDA
graph and cuDNN's choices cannot be serialized, so a cached boot still
captures every key and the coldstart arm gates on a fully warm cache, no
compiler run and a faster boot instead of a 5x faster first answer; and
replicas on one card time-slice it, so the fleet's 1.7x scaling is gated
only when every replica has a device of its own.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import queue as _queue
import re
import sys
import tempfile
import threading
import time

import numpy as np

from ._common import card, default_out, device_kind, resolve_device

#: Seconds any client thread may run past its phase before the bench
#: gives up on it (a join that times out is a failure, never a hang).
JOIN_S = 300.0

#: cuDNN's algorithm choice of every ``--smoke`` server (raft-small at
#: 32x48): its heuristic choice is the same in every process, so an engine
#: cache's respawned replica replays the writer's bits, and at these shapes
#: it is no slower than the timed benchmark (on an H100, each of the smoke
#: fleet's 8 keys 4-12% faster, where the benchmark's own picks differed
#: between two processes on 3 of them: ``tools/port_cudnn_modes.py``).
#: The full-size configurations keep the benchmark (ServeConfig's default):
#: there the heuristic took 7-11% longer at batch 1 and 18-21x at batch 4.
SMOKE_CUDNN = "heuristic"


def parse_prom(text: str):
    """Minimal Prometheus text parser: 'name{labels}' -> float."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = re.match(r"^(\S+?)(\{[^}]*\})?\s+(\S+)$", ln)
        if m:
            out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def hist_percentile(prom, name: str, q: float):
    """Percentile from a scraped histogram's cumulative buckets: the upper
    bound of the first bucket covering quantile ``q``."""
    pts = []
    for k, v in prom.items():
        m = re.match(rf'^{re.escape(name)}_bucket\{{le="([^"]+)"\}}$', k)
        if m:
            le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
            pts.append((le, v))
    total = prom.get(f"{name}_count", 0)
    if not pts or not total:
        return None
    pts.sort()
    for le, cum in pts:
        if cum >= q * total:
            return le
    return pts[-1][0]


def diff_prom(before, after):
    """after - before per series: the metrics one phase contributed."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def _join(threads, timeout: float = JOIN_S) -> None:
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"{len(stuck)} client thread(s) still running "
                           f"{timeout:.0f} s after their phase: {stuck[:4]}")


class Client:
    """One keep-alive connection + the shared accounting; with a
    ``timings`` list, the server's per-span breakdown (``X-Raft-Timings``,
    ms) of every request is kept too."""

    def __init__(self, host, port, body, results, lock, timings=None):
        self.conn = http.client.HTTPConnection(host, port, timeout=60)
        self.body = body
        self.results = results        # list of (status, latency_s)
        self.lock = lock
        self.timings = timings        # list of {span: ms} or None

    def one(self, deadline_ms=None):
        t0 = time.monotonic()
        tm = None
        try:
            self.conn.request(
                "POST", "/v1/flow", body=self.body,
                headers={"Content-Type": "application/octet-stream",
                         "Accept": "application/octet-stream"})
            resp = self.conn.getresponse()
            resp.read()
            status = resp.status
            if self.timings is not None:
                hdr = resp.getheader("X-Raft-Timings")
                if hdr:
                    try:
                        tm = json.loads(hdr)
                    except ValueError:
                        tm = None
        except Exception:
            self.conn.close()
            self.conn = http.client.HTTPConnection(
                self.conn.host, self.conn.port, timeout=60)
            status = -1
        with self.lock:
            self.results.append((status, time.monotonic() - t0))
            if tm is not None:
                self.timings.append(tm)


def scrape(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        return parse_prom(conn.getresponse().read().decode())
    finally:
        conn.close()


def _get_json(host, port, path, timeout=10):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def budget_crosscheck(server, prom, dev):
    """The static analyzer against the engine (run once the server has
    stopped: the analyzer's fake-tensor forwards suspend the NaN
    sentinel process-wide): the warm grid the
    engine built must equal ``enumerate_warmup_grid`` exactly; the HBM
    estimate (``lint/budget.py::analyze``) lands next to the device-memory
    gauge when the watchdogs export it.  Returns (record, problems)."""
    from ..lint import budget as lint_budget

    engine = server.engine
    problems = []
    expected = lint_budget.enumerate_warmup_grid(
        engine.config, engine.sconfig, stream=engine.stream,
        chaos=engine.faults is not None)
    live = list(engine.keys())
    missing = sorted(set(expected) - set(live))
    extra = sorted(set(live) - set(expected))
    if engine.sconfig.warmup:
        if missing:
            problems.append(
                f"{len(missing)} analyzer-enumerated warmup key(s) the "
                f"engine never built: {missing[:4]}")
        if extra:
            problems.append(
                f"{len(extra)} live key(s) the static enumeration missed: "
                f"{extra[:4]}")
    kind = device_kind(dev)
    report = lint_budget.analyze(engine.config, engine.sconfig,
                                 device_kind=kind, stream=engine.stream,
                                 chaos=engine.faults is not None)
    measured = prom.get("raft_serving_hbm_bytes_in_use")
    rec = {
        "grid_static": len(expected), "grid_live": len(live),
        "grid_match": not missing and not extra,
        "device_kind": kind,
        "static_resident_bytes": report["totals"]["resident_bytes"],
        "static_peak_bytes": report["totals"]["peak_bytes"],
        "max_sessions_fit": report["totals"]["max_sessions_fit"],
        "hbm_measured_bytes": (int(measured) if measured is not None
                               else None),
    }
    return rec, problems


def make_session_frames(h, w, n, seed, shift=6):
    """A synthetic constant-velocity sequence: the synthetic dataset's
    procedural texture translated ``shift`` px per frame plus mild
    per-frame noise (the JAX tool's frames, bitwise where the two
    datasets' textures agree)."""
    from ..data.synthetic import SyntheticFlowDataset
    base = SyntheticFlowDataset(size=(h, w), length=1, seed=seed)[0][0]
    rng = np.random.RandomState(seed)
    frames = []
    for t in range(n):
        f = np.roll(base, shift=shift * t, axis=1)
        f = np.clip(f + rng.randn(h, w, 3).astype(np.float32) * 0.01, 0, 1)
        frames.append(f)
    return frames


def arrival_gaps(total: int, rate: float, seed: int = 0) -> list:
    """The open loop's inter-arrival gaps (s): exponential at ``rate`` per
    second from ``RandomState(seed)``, drawn one by one as the JAX tool
    draws them; ``run_open`` sends arrival k at the start plus the first k
    gaps."""
    rng = np.random.RandomState(seed)
    return [rng.exponential(1.0 / rate) for _ in range(total)]


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _pair_body(h, w, seed=0):
    rng = np.random.RandomState(seed)
    im1 = rng.rand(h, w, 3).astype(np.float32)
    im2 = np.clip(im1 + rng.randn(h, w, 3).astype(np.float32) * 0.05, 0, 1)
    return _npz(image1=im1, image2=im2)


class StreamClient(Client):
    """Keep-alive client speaking /v1/stream npz bodies."""

    def post(self, path, body):
        t0 = time.monotonic()
        try:
            self.conn.request(
                "POST", path, body=body,
                headers={"Content-Type": "application/octet-stream",
                         "Accept": "application/octet-stream"})
            resp = self.conn.getresponse()
            payload = resp.read()
            status = resp.status
        except Exception:
            self.conn.close()
            self.conn = http.client.HTTPConnection(
                self.conn.host, self.conn.port, timeout=60)
            status, payload = -1, b""
        with self.lock:
            self.results.append((status, time.monotonic() - t0))
        return status, payload

    def run_sequence(self, frames, pace=None):
        """open -> advance x (n-1) -> close; only the advances (the pairs)
        land in the shared results."""
        saved = self.results
        self.results = []
        st, payload = self.post("/v1/stream", _npz(image=frames[0]))
        self.results = saved
        if st != 200:
            with self.lock:
                self.results.append((st, 0.0))
            if pace is not None:
                pace.abort()
            return
        with np.load(io.BytesIO(payload)) as z:
            sid = str(z["session"])
        for f in frames[1:]:
            if pace is not None:
                pace.wait()
            self.post("/v1/stream", _npz(op=np.asarray("advance"),
                                         session=np.asarray(sid), image=f))
        saved = self.results
        self.results = []
        self.post("/v1/stream", _npz(op=np.asarray("close"),
                                     session=np.asarray(sid)))
        self.results = saved

    def run_pairwise(self, frames, pace=None):
        for a, b in zip(frames[:-1], frames[1:]):
            if pace is not None:
                pace.wait()
            self.post("/v1/flow", _npz(image1=a, image2=b))


class _Pace:
    """Frame-lockstep barrier for the closed-loop video arms; a failed
    session aborts it and the survivors free-run instead of hanging."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n) if n > 1 else None

    def wait(self) -> None:
        if self._barrier is None:
            return
        try:
            self._barrier.wait(timeout=30.0)
        except threading.BrokenBarrierError:
            pass

    def abort(self) -> None:
        if self._barrier is not None:
            self._barrier.abort()


def run_video(host, port, sequences, stream, lockstep=True, rate=None,
              seed=0):
    """Drive every sequence concurrently (one worker per session); returns
    (results, elapsed).  ``lockstep`` paces frames with a barrier; ``rate``
    makes session starts Poisson-spaced instead."""
    results, lock = [], threading.Lock()
    pace = _Pace(len(sequences)) if (lockstep and rate is None) else None
    delays = None
    if rate is not None:
        rng = np.random.RandomState(seed)
        gaps = rng.exponential(1.0 / rate, size=len(sequences))
        delays = np.cumsum(gaps) - gaps[0]

    def worker(i, frames):
        if delays is not None and delays[i] > 0:
            time.sleep(float(delays[i]))
        c = StreamClient(host, port, b"", results, lock)
        if stream:
            c.run_sequence(frames, pace=pace)
        else:
            c.run_pairwise(frames, pace=pace)

    threads = [threading.Thread(target=worker, args=(i, fr), daemon=True)
               for i, fr in enumerate(sequences)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    _join(threads)
    return results, time.monotonic() - t0


def run_closed(host, port, body, clients, total, timings=None):
    results, lock = [], threading.Lock()
    remaining = [total]

    def worker():
        c = Client(host, port, body, results, lock, timings=timings)
        while True:
            with lock:
                if remaining[0] <= 0:
                    return
                remaining[0] -= 1
            c.one()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    _join(threads)
    return results, time.monotonic() - t0


def run_open(host, port, body, clients, total, rate, seed=0, timings=None):
    """Poisson arrivals at ``rate`` req/s (``arrival_gaps``) handed to
    ``clients`` worker threads; an arrival finding every worker busy
    waits in the job queue."""
    results, lock = [], threading.Lock()
    jobs = _queue.Queue()

    def worker():
        c = Client(host, port, body, results, lock, timings=timings)
        while True:
            try:
                item = jobs.get(timeout=JOIN_S)
            except _queue.Empty:
                return
            if item is None:
                return
            c.one()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    next_t = t0
    for gap in arrival_gaps(total, rate, seed):
        next_t += gap
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        jobs.put(1)
    for _ in threads:
        jobs.put(None)
    _join(threads)
    return results, time.monotonic() - t0


def _timings_summary(timings):
    """Per-span p50/p95 (ms) over the collected X-Raft-Timings headers."""
    if not timings:
        return None
    out = {}
    for name in ("admit", "queue_wait", "batch_form", "pad", "execute",
                 "execute_dispatch", "execute_block"):
        vals = sorted(t[name] for t in timings if name in t)
        if vals:
            out[name] = {
                "p50": round(float(np.percentile(vals, 50)), 3),
                "p95": round(float(np.percentile(vals, 95)), 3),
            }
    return out or None


def fetch_trace_accounting(host, port, settle_s=5.0):
    """GET /debug/traces and audit the span accounting: for every finished
    ok trace, the top-level spans must cover ~all of the root ``request``
    span; no trace may stay open.  Returns (record, problems)."""
    deadline = time.monotonic() + settle_s
    while True:
        code, payload = _get_json(host, port, "/debug/traces")
        if code != 200:
            return None, [f"/debug/traces answered {code}"]
        if not payload.get("open_traces") or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    coverages, dispatch_seen, block_seen = [], 0, 0
    worst = None
    for tr in payload.get("traces", []):
        spans = tr.get("spans", [])
        root = next((s for s in spans if s["name"] == "request"), None)
        if root is None or not root.get("dur_ms"):
            continue
        for s in spans:
            dispatch_seen += s["name"] == "execute_dispatch"
            block_seen += s["name"] == "execute_block"
        if tr.get("status") != "ok":
            continue
        top = sum(s.get("dur_ms", 0.0) for s in spans
                  if s.get("parent") == root["span"])
        coverages.append(top / root["dur_ms"])
        if worst is None or coverages[-1] < worst[0]:
            worst = (coverages[-1], root, spans)
    rec = {
        "open_traces": payload.get("open_traces"),
        "finished": payload.get("finished"),
        "retained_ok": payload.get("retained_ok"),
        "retained_error": payload.get("retained_error"),
        "ok_traces_audited": len(coverages),
        "span_coverage_min": round(min(coverages), 4) if coverages else None,
        "span_coverage_mean": round(sum(coverages) / len(coverages), 4)
        if coverages else None,
        "worst_trace_gaps": _gaps(*worst[1:]) if worst else None,
    }
    problems = []
    if payload.get("open_traces"):
        problems.append(f"{payload['open_traces']} trace(s) still open "
                        f"after the run — leaked spans")
    if not coverages:
        problems.append("no completed ok traces to audit on /debug/traces")
    else:
        if rec["span_coverage_mean"] < 0.95:
            problems.append(
                f"span accounting covers only "
                f"{rec['span_coverage_mean']:.0%} of e2e on average "
                f"(>= 95% required)")
        if rec["span_coverage_min"] < 0.75:
            problems.append(
                f"a request's spans cover only "
                f"{rec['span_coverage_min']:.0%} of its e2e (>= 75% floor)")
    if not dispatch_seen or not block_seen:
        problems.append("execute_dispatch/execute_block spans missing — "
                        "device time is not split dispatch vs block")
    return rec, problems


def _gaps(root: dict, spans: list) -> list:
    """Where a trace's top-level spans leave its root uncovered: each gap
    over 0.1 ms as [ms, the span before it, the span after it] (a
    diagnostic beside the accounting gate)."""
    top = sorted((s for s in spans if s.get("parent") == root["span"]),
                 key=lambda s: s["start_ms"])
    out, end, last = [], 0.0, "start"
    for s in top:
        if s["start_ms"] - end > 0.1:
            out.append([round(s["start_ms"] - end, 3), last, s["name"]])
        if s["start_ms"] + s["dur_ms"] >= end:
            end, last = s["start_ms"] + s["dur_ms"], s["name"]
    if root["dur_ms"] - end > 0.1:
        out.append([round(root["dur_ms"] - end, 3), last, "end"])
    return out


def run_chaos_recovery(args, host, port, server, results, body, deadline_s,
                       storm_t0=None):
    """The drill's second act: disarm the injector, feed clean probes until
    /healthz reports ok, and audit the storm (every failure attributable,
    restarts visible, the sentinels fired within one window and cleared,
    the flight recorder dumped the error traces).  Returns (record,
    problems)."""
    injected = dict(server.faults.injected)
    server.faults.disarm()
    server._flight_dump("chaos_drill")
    probe = Client(host, port, body, [], threading.Lock())
    t0 = time.monotonic()
    timeout = max(server.sconfig.breaker_cooldown_s,
                  server.sconfig.degraded_window_s) + 10.0
    status, recovered_s = None, None
    while time.monotonic() - t0 < timeout:
        probe.one()
        try:
            status = _get_json(host, port, "/healthz")[1].get("status")
        except Exception:
            status = None
        if status == "ok":
            recovered_s = time.monotonic() - t0
            break
        time.sleep(0.2)

    statuses = {}
    for st, _ in results:
        statuses[str(st)] = statuses.get(str(st), 0) + 1
    total = len(results)
    ok = statuses.get("200", 0)
    sheds = statuses.get("503", 0)
    failures = total - ok - sheds
    bound = (injected["nan"] + injected["engine_error"]
             + injected["kill"] * args.max_batch + injected["session"]
             + injected["latency"])
    max_lat = max((lat for _, lat in results), default=0.0)
    restarts = server.supervisor.restarts
    rec = {
        "spec": args.chaos, "injected": injected, "statuses": statuses,
        "failures": failures, "breaker_sheds_503": sheds,
        "attributable_bound": bound, "max_latency_s": round(max_lat, 3),
        "batcher_restarts": restarts,
        "breaker_opens": server.breaker.opens if server.breaker else None,
        "healthz_after_storm": status,
        "recovered_s": round(recovered_s, 3) if recovered_s else None,
    }
    problems = []
    mon = server.anomaly
    if mon is not None and server.history is not None:
        clear_deadline = time.monotonic() + (
            mon.config.window_s + 5 * server.history.interval_s + 10.0)
        while mon.active() and time.monotonic() < clear_deadline:
            probe.one()
            time.sleep(0.2)
        fired = dict(mon.fired_at)
        budget_s = mon.config.window_s + 2 * server.history.interval_s
        detect_s = (round(min(fired.values()) - storm_t0, 3)
                    if fired and storm_t0 is not None else None)
        still = mon.active()
        rec["anomaly"] = {
            "rules_fired": sorted(fired), "detection_latency_s": detect_s,
            "detection_budget_s": round(budget_s, 3),
            "window_s": mon.config.window_s,
            "interval_s": server.history.interval_s,
            "active_after_recovery": still,
        }
        if not fired:
            problems.append("chaos storm fired no anomaly sentinel")
        elif detect_s is not None and detect_s > budget_s:
            problems.append(
                f"first sentinel fired {detect_s:.1f}s after the storm "
                f"began — past one sampling window ({budget_s:.1f}s)")
        if still:
            problems.append(f"sentinel(s) still firing after recovery: "
                            f"{sorted(still)}")
    fire_count = sum(injected.values())
    fp = server.sconfig.flightrec_path
    if fp and os.path.exists(fp):
        frecs = []
        with open(fp) as f:
            for ln in f:
                try:
                    frecs.append(json.loads(ln))
                except json.JSONDecodeError:
                    pass
        err_traces = [r for r in frecs if r.get("event") == "trace"
                      and r.get("status") not in (None, "ok")]
        rec["flightrec"] = {
            "path": fp, "records": len(frecs),
            "error_traces": len(err_traces),
            "dump_reasons": sorted({str(r.get("reason")) for r in frecs
                                    if r.get("event") == "flightrec_dump"}),
        }
        if fire_count and not err_traces:
            problems.append("chaos faults fired but the flight-recorder "
                            "dump holds no error-status trace")
    elif fire_count and server.flightrec is not None:
        problems.append(f"chaos faults fired but no flight-recorder dump "
                        f"at {fp}")
    if statuses.get("-1"):
        problems.append(f"{statuses['-1']} dropped/errored connection(s) "
                        f"under chaos")
    if failures > bound:
        problems.append(
            f"{failures} failed request(s) but only {bound} attributable "
            f"to injected faults (injected: {injected})")
    if max_lat > deadline_s + 1.0:
        problems.append(f"a request took {max_lat:.1f}s — past its "
                        f"{deadline_s:.0f}s deadline (hung?)")
    if injected["kill"] and restarts < 1:
        problems.append(f"{injected['kill']} batcher kill(s) injected but "
                        f"raft_batcher_restarts_total shows no restart")
    if fire_count == 0:
        problems.append("chaos armed but no fault ever fired — the drill "
                        "tested nothing (raise rates or requests)")
    if status != "ok":
        problems.append(f"healthz still {status!r} "
                        f"{timeout:.0f}s after the storm")
    return rec, problems


def audit_trace_file(path: str, cuda: bool) -> dict:
    """Read a ``torch.profiler`` Chrome trace: its size, its events, and
    how many of them are CUDA kernels (``cat == "kernel"``)."""
    with open(path) as f:
        trace = json.load(f)
    events = (trace.get("traceEvents", []) if isinstance(trace, dict)
              else trace)
    kernels = sum(1 for e in events if isinstance(e, dict)
                  and str(e.get("cat", "")).lower() == "kernel")
    return {"file": path, "bytes": os.path.getsize(path),
            "events": len(events), "cuda_kernel_events": kernels,
            "cuda": cuda}


def run_profile_capture(host, port, body, cuda, ms=200.0):
    """POST /debug/profile while a background client keeps traffic
    flowing, then audit: 200, a readable Chrome trace under the returned
    trace_dir holding events (CUDA kernel events on the card), and no
    compile-cache miss or graph capture across the window.  Returns
    (record, problems)."""
    pre = scrape(host, port)
    miss0 = pre.get("raft_serving_compile_cache_misses_total", 0)
    rcmp0 = pre.get("raft_serving_xla_recompiles_total")
    stop = threading.Event()

    def trickle():
        c = Client(host, port, body, [], threading.Lock())
        while not stop.is_set():
            c.one()

    t = threading.Thread(target=trickle, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection(host, port,
                                          timeout=ms / 1000.0 + 60.0)
        conn.request("POST", f"/debug/profile?ms={ms:g}")
        resp = conn.getresponse()
        code = resp.status
        out = json.loads(resp.read())
        conn.close()
    except Exception as e:  # noqa: BLE001 — audited below
        code, out = -1, {"error": f"{type(e).__name__}: {e}"}
    finally:
        stop.set()
        t.join(timeout=60)
    rec = {"status_code": code, "duration_ms": out.get("duration_ms"),
           "trace_dir": out.get("trace_dir")}
    problems = []
    if t.is_alive():
        problems.append("the profile capture's traffic client did not stop")
    if code != 200:
        problems.append(f"POST /debug/profile?ms={ms:g} returned {code}: "
                        f"{out.get('error')}")
        return rec, problems
    files = []
    tdir = out.get("trace_dir")
    if tdir and os.path.isdir(tdir):
        for root, _dirs, names in os.walk(tdir):
            files.extend(os.path.join(root, f) for f in names
                         if f.endswith(".json"))
    audits = []
    for p in files:
        try:
            audits.append(audit_trace_file(p, cuda))
        except (OSError, ValueError) as e:
            problems.append(f"profiler trace {p} is not readable JSON: {e}")
    rec["trace_files"] = len(files)
    rec["trace_bytes"] = sum(a["bytes"] for a in audits)
    rec["trace_events"] = sum(a["events"] for a in audits)
    rec["cuda_kernel_events"] = sum(a["cuda_kernel_events"] for a in audits)
    if not audits or not rec["trace_events"]:
        problems.append(f"profiler capture left no readable trace with "
                        f"events under {tdir!r}")
    elif cuda and not rec["cuda_kernel_events"]:
        problems.append("the profiler trace holds no CUDA kernel event")
    post = scrape(host, port)
    rec["compile_miss_delta"] = (
        post.get("raft_serving_compile_cache_misses_total", 0) - miss0)
    if rec["compile_miss_delta"]:
        problems.append(f"{rec['compile_miss_delta']:g} compile-cache "
                        f"miss(es) during the profiler capture")
    if rcmp0 is not None:
        rec["capture_delta"] = (
            post.get("raft_serving_xla_recompiles_total", 0) - rcmp0)
        if rec["capture_delta"]:
            problems.append(f"{rec['capture_delta']:g} graph capture(s) "
                            f"during the profiler capture")
    return rec, problems


def _iters_summary(prom_diff):
    cnt = prom_diff.get("raft_iters_used_count", 0)
    if not cnt:
        return None
    return {"count": int(cnt),
            "mean": round(prom_diff.get("raft_iters_used_sum", 0.0) / cnt, 3),
            "p50": hist_percentile(prom_diff, "raft_iters_used", 0.50),
            "p95": hist_percentile(prom_diff, "raft_iters_used", 0.95)}


def _pps(results, elapsed) -> float:
    """Answered-200 pairs per second of a phase."""
    ok = sum(1 for st, _ in results if st == 200)
    return ok / elapsed if elapsed else 0.0


def _statuses(results):
    by = {}
    for st, _ in results:
        by[str(st)] = by.get(str(st), 0) + 1
    return by


def _stamp(rec, dev, config, mode):
    """The card's name and power limit and the run manifest."""
    from ..telemetry import run_manifest
    rec["device"] = str(dev)
    rec["card"] = card(dev)
    rec["manifest"] = run_manifest(config=config, mode=mode)
    return rec


def _write(rec, out):
    print(json.dumps(rec, indent=2, default=str))
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
        print(f"[bench] appended to {out}")


def video_phases(host, port, seqs, rate=None):
    """The two video arms on the same frames: pairwise /v1/flow, then
    /v1/stream; returns ((results, s, metrics diff) per arm, last scrape)."""
    prom0 = scrape(host, port)
    cold_res, cold_s = run_video(host, port, seqs, stream=False, rate=rate)
    prom_cold = scrape(host, port)
    stream_res, stream_s = run_video(host, port, seqs, stream=True,
                                     rate=rate)
    prom_stream = scrape(host, port)
    return ((cold_res, cold_s, diff_prom(prom0, prom_cold)),
            (stream_res, stream_s, diff_prom(prom_cold, prom_stream)),
            prom_stream)


def _video_phase(results, elapsed, d):
    ok = sum(1 for st, _ in results if st == 200)
    occ_cnt = d.get("raft_serving_batch_occupancy_count", 0)
    bs_cnt = d.get("raft_serving_batch_size_count", 0)
    return {"pairs_per_sec": round(ok / elapsed, 3) if elapsed else 0.0,
            "elapsed_s": round(elapsed, 3), "statuses": _statuses(results),
            "batch_size_mean": round(
                d.get("raft_serving_batch_size_sum", 0.0) / bs_cnt, 3)
            if bs_cnt else None,
            "batch_occupancy_mean": round(
                d.get("raft_serving_batch_occupancy_sum", 0.0)
                / occ_cnt, 3) if occ_cnt else None,
            "iters_used": _iters_summary(d)}


def stream_record(stream_res, stream_s, stream_d, prom_stream, sessions):
    """The stream arm's record: pairs/s, fnet cache, device steps."""
    advances = stream_d.get("raft_stream_frames_total", 0)
    opens = stream_d.get("raft_stream_opens_total", 0)
    hits = stream_d.get("raft_stream_fnet_cache_hits_total", 0)
    misses = stream_d.get("raft_stream_fnet_cache_misses_total", 0)
    evictions = sum(v for k, v in stream_d.items()
                    if k.startswith("raft_stream_evictions_total"))
    fnet_passes = advances + opens + misses
    step_count = int(stream_d.get("raft_stream_step_seconds_count", 0))
    step_stats = None
    if step_count:
        occ_cnt = stream_d.get("raft_stream_step_occupancy_count", 0)
        step_stats = {
            "count": step_count,
            "mean_ms": round(
                stream_d.get("raft_stream_step_seconds_sum", 0.0)
                / step_count * 1000.0, 3),
            "p95_s": hist_percentile(stream_d, "raft_stream_step_seconds",
                                     0.95),
            "batch_mean": round(
                stream_d.get("raft_stream_step_batch_sum", 0.0)
                / max(1, stream_d.get("raft_stream_step_batch_count", 0)),
                3),
            "occupancy_mean": round(
                stream_d.get("raft_stream_step_occupancy_sum", 0.0)
                / occ_cnt, 3) if occ_cnt else None,
        }
    rec = _video_phase(stream_res, stream_s, stream_d)
    rec.update({
        "sessions": sessions,
        "fnet_cache_hits": int(hits), "fnet_cache_misses": int(misses),
        "evictions": int(evictions),
        "fnet_passes_per_pair": round(fnet_passes / advances, 3)
        if advances else None,
        "encoder_passes_saved_pct": round(
            100.0 * (1.0 - fnet_passes / (2.0 * advances)), 1)
        if advances else None,
        "device_steps": step_stats,
        "slots": {k.split('"')[1]: int(v) for k, v in prom_stream.items()
                  if k.startswith("raft_stream_slots_in_use{")} or None,
    })
    return rec


def run_video_bench(args, host, port, server, config, dev) -> int:
    """The --video arms: cold pairwise then streamed on the SAME frames,
    with per-phase metric diffs; one record, and under --smoke the gates
    (no capture after warm-up, fnet cache hits, lockstep coalescing, no
    lock-order violation)."""
    h, w = args.size
    sessions = args.sessions or args.clients
    seqs = [make_session_frames(h, w, args.frames, seed=100 + i,
                                shift=args.shift)
            for i in range(sessions)]
    pairs = sessions * (args.frames - 1)
    rate = args.rate if args.mode == "open" else None
    print(f"[bench] video: {sessions} session(s) x {args.frames} frames "
          f"({pairs} pairs/arm, {args.shift}px/frame) at {h}x{w}  "
          + (f"open-loop arrivals at {rate:g} sessions/s" if rate
             else "lockstep frames"))
    (cold_res, cold_s, cold_d), (stream_res, stream_s, stream_d), \
        prom_stream = video_phases(host, port, seqs, rate)
    if server is not None:
        server.stop()
    budget_rec, budget_problems = (
        budget_crosscheck(server, prom_stream, dev) if server is not None
        else (None, []))
    stream_rec = stream_record(stream_res, stream_s, stream_d, prom_stream,
                               sessions)
    hits = stream_rec["fnet_cache_hits"]
    step_stats = stream_rec["device_steps"]
    rec = {
        "bench": "serving", "mode": "video",
        "arrivals": (f"open:{args.rate:g}/s" if rate else "lockstep"),
        "sessions": sessions, "frames_per_session": args.frames,
        "pairs_per_arm": pairs, "image_hw": [h, w],
        "shift_px_per_frame": args.shift,
        "iters_policy": (args.iters_policy or "fixed") if not args.url
        else None,
        "pairwise": _video_phase(cold_res, cold_s, cold_d),
        "stream": stream_rec,
        "compile_misses_after_warmup": int(
            prom_stream.get("raft_serving_compile_cache_misses_total", -1)),
    }
    if budget_rec is not None:
        rec["budget"] = budget_rec
    _write(_stamp(rec, dev, config, "serve_bench"), args.out)

    if args.smoke:
        problems = list(budget_problems)
        bad = {k: v for k, v in _statuses(cold_res + stream_res).items()
               if k != "200"}
        if bad:
            problems.append(f"non-200 responses: {bad}")
        if not hits:
            problems.append("no fnet cache hits: streamed advances never "
                            "reused the previous frame's features")
        if not args.url and step_stats is None:
            problems.append("raft_stream_step_seconds never observed")
        if (not args.url and sessions > 1 and rate is None
                and (step_stats or {}).get("batch_mean", 0) <= 1.0):
            problems.append(
                f"stream steps never coalesced across {sessions} lockstep "
                f"sessions (mean step batch "
                f"{(step_stats or {}).get('batch_mean')})")
        if rec["compile_misses_after_warmup"] != 0:
            problems.append(f"{rec['compile_misses_after_warmup']} "
                            f"compile(s) after warmup")
        if not args.url:
            captures = prom_stream.get("raft_serving_xla_recompiles_total")
            if captures is None:
                problems.append("watchdog capture counter missing from "
                                "/metrics (RAFT_TPU_WATCHDOGS not live?)")
            elif captures != 0:
                problems.append(f"{int(captures)} graph capture(s) after "
                                f"warmup while streaming")
            lock_order = prom_stream.get("raft_lock_order_violations_total")
            if lock_order is None:
                problems.append("lock-order validator families missing "
                                "from /metrics (RAFT_TPU_LOCK_WATCH never "
                                "armed for the video smoke)")
            elif lock_order != 0:
                problems.append(f"{int(lock_order)} lock-order "
                                f"violation(s) under coalesced streaming")
        if problems:
            print("[bench] SMOKE FAIL: " + "; ".join(problems))
            return 1
        print("[bench] SMOKE PASS")
    return 0


# ---------------------------------------------------------------------------
# fleet arm (--fleet): replica subprocesses behind the router
# ---------------------------------------------------------------------------

_OCTET_HEADERS = {"Content-Type": "application/octet-stream",
                  "Accept": "application/octet-stream"}

# the cross-executable bar of the JAX tool: a migrated advance and a fresh
# session's replay of the same frames run the same graphs over the same
# weights, a pairwise /v1/flow another one
_MIGRATE_RTOL, _MIGRATE_ATOL = 1e-4, 1e-2


def _stream_rpc(conn, host, port, arrays):
    """One /v1/stream npz round trip on a keep-alive conn; returns
    (status, arrays, replica idx, conn)."""
    try:
        conn.request("POST", "/v1/stream", body=_npz(**arrays),
                     headers=_OCTET_HEADERS)
        resp = conn.getresponse()
        payload = resp.read()
        st = resp.status
        rep = resp.getheader("X-Raft-Replica")
    except Exception:
        conn.close()
        return -1, {}, None, http.client.HTTPConnection(host, port,
                                                        timeout=60)
    out = {}
    if st == 200 and payload:
        with np.load(io.BytesIO(payload)) as z:
            out = {k: z[k] for k in z.files}
    return st, out, (int(rep) if rep is not None else None), conn


def _flow_rpc(host, port, im1, im2):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", "/v1/flow", body=_npz(image1=im1, image2=im2),
                     headers=_OCTET_HEADERS)
        resp = conn.getresponse()
        payload = resp.read()
        st = resp.status
    except Exception:
        return -1, None
    finally:
        conn.close()
    if st != 200:
        return st, None
    with np.load(io.BytesIO(payload)) as z:
        return st, np.asarray(z["flow"])


def _stream_replay_flow(host, port, prev, cur):
    """open(prev) -> advance(cur) -> close on a fresh routed session: the
    graphs a healed session's first advance runs."""
    conn = http.client.HTTPConnection(host, port, timeout=60)
    st, out, _, conn = _stream_rpc(conn, host, port, {"image": prev})
    if st != 200:
        conn.close()
        return st, None
    sid = str(out["session"])
    st, out, _, conn = _stream_rpc(
        conn, host, port, {"op": np.asarray("advance"),
                           "session": np.asarray(sid), "image": cur})
    flow = np.asarray(out["flow"]) if st == 200 and "flow" in out else None
    _stream_rpc(conn, host, port,
                {"op": np.asarray("close"), "session": np.asarray(sid)})
    conn.close()
    return st, flow


def _replica_prom(rep):
    import urllib.request
    try:
        with urllib.request.urlopen(rep.url + "/metrics", timeout=10) as r:
            return parse_prom(r.read().decode())
    except Exception:
        return {}


def _fleet_chaos_drill(args, host, port, manager, fcfg):
    """SIGKILL the replica that live sessions are pinned to, mid-sequence:
    every advance answers 200, a migrated advance equals a fresh session's
    replay of the same frames, the fleet respawns, and the respawn boots
    from the shared engine cache: every key a hit (misses 0), no compiler
    run.  Returns (record, problems)."""
    h, w = args.size
    S = args.sessions or (2 if args.smoke else 4)
    F = min(args.frames, 4) if args.smoke else args.frames
    seqs = [make_session_frames(h, w, F, seed=100 + i, shift=args.shift)
            for i in range(S)]
    conns = [http.client.HTTPConnection(host, port, timeout=60)
             for _ in range(S)]
    problems = []
    sids, pinned = [], []
    for i in range(S):
        st, out, rep, conns[i] = _stream_rpc(conns[i], host, port,
                                             {"image": seqs[i][0]})
        if st != 200:
            return ({"error": f"session open {i} returned {st}"},
                    [f"chaos drill could not open session {i} ({st})"])
        sids.append(str(out["session"]))
        pinned.append(rep)

    statuses = {}

    def advance(i, t):
        st, out, rep, conns[i] = _stream_rpc(
            conns[i], host, port,
            {"op": np.asarray("advance"), "session": np.asarray(sids[i]),
             "image": seqs[i][t]})
        statuses[str(st)] = statuses.get(str(st), 0) + 1
        return st, out, rep

    for i in range(S):
        advance(i, 1)
    victim = pinned[0]
    t_kill = time.monotonic()
    manager.kill(victim)
    print(f"[bench] chaos: killed replica {victim} with {S} live "
          f"session(s), {pinned.count(victim)} pinned to it")
    migrated_to = {}
    recovery_s = None
    replay_match = replay_diff = pair_match = pair_diff = None
    for t in range(2, F):
        for i in range(S):
            st, out, rep = advance(i, t)
            if st != 200 or not bool(out.get("migrated")) \
                    or i in migrated_to:
                continue
            migrated_to[i] = rep
            if recovery_s is None:
                recovery_s = time.monotonic() - t_kill
            if replay_match is None and "flow" in out:
                mflow = np.asarray(out["flow"])
                rst, rflow = _stream_replay_flow(
                    host, port, seqs[i][t - 1], seqs[i][t])
                if rst == 200 and rflow is not None:
                    replay_diff = float(np.max(np.abs(mflow - rflow)))
                    replay_match = bool(np.allclose(
                        mflow, rflow, rtol=_MIGRATE_RTOL,
                        atol=_MIGRATE_ATOL))
                fst, pflow = _flow_rpc(host, port, seqs[i][t - 1],
                                       seqs[i][t])
                if fst == 200:
                    pair_diff = float(np.max(np.abs(mflow - pflow)))
                    pair_match = bool(np.allclose(
                        mflow, pflow, rtol=_MIGRATE_RTOL,
                        atol=_MIGRATE_ATOL))
    for i in range(S):
        _stream_rpc(conns[i], host, port,
                    {"op": np.asarray("close"),
                     "session": np.asarray(sids[i])})
        conns[i].close()
    healed_s = None
    t0 = time.monotonic()
    while time.monotonic() - t0 < fcfg.spawn_timeout_s:
        if manager.ready_count() >= manager.desired:
            healed_s = round(time.monotonic() - t0, 1)
            break
        time.sleep(0.5)
    respawn_cache = None
    if healed_s is not None:
        respawn = max(manager.replicas(), key=lambda r: r.idx)
        manager.poll_once()
        respawn_cache = (respawn.health or {}).get("engine_cache")
        if not respawn_cache:
            problems.append(f"respawned replica {respawn.idx} reports no "
                            f"engine_cache on /healthz")
        elif (respawn_cache.get("misses", 1) != 0
              or not respawn_cache.get("hits")
              or respawn_cache.get("compiler_runs")):
            problems.append(
                f"respawned replica {respawn.idx} did not boot from the "
                f"shared engine cache (hits={respawn_cache.get('hits')} "
                f"misses={respawn_cache.get('misses')} mismatches="
                f"{respawn_cache.get('mismatches')} compiler_runs="
                f"{respawn_cache.get('compiler_runs')})")
    failures = sum(v for k, v in statuses.items() if k != "200")
    if failures:
        problems.append(f"{failures} innocent stream failure(s) during the "
                        f"replica kill (statuses {statuses})")
    if not migrated_to:
        problems.append("no session migrated after the kill")
    if replay_match is False:
        problems.append(f"migrated flow != fresh-session replay of the "
                        f"same frames (max abs diff {replay_diff:.4g})")
    elif migrated_to and replay_match is None:
        problems.append("migrated advance carried no flow to compare")
    if args.smoke and pair_match is False:
        problems.append(f"migrated flow != routed pairwise flow "
                        f"(max abs diff {pair_diff:.4g})")
    window_s = fcfg.health_poll_s + fcfg.health_timeout_s
    if recovery_s is not None and recovery_s > window_s:
        problems.append(f"first healed advance took {recovery_s:.1f}s "
                        f"(> one poll window {window_s:.1f}s)")
    if healed_s is None:
        problems.append("fleet never respawned back to desired size")
    rec = {
        "sessions": S, "frames": F, "victim_replica": victim,
        "pinned_to_victim": pinned.count(victim),
        "migrated_sessions": len(migrated_to),
        "advance_statuses": statuses,
        "recovery_s": round(recovery_s, 3) if recovery_s else None,
        "poll_window_s": window_s,
        "flow_matches_replay": replay_match,
        "max_replay_diff": replay_diff,
        "flow_matches_pairwise": pair_match,
        "max_pairwise_diff": pair_diff,
        "respawned_in_s": healed_s,
        "respawn_engine_cache": respawn_cache,
        "restarts": manager.restarts,
    }
    return rec, problems


def _fleet_hot_swap(args, host, port, manager, updater, model, out_dir,
                    flow_body):
    """Roll new weights (the model's state dict x 1.001, written with the
    port's npz writer) across the fleet while closed-loop load runs
    through the router: no non-200, requests served during the roll, no
    compile-cache miss on any replica.  Returns (record, problems)."""
    import torch

    from ..convert.weights import save_params_npz

    state2 = {k: (v * 1.001).to(v.dtype) if v.is_floating_point() else v
              for k, v in model.state_dict().items()}
    weights_v2 = os.path.join(out_dir, "weights_v2.npz")
    with torch.no_grad():
        save_params_npz(state2, weights_v2)
    with open(weights_v2, "rb") as f:
        body2 = f.read()
    before = {r.idx: _replica_prom(r) for r in manager.routable()}
    stop = threading.Event()
    loads, lock = [], threading.Lock()

    def loader():
        conn = http.client.HTTPConnection(host, port, timeout=60)
        while not stop.is_set():
            try:
                conn.request("POST", "/v1/flow", body=flow_body,
                             headers=_OCTET_HEADERS)
                resp = conn.getresponse()
                resp.read()
                st = resp.status
            except Exception:
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=60)
                st = -1
            with lock:
                loads.append((st, time.monotonic()))
        conn.close()

    workers = [threading.Thread(target=loader, daemon=True)
               for _ in range(max(2, args.clients // 2))]
    for t in workers:
        t.start()
    time.sleep(0.5)
    t_roll0 = time.monotonic()
    try:
        results = updater.roll(body2, tag="bench-v2")
    finally:
        t_roll1 = time.monotonic()
        time.sleep(0.5)
        stop.set()
        _join(workers, 120.0)
    after = {r.idx: _replica_prom(r) for r in manager.routable()}
    miss = "raft_serving_compile_cache_misses_total"
    miss_delta = {str(i): int(after[i].get(miss, 0) - before[i].get(miss, 0))
                  for i in after if i in before}
    with lock:
        snapshot = list(loads)
    bad = [st for st, _ in snapshot if st != 200]
    served_during = sum(1 for st, t in snapshot
                        if st == 200 and t_roll0 <= t <= t_roll1)
    roll_statuses = [r["status"] for r in results]
    problems = []
    if bad:
        problems.append(f"{len(bad)} dropped/failed request(s) during the "
                        f"hot-swap roll")
    if not results or any(s != "reloaded" for s in roll_statuses):
        problems.append(f"hot-swap roll did not reload every replica: "
                        f"{roll_statuses}")
    if served_during == 0:
        problems.append("no request served during the roll window")
    if any(d != 0 for d in miss_delta.values()):
        problems.append(f"compile-cache misses during the hot-swap (per "
                        f"replica: {miss_delta})")
    rec = {"rolled": roll_statuses,
           "weights": [r.get("weights") for r in results],
           "roll_s": round(t_roll1 - t_roll0, 3),
           "load_requests": len(snapshot), "load_failures": len(bad),
           "served_during_roll": served_during,
           "compile_miss_delta": miss_delta}
    return rec, problems


def scaling_gated(args, dev) -> bool:
    """Whether the fleet's >= 1.7x scaling is a gate: a full run with at
    least two replicas, each on a device of its own — a CPU slice of its
    own on the CPU (replicas pinned to disjoint cores, the JAX rule);
    never on one card, where the port's replicas time-slice cuda:0."""
    if args.smoke or args.replicas < 2:
        return False
    if dev.type == "cpu":
        return (os.cpu_count() or 1) >= args.replicas
    return False


def run_fleet_bench(args, dev) -> int:
    """--fleet: spawn the replica subprocesses behind the in-process router
    and bench through it: capacity scaling (one routable replica, then
    all), the replica-kill drill (--chaos), the rolling hot-swap."""
    os.environ.setdefault("RAFT_TPU_LOCK_WATCH", "1")
    os.environ.setdefault("RAFT_TPU_WATCHDOGS", "1")

    import torch

    from ..convert.weights import save_params_npz
    from ..fleet import (FleetConfig, FleetRouter, ReplicaManager,
                         RollingUpdater)
    from ..models.raft import init_raft_torch
    from ..telemetry import events as tlm_events
    from ..telemetry.watchdogs import lock_validator, lock_watch_enabled

    h, w = args.size
    bucket_spec = args.buckets or f"{-(-h // 8) * 8}x{-(-w // 8) * 8}"
    config = _config(args)
    # the replicas' weights: --load, or the seeded random init drawn on
    # the CPU in float32 (what -m serve_fleet writes)
    model = (_load(args, config, torch.device("cpu")) if args.load else
             init_raft_torch(config, device="cpu", dtype=torch.float32))
    out_dir = tempfile.mkdtemp(prefix="raft_fleet_bench_")
    weights_v1 = os.path.join(out_dir, "weights_v1.npz")
    save_params_npz(model.state_dict(), weights_v1)
    sessions = max((args.sessions or 4) + 2, 4)
    base = ["--load", weights_v1, "--buckets", bucket_spec,
            "--max-batch", str(args.max_batch),
            "--max-wait-ms", str(args.max_wait_ms),
            "--queue-depth", str(args.queue_depth),
            "--deadline-ms", str(args.deadline_ms),
            "--max-sessions", str(max(args.max_sessions, sessions)),
            "--corr-impl", args.corr_impl, "--gru-impl", args.gru_impl,
            "--engine-cache-dir",
            args.engine_cache_dir or os.path.join(out_dir, "engine-cache")]
    if args.quant:
        base += ["--quant", args.quant]
    if args.small:
        base.append("--small")
    if args.iters:
        base += ["--iters", str(args.iters)]
    if args.iters_policy:
        base += ["--iters-policy", args.iters_policy]
    if args.trace_sample is not None:
        base += ["--trace-sample", str(args.trace_sample)]
    for flag, value in _serve_knobs(args).items():
        base += ["--" + flag.replace("_", "-"), str(value)]
    if dev.type == "cpu":
        base.append("--cpu")
    fcfg = FleetConfig(
        replicas=args.replicas, min_replicas=1,
        max_replicas=args.replicas, host="127.0.0.1", port=0,
        health_poll_s=1.0, pin_cpus=dev.type == "cpu",
        trace_sample=(1.0 if args.trace_sample is None
                      else args.trace_sample))
    run_log = tlm_events.start_run(out_dir, mode="serve_bench_fleet",
                                   config=config)
    tlm_events.set_current(run_log)
    manager = ReplicaManager(fcfg, out_dir, base_args=base, run_log=run_log)
    router = FleetRouter(fcfg, manager, out_dir=out_dir, verbose=False,
                         run_log=run_log)
    updater = RollingUpdater(manager, metrics=router.metrics,
                             run_log=run_log)
    router.updater = updater
    print(f"[bench] spawning fleet of {args.replicas} on {dev} ...")
    t0 = time.monotonic()
    problems = []
    chaos_rec = swap_rec = None
    router_prom, replica_prom = {}, {}
    pps_one = pps_fleet = ratio = None
    lat = []
    try:
        manager.start()
        router.start()
        host, port = fcfg.host, router.port
        ready_s = round(time.monotonic() - t0, 1)
        print(f"[bench] fleet ready in {ready_s}s  router={router.url}  "
              f"buckets={bucket_spec}")
        body = _pair_body(h, w)
        run_closed(host, port, body, min(args.clients, 4),
                   max(2 * args.replicas, 4))
        reps = sorted(manager.routable(), key=lambda r: r.idx)
        for r in reps[1:]:
            r.updating = True
        res_one, el_one = run_closed(host, port, body, args.clients,
                                     args.requests)
        for r in reps[1:]:
            r.updating = False
        res_fleet, el_fleet = run_closed(host, port, body, args.clients,
                                         args.requests)
        ok_one = sum(1 for st, _ in res_one if st == 200)
        ok_fleet = sum(1 for st, _ in res_fleet if st == 200)
        pps_one = round(ok_one / el_one, 3) if el_one else 0.0
        pps_fleet = round(ok_fleet / el_fleet, 3) if el_fleet else 0.0
        ratio = round(pps_fleet / pps_one, 3) if pps_one else None
        fails = len(res_one) - ok_one + len(res_fleet) - ok_fleet
        if fails:
            problems.append(f"{fails} non-200(s) in the scaling phases")
        lat = sorted(l for st, l in res_fleet if st == 200)
        print(f"[bench] scaling: 1 replica {pps_one} pairs/s, "
              f"{args.replicas} replicas {pps_fleet} pairs/s (x{ratio})")
        if args.chaos:
            chaos_rec, chaos_problems = _fleet_chaos_drill(
                args, host, port, manager, fcfg)
            problems.extend(chaos_problems)
        swap_rec, swap_problems = _fleet_hot_swap(
            args, host, port, manager, updater, model, out_dir, body)
        problems.extend(swap_problems)
        router_prom = scrape(host, port)
        replica_prom = {r.idx: _replica_prom(r) for r in manager.routable()}
    finally:
        router.stop()
        manager.stop()
    for idx, prom in sorted(replica_prom.items()):
        misses = prom.get("raft_serving_compile_cache_misses_total")
        if misses:
            problems.append(f"replica {idx}: {int(misses)} compile "
                            f"miss(es) after warmup")
        lockv = prom.get("raft_lock_order_violations_total")
        if lockv is None:
            problems.append(f"replica {idx}: lock validator families "
                            f"missing from /metrics (watch never armed)")
        elif lockv:
            problems.append(f"replica {idx}: {int(lockv)} lock-order "
                            f"violation(s)")
    if not lock_watch_enabled():
        problems.append("router lock watch never armed")
    elif lock_validator().counts()["order_violations"]:
        problems.append(f"{lock_validator().counts()['order_violations']} "
                        f"router lock-order violation(s)")
    gated = scaling_gated(args, dev)
    if gated and ratio is not None and ratio < 1.7:
        problems.append(f"fleet-of-{args.replicas} scaled only x{ratio} "
                        f"over one replica (< 1.7)")
    elif not args.smoke and args.replicas >= 2 and not gated:
        print(f"[bench] note: the {args.replicas} replicas share "
              f"{'the card' if dev.type == 'cuda' else 'too few cores'}; "
              f"ratio x{ratio} recorded, not gated")
    pct = (lambda q: float(np.percentile(lat, q)) * 1000) if lat \
        else (lambda q: float("nan"))
    rec = {
        "bench": "serving_fleet", "replicas": args.replicas,
        "run_dir": out_dir, "image_hw": [h, w], "clients": args.clients,
        "requests_per_phase": args.requests,
        "pinned_cpus": fcfg.pin_cpus, "host_cores": os.cpu_count(),
        "scaling": {"one_replica_pairs_per_sec": pps_one,
                    "fleet_pairs_per_sec": pps_fleet, "ratio": ratio,
                    "gated": gated},
        "latency_ms": {"p50": round(pct(50), 2), "p95": round(pct(95), 2)},
        "router": {
            "migrations": int(router_prom.get(
                "raft_fleet_migrations_total", 0)),
            "hot_swaps": int(router_prom.get("raft_fleet_hot_swaps_total",
                                             0)),
            "retries": int(router_prom.get("raft_fleet_retries_total", 0)),
            "replica_restarts": manager.restarts,
        },
    }
    if chaos_rec is not None:
        rec["chaos"] = chaos_rec
    if swap_rec is not None:
        rec["hot_swap"] = swap_rec
    _write(_stamp(rec, dev, config, "serve_bench_fleet"), args.out)
    if problems:
        print("[bench] " + ("SMOKE FAIL: " if args.smoke
                            else "FLEET FAIL: ") + "; ".join(problems))
        return 1
    if args.smoke:
        print("[bench] SMOKE PASS")
    return 0


def run_coldstart_bench(args, dev) -> int:
    """--coldstart: the engine-cache boot race.  Two in-process boots of
    the same server config against one cache directory: COLD (the
    directory empty: the kernels are built into it, every key is warmed
    and its entry written) and CACHED (a new server on the filled
    directory).  Each times ``server.start()`` and its first 200, and
    counts its graph captures with a watch of its own.

    Gates (smoke and full): the cached boot is fully cache-warm (misses 0,
    hits == the cold boot's saves, no digest mismatch), runs no compiler,
    answers 200, and — where the cold boot ran the compiler, which is what
    the cache saves (the card) — boots faster than the cold one; int8 slot
    rows are >= 2x denser than f32.  A CUDA graph and cuDNN's choices do
    not serialize, so the cached boot still captures every key: the JAX
    tool's ">= 5x faster first 200" is recorded, not gated."""
    import dataclasses

    from .. import _build
    from ..lint import budget as budget_lib
    from ..serving import FlowServer, ServeConfig, parse_buckets
    from ..serving.aot_cache import cache_identity
    from ..telemetry.watchdogs import RecompileWatch

    h, w = args.size
    bucket_spec = args.buckets or f"{-(-h // 8) * 8}x{-(-w // 8) * 8}"
    config = _config(args)
    if args.quant:
        config = dataclasses.replace(config, quant=args.quant)
    model = _load(args, config, dev)
    cache_dir = args.engine_cache_dir
    if cache_dir is None:
        cache_dir = tempfile.mkdtemp(prefix="raft_coldstart_cache_")
    elif os.path.isdir(cache_dir) and os.listdir(cache_dir):
        print(f"ERROR: --coldstart needs an EMPTY cache dir for the cold "
              f"phase; {cache_dir!r} has entries")
        return 2

    def make_sconfig():
        return ServeConfig(
            buckets=parse_buckets(bucket_spec), max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, queue_depth=args.queue_depth,
            default_deadline_ms=args.deadline_ms, port=0,
            iters_policy=args.iters_policy,
            max_sessions=args.max_sessions,
            trace_sample=(1.0 if args.trace_sample is None
                          else args.trace_sample),
            engine_cache_dir=cache_dir, **_serve_knobs(args))

    body = _pair_body(h, w)

    def boot(tag):
        watch = RecompileWatch(log_fn=lambda *_: None).install()
        runs0 = _build.COMPILER_RUNS
        sc = make_sconfig()
        server = FlowServer(config, model, sc, iters=args.iters)
        try:
            t0 = time.monotonic()
            server.start()
            warmup_s = time.monotonic() - t0
            warmup_captures = watch.compiles
            res, _ = run_closed(sc.host, server.port, body, 1, 1)
            first_200_s = time.monotonic() - t0
            first_status = res[0][0] if res else None
            drive, el = run_closed(sc.host, server.port, body, args.clients,
                                   args.requests)
            ok = sum(1 for st, _ in drive if st == 200)
            stats = server.engine_cache.stats.as_dict()
            rec = {
                "warmup_s": round(warmup_s, 3),
                "first_200_s": round(first_200_s, 3),
                "first_status": first_status,
                "keys": server.engine_executables(),
                "warmup_loaded": server.engine.warmup_loaded,
                "captures_warmup": warmup_captures,
                "captures_total": watch.compiles,
                "compiler_runs": _build.COMPILER_RUNS - runs0,
                "boot": dict(getattr(server.engine, "boot", {}) or {}),
                "drive_ok": ok, "drive_total": len(drive),
                "drive_pairs_per_sec": round(ok / el, 3) if el else 0.0,
                "cache": stats,
            }
        finally:
            server.stop()
            watch.remove()
        print(f"[bench] {tag}: first 200 in {rec['first_200_s']}s "
              f"({rec['captures_total']} capture(s), {rec['compiler_runs']} "
              f"compiler run(s), {rec['warmup_loaded']}/{rec['keys']} "
              f"key(s) hit, hits={stats['hits']} misses={stats['misses']})")
        return rec

    print(f"[bench] coldstart race: buckets={bucket_spec} "
          f"quant={config.quant} max_sessions={args.max_sessions} "
          f"cache={cache_dir} on {dev}")
    cold = boot("cold  ")
    cached = boot("cached")
    speedup = (round(cold["first_200_s"] / cached["first_200_s"], 2)
               if cached["first_200_s"] else None)
    kind = device_kind(dev)
    sc = make_sconfig()
    rep_f32 = budget_lib.analyze(dataclasses.replace(config, quant="none"),
                                 sc, device_kind=kind)
    rep_int8 = budget_lib.analyze(dataclasses.replace(config, quant="int8"),
                                  sc, device_kind=kind)
    psb_f = rep_f32["totals"]["per_session_bytes"]
    psb_q = rep_int8["totals"]["per_session_bytes"]
    density = {
        "per_session_bytes_f32": psb_f, "per_session_bytes_int8": psb_q,
        "density_ratio": round(psb_f / psb_q, 2) if psb_q else None,
        "max_sessions_fit_f32": rep_f32["totals"]["max_sessions_fit"],
        "max_sessions_fit_int8": rep_int8["totals"]["max_sessions_fit"],
        "device_kind": kind,
    }
    problems = []
    if cold["cache"]["saves"] == 0:
        problems.append("cold boot wrote no cache entry")
    if cached["cache"]["misses"] != 0 or not cached["cache"]["hits"]:
        problems.append(
            f"cached boot was not fully cache-warm (hits="
            f"{cached['cache']['hits']} misses={cached['cache']['misses']})")
    if cached["cache"]["hits"] != cold["cache"]["saves"]:
        problems.append(
            f"cached hits ({cached['cache']['hits']}) != cold saves "
            f"({cold['cache']['saves']}) — grid drifted between boots")
    if cached["cache"].get("mismatches"):
        problems.append(f"cached boot: {cached['cache']['mismatches']} "
                        f"probe digest mismatch(es)")
    if cached["compiler_runs"]:
        problems.append(f"cached boot ran the compiler "
                        f"{cached['compiler_runs']} time(s)")
    if cached["captures_total"] != cold["captures_total"]:
        problems.append(f"cached boot captured {cached['captures_total']} "
                        f"graph(s), the cold one {cold['captures_total']}")
    if cold["first_status"] != 200 or cached["first_status"] != 200:
        problems.append(f"first request not 200 (cold="
                        f"{cold['first_status']} cached="
                        f"{cached['first_status']})")
    bad = (cold["drive_total"] - cold["drive_ok"]
           + cached["drive_total"] - cached["drive_ok"])
    if bad:
        problems.append(f"{bad} non-200(s) in the serving drives")
    faster_gated = cold["compiler_runs"] > 0
    if faster_gated and not cached["first_200_s"] < cold["first_200_s"]:
        problems.append(f"cached boot ({cached['first_200_s']} s to its "
                        f"first 200) not faster than the cold one "
                        f"({cold['first_200_s']} s)")
    if density["density_ratio"] is None or density["density_ratio"] < 2.0:
        problems.append(f"int8 session density only "
                        f"x{density['density_ratio']} over f32 (< 2x)")
    fit_q = density["max_sessions_fit_int8"]
    if fit_q is not None and fit_q < 2 * args.max_sessions:
        problems.append(f"int8 rows fit only {fit_q} sessions "
                        f"(< 2x --max-sessions={args.max_sessions})")
    rec = {
        "bench": "serving_coldstart", "image_hw": [h, w],
        "buckets": bucket_spec, "quant": config.quant,
        "iters_policy": args.iters_policy,
        "max_sessions": args.max_sessions, "cache_dir": cache_dir,
        "cache_identity": cache_identity(
            config, model, args.cudnn or ServeConfig.cudnn),
        "cold": cold, "cached": cached,
        "first_200_speedup": speedup,
        "faster_gated": faster_gated,
        "warmup_speedup": (round(cold["warmup_s"] / cached["warmup_s"], 2)
                           if cached["warmup_s"] else None),
        "density": density,
    }
    _write(_stamp(rec, dev, config, "serve_bench_coldstart"), args.out)
    if problems:
        print("[bench] " + ("SMOKE FAIL: " if args.smoke
                            else "COLDSTART FAIL: ") + "; ".join(problems))
        return 1
    print(f"[bench] coldstart: cached boot {speedup}x faster, 0 compiler "
          f"runs, int8 density x{density['density_ratio']}"
          + (" — SMOKE PASS" if args.smoke else ""))
    return 0


def _mixed_load(host, port, bodies, clients, total, mode, rate, seed=0):
    """``total`` pairwise requests cycling over one body per resolution,
    open or closed loop."""
    results, lock = [], threading.Lock()
    jobs = _queue.Queue()

    def worker():
        c = Client(host, port, b"", results, lock)
        while True:
            try:
                item = jobs.get(timeout=JOIN_S)
            except _queue.Empty:
                return
            if item is None:
                return
            c.body = item
            c.one()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    rng = np.random.RandomState(seed)
    t0 = time.monotonic()
    next_t = t0
    for i in range(total):
        if mode == "open":
            next_t += rng.exponential(1.0 / rate)
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        jobs.put(bodies[i % len(bodies)])
    for _ in threads:
        jobs.put(None)
    _join(threads)
    return results, time.monotonic() - t0


def run_ragged_bench(args, dev) -> int:
    """--ragged-sweep: the same mixed-resolution load (pairwise requests
    cycling over every declared resolution, then one stream per
    resolution in lockstep) through a dense server and a ragged one;
    --smoke gates the key count shrinking by the bucket count, mixed
    coalescing no worse than dense, ragged stream steps coalescing across
    resolutions, no capture after warm-up, no lock-order violation."""
    os.environ.setdefault("RAFT_TPU_LOCK_WATCH", "1")
    from ..serving import FlowServer, ServeConfig, parse_buckets

    bucket_spec = args.buckets or ("16x24,24x32,32x48" if args.small
                                   else "48x64,72x96,96x128")
    buckets = tuple(parse_buckets(bucket_spec))
    if len(buckets) < 3:
        print("ERROR: --ragged-sweep needs >= 3 declared buckets")
        return 2
    config = _config(args)
    model = _load(args, config, dev)
    rng = np.random.RandomState(0)
    bodies, body_hw = [], []
    for bh, bw in buckets:
        h, w = bh - 2, bw - 2
        im1 = rng.rand(h, w, 3).astype(np.float32)
        im2 = np.clip(im1 + rng.randn(h, w, 3).astype(np.float32) * 0.05,
                      0, 1)
        bodies.append(_npz(image1=im1, image2=im2))
        body_hw.append([h, w])
    sessions = args.sessions or len(buckets)
    seqs = [make_session_frames(buckets[i % len(buckets)][0] - 2,
                                buckets[i % len(buckets)][1] - 2,
                                args.frames, seed=100 + i, shift=args.shift)
            for i in range(sessions)]
    pair_total = args.requests
    print(f"[bench] ragged sweep: {len(buckets)} resolutions "
          f"({bucket_spec}), {pair_total} mixed pairwise requests "
          f"({args.mode} loop), {sessions} stream(s) x {args.frames} frames")

    def one_arm(ragged):
        sconfig = ServeConfig(
            buckets=buckets, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, queue_depth=args.queue_depth,
            default_deadline_ms=args.deadline_ms, port=0,
            max_sessions=sessions, trace_sample=0.0,
            history_interval_s=0.0, ragged=ragged, **_serve_knobs(args))
        server = FlowServer(config, model, sconfig, iters=args.iters)
        try:
            t0 = time.monotonic()
            server.start()
            warm_s = time.monotonic() - t0
            host, port = sconfig.host, server.port
            keys = server.engine.executables
            print(f"[bench] {'ragged' if ragged else 'dense'} arm: {keys} "
                  f"keys warmed in {warm_s:.1f}s")
            prom0 = scrape(host, port)
            pair_res, pair_s = _mixed_load(host, port, bodies, args.clients,
                                           pair_total, args.mode, args.rate)
            prom1 = scrape(host, port)
            stream_res, stream_s = run_video(host, port, seqs, stream=True)
            prom2 = scrape(host, port)
        finally:
            server.stop()
        pair_d, stream_d = diff_prom(prom0, prom1), diff_prom(prom1, prom2)

        def phase(results, elapsed, d):
            ok = sum(1 for st, _ in results if st == 200)
            occ_cnt = d.get("raft_serving_batch_occupancy_count", 0)
            bs_cnt = d.get("raft_serving_batch_size_count", 0)
            waste_cnt = d.get("raft_batch_padding_waste_ratio_count", 0)
            return {
                "pairs_per_sec": round(ok / elapsed, 3) if elapsed else 0.0,
                "ok": ok, "elapsed_s": round(elapsed, 3),
                "device_calls": int(bs_cnt),
                "batch_size_mean": round(
                    d.get("raft_serving_batch_size_sum", 0.0) / bs_cnt, 3)
                if bs_cnt else None,
                "batch_occupancy_mean": round(
                    d.get("raft_serving_batch_occupancy_sum", 0.0)
                    / occ_cnt, 3) if occ_cnt else None,
                "padding_waste_mean": round(
                    d.get("raft_batch_padding_waste_ratio_sum", 0.0)
                    / waste_cnt, 3) if waste_cnt else None,
            }

        step_cnt = stream_d.get("raft_stream_step_batch_count", 0)
        return {
            "keys": keys, "warmup_s": round(warm_s, 1),
            "pairwise": phase(pair_res, pair_s, pair_d),
            "stream": dict(
                phase(stream_res, stream_s, stream_d),
                step_batch_mean=round(
                    stream_d.get("raft_stream_step_batch_sum", 0.0)
                    / step_cnt, 3) if step_cnt else None),
            "compile_misses_after_warmup": int(prom2.get(
                "raft_serving_compile_cache_misses_total", -1)),
            "lock_order_violations": (
                int(prom2["raft_lock_order_violations_total"])
                if "raft_lock_order_violations_total" in prom2 else None),
        }

    dense = one_arm(False)
    ragged = one_arm(True)
    rec = {
        "bench": "serving_ragged", "mode": args.mode,
        "rate_rps": args.rate if args.mode == "open" else None,
        "buckets": [list(b) for b in buckets], "image_hw": body_hw,
        "clients": args.clients, "requests": pair_total,
        "sessions": sessions, "frames": args.frames,
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
        "dense": dense, "ragged": ragged,
        "key_reduction": round(dense["keys"] / ragged["keys"], 2),
    }
    _write(_stamp(rec, dev, config, "serve_bench"), args.out)
    if args.smoke:
        problems = []
        if rec["key_reduction"] < len(buckets):
            problems.append(f"key count shrank only {rec['key_reduction']}x "
                            f"(expected {len(buckets)}x)")
        for name, arm in (("dense", dense), ("ragged", ragged)):
            if arm["compile_misses_after_warmup"] != 0:
                problems.append(
                    f"{arm['compile_misses_after_warmup']} compile(s) after "
                    f"warmup in the {name} arm")
            if arm["lock_order_violations"] is None:
                problems.append(f"lock-order validator families missing "
                                f"from the {name} arm's /metrics")
            elif arm["lock_order_violations"]:
                problems.append(f"{arm['lock_order_violations']} lock-order "
                                f"violation(s) in the {name} arm")
            if not arm["pairwise"]["ok"] or not arm["stream"]["ok"]:
                problems.append(f"failed requests in the {name} arm")
        width = ragged["stream"]["step_batch_mean"]
        if width is None or width <= 1.0:
            problems.append(f"ragged stream steps never coalesced across "
                            f"resolutions (mean width {width})")
        d_bs = dense["pairwise"]["batch_size_mean"]
        r_bs = ragged["pairwise"]["batch_size_mean"]
        if d_bs is not None and r_bs is not None and r_bs < d_bs - 0.05:
            problems.append(f"mixed-resolution coalescing ({r_bs} "
                            f"requests/call) fell below the same-bucket "
                            f"baseline ({d_bs})")
        if ragged["pairwise"]["padding_waste_mean"] is None:
            problems.append("padding-waste histogram never filled in the "
                            "ragged arm")
        if problems:
            print("[bench] SMOKE FAIL: " + "; ".join(problems))
            return 1
        print(f"[bench] ragged sweep: {dense['keys']} -> {ragged['keys']} "
              f"keys, stream width {width}, pairwise coalescing {d_bs} -> "
              f"{r_bs} requests/call — SMOKE PASS")
    return 0


def _config(args):
    from ..config import RAFTConfig
    if args.gru_impl is None:
        args.gru_impl = "xla" if args.small else "pallas"
    kw = dict(corr_impl=args.corr_impl, gru_impl=args.gru_impl)
    if args.small:
        return RAFTConfig.small_model(iters=args.iters or 12, **kw)
    return RAFTConfig.full(iters=args.iters or 12, **kw)


def _serve_knobs(args) -> dict:
    """The ServeConfig knobs given on the command line (the rest keep
    ServeConfig's defaults)."""
    return {k: getattr(args, k) for k in ("cudnn",)
            if getattr(args, k) is not None}


def _load(args, config, dev):
    """The served model: ``--load``'s weights (any format the CLI reads),
    else seeded random ones (seed 0), on ``dev``."""
    import torch

    from ..cli import load_state_dict
    from ..models.raft import (RAFT, cast_encoder_weights, compute_dtype,
                               init_raft_torch)
    if args.load:
        model = RAFT(config)
        model.load_state_dict(load_state_dict(args.load, False), strict=True)
        model = model.to(dev, compute_dtype(config)).eval()
    else:
        model = init_raft_torch(config, torch.Generator().manual_seed(0),
                                device=dev)
    return cast_encoder_weights(model, config)


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.serve_bench",
        description="serving load generator for the port")
    p.add_argument("--url", default=None,
                   help="bench an external server (default: in-process)")
    p.add_argument("--mode", default="closed", choices=["closed", "open"])
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=20.0,
                   help="open-loop arrival rate, req/s")
    p.add_argument("--size", type=int, nargs=2, default=(96, 128),
                   metavar=("H", "W"), help="client image size")
    p.add_argument("--buckets", default=None, metavar="HxW,HxW",
                   help="default: the --size rounded up to /8")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--queue-depth", type=int, default=64)
    p.add_argument("--deadline-ms", type=float, default=10000.0)
    p.add_argument("--small", action="store_true", default=None)
    p.add_argument("--corr-impl", default="pallas",
                   choices=["dense", "blockwise", "pallas"],
                   help="'pallas' runs the CUDA lookup kernels (default)")
    p.add_argument("--gru-impl", default=None, choices=["xla", "pallas"],
                   help="'pallas' runs the CUDA GRU kernel (the full "
                        "model's default); raft-small's ConvGRU is 'xla'")
    p.add_argument("--load", default=None,
                   help="checkpoint for the in-process server (any format "
                        "the CLI's --load reads); default: seeded random "
                        "weights (timing-only numbers)")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--iters-policy", default=None, metavar="POLICY",
                   help="'fixed' or 'converge:eps[:min_iters]'")
    p.add_argument("--trace-sample", type=float, default=None, metavar="P",
                   help="request-trace retention fraction (default 1; 0 "
                        "disables tracing)")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU (default: the card)")
    p.add_argument("--out", default=default_out("serve_bench.jsonl"),
                   help="JSON-lines record file ('' to skip)")
    p.add_argument("--video", action="store_true",
                   help="streaming arm: per-session sequences through "
                        "/v1/flow, then /v1/stream")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--sessions", type=int, default=None)
    p.add_argument("--shift", type=int, default=6)
    p.add_argument("--max-sessions", type=int, default=64)
    p.add_argument("--smoke", action="store_true",
                   help="fast path: raft-small at 32x48, a few requests, "
                        "every gate")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="self-healing drill (serving/faults.py spec); with "
                        "--fleet the drill is a replica SIGKILL")
    p.add_argument("--fleet", action="store_true",
                   help="replica subprocesses behind the router")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--ragged-sweep", action="store_true",
                   help="dense vs ragged servers on a mixed-resolution load")
    p.add_argument("--coldstart", action="store_true",
                   help="engine-cache boot race: cold vs cached boot")
    p.add_argument("--engine-cache-dir", default=None, metavar="DIR")
    p.add_argument("--quant", default=None,
                   choices=["none", "int8", "bf16w", "int8+bf16w"])
    p.add_argument("--cudnn", default=None, choices=["benchmark",
                                                     "heuristic"],
                   help="the servers' cuDNN algorithm choice (default: "
                        "ServeConfig's)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, clash in (("chaos", ("url", "video")),
                        ("fleet", ("url", "video")),
                        ("coldstart", ("url", "video", "chaos", "fleet")),
                        ("ragged_sweep", ("url", "video", "chaos", "fleet",
                                          "coldstart"))):
        if getattr(args, flag) and any(getattr(args, c) for c in clash):
            print(f"ERROR: --{flag.replace('_', '-')} excludes "
                  + " / ".join(f"--{c}" for c in clash))
            return 2
    if args.smoke:
        args.small = True
        args.iters = args.iters or 2
        if args.cudnn is None:
            args.cudnn = SMOKE_CUDNN
        args.size = (32, 48)
        args.requests = min(args.requests, 64 if args.chaos else 24)
        args.clients = min(args.clients, 4)
        if args.video:
            args.frames = min(args.frames, 4)
            args.sessions = args.sessions or 2
            os.environ.setdefault("RAFT_TPU_LOCK_WATCH", "1")
        if args.iters_policy is None and not args.url \
                and not args.ragged_sweep:
            args.iters_policy = "converge:1e-2"
        os.environ["RAFT_TPU_WATCHDOGS"] = "1"
    dev = resolve_device(args.cpu)

    if args.coldstart:
        if args.smoke:
            args.max_sessions = min(args.max_sessions, 8)
            if args.quant is None:
                args.quant = "int8"
        return run_coldstart_bench(args, dev)
    if args.fleet:
        return run_fleet_bench(args, dev)
    if args.ragged_sweep:
        return run_ragged_bench(args, dev)

    h, w = args.size
    body = _pair_body(h, w)
    server = config = None
    if args.url:
        m = re.match(r"https?://([^:/]+):(\d+)", args.url)
        if not m:
            print(f"ERROR: --url must look like http://host:port, "
                  f"got {args.url!r}")
            return 2
        host, port = m.group(1), int(m.group(2))
    else:
        from ..serving import FlowServer, ServeConfig, parse_buckets
        bucket_spec = args.buckets or f"{-(-h // 8) * 8}x{-(-w // 8) * 8}"
        config = _config(args)
        model = _load(args, config, dev)
        robustness = {}
        if args.chaos:
            robustness = dict(chaos=args.chaos, breaker_cooldown_s=2.0,
                              degraded_window_s=2.0,
                              history_interval_s=0.25,
                              anomaly_window_s=3.0,
                              anomaly_baseline_s=12.0,
                              flightrec_path=os.path.join(
                                  tempfile.mkdtemp(prefix="raft_bench_"),
                                  "flightrec.jsonl"))
            os.environ.setdefault("RAFT_TPU_LOCK_WATCH", "1")
        sconfig = ServeConfig(
            buckets=parse_buckets(bucket_spec), max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, queue_depth=args.queue_depth,
            default_deadline_ms=args.deadline_ms, port=0,
            iters_policy=args.iters_policy,
            max_sessions=args.max_sessions if args.video else 0,
            trace_sample=(1.0 if args.trace_sample is None
                          else args.trace_sample),
            **robustness, **_serve_knobs(args))
        server = FlowServer(config, model, sconfig, iters=args.iters)
        t0 = time.monotonic()
        server.start()
        print(f"[bench] in-process server ready in "
              f"{time.monotonic() - t0:.1f}s  buckets={bucket_spec}  "
              f"max_batch={args.max_batch}  url={server.url}  on {dev}")
        host, port = sconfig.host, server.port
    try:
        if args.video:
            return run_video_bench(args, host, port, server, config, dev)
        return _pairwise_bench(args, host, port, server, config, body, dev)
    finally:
        if server is not None:
            server.stop()


def _pairwise_bench(args, host, port, server, config, body, dev) -> int:
    """The closed/open pairwise run, its --smoke controls and audits, and
    the --chaos drill."""
    def drive(timings=None):
        if args.mode == "closed":
            return run_closed(host, port, body, args.clients, args.requests,
                              timings=timings)
        return run_open(host, port, body, args.clients, args.requests,
                        args.rate, timings=timings)

    clean_smoke = args.smoke and server is not None and not args.chaos
    # tracing-overhead control (the < 5% pairs/s contract): an untraced
    # phase first, same load, so the measured (traced) run gets the warmer
    # caches, biasing the comparison against a false FAIL
    overhead = None
    if clean_smoke and server.tracer.sample > 0:
        sample = server.tracer.sample
        server.tracer.sample = 0.0
        base_res, base_elapsed = drive()
        server.tracer.sample = sample
        overhead = {"untraced_pairs_per_sec":
                    round(_pps(base_res, base_elapsed), 3)}
    # history-sampling overhead control (the < 2% contract), the same
    # shape: stop() joins the sampler thread, start() relaunches it (the
    # in-process server has no spill file: the cycle loses nothing)
    hist_overhead = None
    if clean_smoke and server.history is not None:
        server.history.stop()
        off_res, off_elapsed = drive()
        server.history.start()
        hist_overhead = {"history_off_pairs_per_sec":
                         round(_pps(off_res, off_elapsed), 3)}
    storm_t0 = time.time()
    timings = []
    results, elapsed = drive(timings=timings)
    accounting, accounting_problems = None, []
    if clean_smoke and server.tracer.sample > 0:
        accounting, accounting_problems = fetch_trace_accounting(host, port)

    def finish_control(rec, base_key, on_key, limit):
        """The measured phase's pairs/s against the control's: an apparent
        overhead at or over ``limit`` re-measures the measured arm once
        (two short phases on a shared host can differ by more than the bar
        from scheduling alone; a real cost fails both times)."""
        on = round(_pps(results, elapsed), 3)
        base = rec[base_key]
        pct = (1.0 - on / base) * 100.0 if base else None
        if pct is not None and pct >= limit:
            r, e = drive()
            rec["retried"] = True
            on2 = round(_pps(r, e), 3)
            if on2 > on:
                on = on2
                pct = (1.0 - on / base) * 100.0
        rec[on_key] = on
        rec["overhead_pct"] = round(pct, 2) if pct is not None else None

    if overhead is not None:
        finish_control(overhead, "untraced_pairs_per_sec",
                       "traced_pairs_per_sec", 5.0)
    if hist_overhead is not None:
        finish_control(hist_overhead, "history_off_pairs_per_sec",
                       "history_on_pairs_per_sec", 2.0)
    profile_rec, profile_problems = None, []
    if clean_smoke:
        # this thread owns the in-process server: the profiler's CUDA
        # backend initializes here before a handler thread's capture
        from ..telemetry.trace import warm_profiler
        warm_profiler()
        profile_rec, profile_problems = run_profile_capture(
            host, port, body, cuda=dev.type == "cuda")
    chaos_rec, chaos_problems = None, []
    if args.chaos and server is not None:
        chaos_rec, chaos_problems = run_chaos_recovery(
            args, host, port, server, results, body,
            deadline_s=args.deadline_ms / 1000.0, storm_t0=storm_t0)
    prom = scrape(host, port)
    if server is not None:
        server.stop()
    budget_rec, budget_problems = (
        budget_crosscheck(server, prom, dev) if server is not None
        else (None, []))
    ok_lat = sorted(lat for st, lat in results if st == 200)
    occ_count = prom.get("raft_serving_batch_occupancy_count", 0)
    occ_mean = (prom.get("raft_serving_batch_occupancy_sum", 0) / occ_count
                if occ_count else 0.0)
    bs_count = prom.get("raft_serving_batch_size_count", 0)
    bs_mean = (prom.get("raft_serving_batch_size_sum", 0) / bs_count
               if bs_count else 0.0)
    pct = (lambda q: float(np.percentile(ok_lat, q)) * 1000) if ok_lat \
        else (lambda q: float("nan"))
    h, w = args.size
    rec = {
        "bench": "serving", "mode": args.mode,
        "clients": args.clients, "requests": args.requests,
        "rate_rps": args.rate if args.mode == "open" else None,
        "image_hw": [h, w], "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms, "queue_depth": args.queue_depth,
        "statuses": _statuses(results), "elapsed_s": round(elapsed, 3),
        "pairs_per_sec": round(len(ok_lat) / elapsed, 3) if elapsed else 0.0,
        "latency_ms": {"p50": round(pct(50), 2), "p95": round(pct(95), 2),
                       "p99": round(pct(99), 2),
                       "mean": round(float(np.mean(ok_lat)) * 1000, 2)
                       if ok_lat else float("nan")},
        "batch_size_mean": round(bs_mean, 3),
        "batch_occupancy_mean": round(occ_mean, 3),
        "batches": int(bs_count),
        "compile_misses_after_warmup": int(
            prom.get("raft_serving_compile_cache_misses_total", -1)),
        "captures_after_warmup": (
            int(prom["raft_serving_xla_recompiles_total"])
            if "raft_serving_xla_recompiles_total" in prom else None),
        "timed_out": int(prom.get(
            'raft_serving_requests_total{status="timeout"}', 0)),
        "shed_429": int(prom.get(
            'raft_serving_requests_total{status="shed"}', 0)),
    }
    policy = (args.iters_policy or "fixed") if not args.url else None
    iters_count = int(prom.get("raft_iters_used_count", 0))
    if (policy and policy != "fixed") or iters_count:
        rec["iters_policy"] = policy
        rec["iters_used"] = {
            "count": iters_count,
            "mean": (round(prom.get("raft_iters_used_sum", 0.0)
                           / iters_count, 3) if iters_count else None),
            "p50": hist_percentile(prom, "raft_iters_used", 0.50),
            "p95": hist_percentile(prom, "raft_iters_used", 0.95),
        }
    ts = _timings_summary(timings)
    if ts is not None:
        rec["server_timings_ms"] = ts
    if overhead is not None:
        rec["trace_overhead"] = overhead
    if hist_overhead is not None:
        rec["history_overhead"] = hist_overhead
    if profile_rec is not None:
        rec["profile_capture"] = profile_rec
    if server is not None and server.anomaly is not None:
        rec["anomaly_fires"] = {
            k.split('rule="')[1].rstrip('"}'): int(v)
            for k, v in prom.items()
            if k.startswith("raft_anomaly_fires_total{")}
    if accounting is not None:
        rec["trace_accounting"] = accounting
    if chaos_rec is not None:
        chaos_rec["fault_injected_total"] = {
            k.split("=")[-1].strip('"}'): int(v) for k, v in prom.items()
            if k.startswith("raft_fault_injected_total{")}
        chaos_rec["batcher_restarts_metric"] = int(
            prom.get("raft_batcher_restarts_total", 0))
        chaos_rec["nonfinite_outputs"] = int(
            prom.get("raft_nonfinite_outputs_total", 0))
        lock_order = prom.get("raft_lock_order_violations_total")
        chaos_rec["lock_order_violations"] = (
            int(lock_order) if lock_order is not None else None)
        chaos_rec["lock_hold_violations"] = int(
            prom.get("raft_lock_hold_violations_total", 0))
        chaos_rec["lock_holds_observed"] = int(
            prom.get("raft_lock_hold_seconds_count", 0))
        rec["chaos"] = chaos_rec
    if budget_rec is not None:
        rec["budget"] = budget_rec
    _write(_stamp(rec, dev, config, "serve_bench"), args.out)

    if not (args.smoke or chaos_problems):
        return 0
    problems = (list(chaos_problems) + accounting_problems + budget_problems
                + profile_problems)
    if not ok_lat:
        problems.append("no successful requests")
    if overhead and overhead.get("overhead_pct") is not None \
            and overhead["overhead_pct"] >= 5.0:
        problems.append(f"tracing costs {overhead['overhead_pct']:.1f}% "
                        f"pairs/s vs --trace-sample 0 (>= 5%)")
    if hist_overhead and hist_overhead.get("overhead_pct") is not None \
            and hist_overhead["overhead_pct"] >= 2.0:
        problems.append(f"metric history costs "
                        f"{hist_overhead['overhead_pct']:.1f}% pairs/s vs "
                        f"history off (>= 2%)")
    if not args.chaos and sum((rec.get("anomaly_fires") or {}).values()):
        fired = {r: n for r, n in rec["anomaly_fires"].items() if n}
        problems.append(f"anomaly sentinel(s) fired during a clean phase: "
                        f"{fired}")
    if clean_smoke and server.tracer.sample > 0 and ts is None:
        problems.append("no X-Raft-Timings headers collected")
    if rec["batch_size_mean"] <= 1.0 and args.clients > 1:
        problems.append(f"batcher never coalesced (mean batch "
                        f"{rec['batch_size_mean']})")
    if rec["compile_misses_after_warmup"] != 0:
        problems.append(f"{rec['compile_misses_after_warmup']} compile(s) "
                        f"after warmup")
    if chaos_rec is not None:
        if chaos_rec["lock_order_violations"] is None:
            problems.append("lock-order validator families missing from "
                            "/metrics — RAFT_TPU_LOCK_WATCH never armed")
        elif chaos_rec["lock_order_violations"] != 0:
            problems.append(f"{chaos_rec['lock_order_violations']} "
                            f"lock-order violation(s) under chaos")
        if chaos_rec["lock_hold_violations"]:
            problems.append(f"{chaos_rec['lock_hold_violations']} lock "
                            f"hold(s) over budget under chaos")
        if chaos_rec["lock_order_violations"] == 0 \
                and not chaos_rec["lock_holds_observed"]:
            problems.append("lock watch armed but observed zero lock holds")
    if args.smoke and not args.url:
        if rec["captures_after_warmup"] is None:
            problems.append("watchdog capture counter missing from /metrics "
                            "(RAFT_TPU_WATCHDOGS not live?)")
        elif rec["captures_after_warmup"] != 0:
            problems.append(f"{rec['captures_after_warmup']} graph "
                            f"capture(s) after warmup")
        if args.iters_policy and args.iters_policy != "fixed" \
                and not (rec.get("iters_used") or {}).get("count"):
            problems.append("converge policy on but no iters_used "
                            "observations")
    if problems:
        print("[bench] SMOKE FAIL: " + "; ".join(problems))
        return 1
    print("[bench] SMOKE PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
