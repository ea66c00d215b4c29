"""FlowServer: queue + micro-batcher + warm engine + HTTP, composed.

The port's copy of the JAX package's ``serving/server.py``: the engine
replays captured CUDA graphs (``serving/engine.py``), and ``model`` is a
:class:`~raft_tpu_torch.models.raft.RAFT` on the device it serves from.

Lifecycle::

    server = FlowServer(config, model, sconfig)
    server.start()            # captures the warm grid, binds the port
    ...                       # serve_forever happens on daemon threads
    server.stop(drain=True)   # 503 new work, finish what's queued, exit

``stop(drain=True)`` is the graceful path: the admission queue closes
(submissions -> 503), the batcher flushes every queued request — max_wait
is ignored once draining — and in-flight device batches run to completion
before their handler threads are released; only then does the HTTP listener
shut down.  ``drain=False`` fails queued requests immediately instead.

serve_cli is the ``python -m raft_tpu_torch.serving`` entry point
(``serving/__main__.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Optional

import numpy as np

from ..config import RAFTConfig
from ..data.pipeline import embed_to_shape, pad_to_shape
from ..lint.concurrency import SERVING_LOCK_HIERARCHY
from ..telemetry import events as tlm_events
from ..telemetry import spans as tlm_spans
from ..telemetry import watchdogs as tlm_watchdogs
from ..telemetry.log import get_logger
from ..telemetry.trace import TraceWindow, stage
from .batcher import MicroBatcher
from .breaker import BreakerOpen, CircuitBreaker
from .config import ServeConfig
from .engine import InferenceEngine
from .faults import make_injector
from .http import BadRequest, make_http_server, serve_in_thread
from .metrics import (Registry, make_fault_metrics, make_robustness_metrics,
                      make_serving_metrics, make_slo_metrics,
                      make_stream_metrics)
from .queue import DeadlineExceeded, Draining, Request, RequestQueue
from .session import SessionStore
from .stream import StreamCoordinator

_log = get_logger("serve")


class BatcherSupervisor:
    """Restart-on-crash policy for the batcher daemon (the device-owning
    thread).  Before this, one stray exception escaping the loop killed
    the thread silently and every later request hung into its 504 margin;
    now a crash fails the in-flight batch (batcher._thread_main), lands
    here, is counted (``raft_batcher_restarts_total``), and the loop is
    restarted under exponential backoff.  ``/healthz`` reports
    ``degraded`` while a crash is recent (``degraded_window_s``) or the
    thread is down — the health signal ROADMAP item 3's replica gating
    needs.  Consecutive-crash backoff resets once the thread has stayed
    up a full degraded window."""

    def __init__(self, server: "FlowServer", counter=None,
                 degraded_window_s: float = 30.0,
                 max_backoff_s: float = 2.0):
        self.server = server
        self.counter = counter            # raft_batcher_restarts_total
        self.degraded_window_s = degraded_window_s
        self.max_backoff_s = max_backoff_s
        self.restarts = 0
        self.last_crash: Optional[float] = None
        self._consecutive = 0

    def on_crash(self, exc: Exception) -> None:
        """Runs on the dying batcher thread (batcher._thread_main)."""
        now = time.monotonic()
        if (self.last_crash is not None
                and now - self.last_crash > self.degraded_window_s):
            self._consecutive = 0         # stable period: backoff resets
        self.last_crash = now
        self.restarts += 1
        if self.counter is not None:
            self.counter.inc()
        _log.error(f"batcher thread crashed ({exc!r}); restart "
                   f"#{self.restarts}")
        # the crash is exactly what the flight recorder exists for: leave
        # the last N traces + every error trace as an artifact before the
        # restart muddies the water
        self.server._flight_dump("batcher_crash")
        if self.server.draining:
            self._fail_drained(exc)       # shutting down: no restart, but
            return                        # queued work must not hang
        backoff = min(0.05 * (2 ** self._consecutive), self.max_backoff_s)
        self._consecutive += 1
        time.sleep(backoff)
        if self.server.draining:
            self._fail_drained(exc)
            return
        self.server.batcher.restart()

    def _fail_drained(self, exc: Exception) -> None:
        """A crash during drain leaves the closed queue with no consumer:
        fast-fail the remainder (the drain promise is 'completes or
        errors', never 'hangs into the 504 margin')."""
        from .batcher import BatcherCrashed
        for r in self.server.queue.drain_remaining():
            self.server.count_request("error")
            r.fail(BatcherCrashed(
                f"batcher crashed during drain ({exc!r}); request "
                f"not executed"))

    @property
    def degraded(self) -> bool:
        if self.last_crash is not None and (
                time.monotonic() - self.last_crash < self.degraded_window_s):
            return True
        return not (self.server.batcher.alive or self.server.draining)


class FlowServer:
    def __init__(self, config: RAFTConfig, model, sconfig: ServeConfig,
                 iters: Optional[int] = None, engine=None,
                 verbose: bool = False,
                 trace_dir: Optional[str] = None, trace_steps: int = 4):
        self.sconfig = sconfig
        self.verbose = verbose
        self._frozen = False          # start() froze the heap (gc.freeze)
        # --trace generalized to serving: profile device batches 1..1+N
        # (batch 0 may pay a capture under --no-warmup)
        self._trace_window = TraceWindow(trace_dir, first=1,
                                         steps=trace_steps, log_fn=_log.info)
        self._device_batches = 0
        self._recompile_watch = None
        self.registry = Registry()
        self.queue = RequestQueue(sconfig.queue_depth)
        self.metrics = make_serving_metrics(
            self.registry, sconfig, queue_depth_fn=lambda: len(self.queue))
        self.registry.gauge("raft_serving_queue_limit",
                            "Admission queue capacity (backpressure bound)"
                            ).set(sconfig.queue_depth)
        # chaos harness: the injector exists only when --chaos/
        # RAFT_TPU_CHAOS arms it — a clean server carries faults=None and
        # pays one `is not None` per hook site
        self.faults = None
        if sconfig.chaos:
            self.faults = make_injector(
                sconfig.chaos,
                counter=make_fault_metrics(self.registry)["faults"],
                run_log=tlm_events.current())
        # circuit breaker: sheds 503 + Retry-After while the engine is
        # sick, demotes streaming sessions to the cold-restart path on
        # open (breaker_window=0 disables)
        self.breaker = None
        if sconfig.breaker_window > 0:
            self.breaker = CircuitBreaker(
                window=sconfig.breaker_window,
                threshold=sconfig.breaker_threshold,
                min_volume=sconfig.breaker_min_volume,
                cooldown_s=sconfig.breaker_cooldown_s,
                on_open=self._breaker_opened)
        self._robustness = make_robustness_metrics(self.registry,
                                                   breaker=self.breaker)
        self.metrics["nonfinite"] = self._robustness["nonfinite"]
        # request-scoped tracing (telemetry/spans.py): tracer + flight
        # recorder + SLO burn accounting.  trace_sample 0 disables the
        # whole plane — requests carry trace=None, every hook is one
        # `is not None`, and /metrics gains none of these families.
        self.flightrec = None
        self.slo = None
        if sconfig.trace_sample > 0:
            self.flightrec = tlm_spans.FlightRecorder(
                capacity=sconfig.flightrec_traces,
                path=sconfig.flightrec_path)
            self.slo = tlm_spans.SLOTracker(
                objectives={"pair": sconfig.slo_pair_ms / 1000.0,
                            "stream": sconfig.slo_stream_ms / 1000.0},
                budget=sconfig.slo_budget, window=sconfig.slo_window)
            make_slo_metrics(self.registry, self.slo)
        self.tracer = tlm_spans.Tracer(sample=sconfig.trace_sample,
                                       recorder=self.flightrec,
                                       slo=self.slo)
        # metric time-series + anomaly sentinels (telemetry/timeseries.py,
        # telemetry/anomaly.py — OBSERVABILITY.md "Time-series & anomaly
        # detection"): a background ring of registry snapshots feeding
        # GET /debug/history, the metrics_ts.jsonl spill, and the rule
        # sentinels (armed after warmup in start()).  history_interval_s=0
        # disables all three and keeps /metrics exposition untouched.
        self.history = None
        self.anomaly = None
        self.profile_dir: Optional[str] = None   # POST /debug/profile dest
        if sconfig.history_interval_s > 0:
            from ..telemetry.anomaly import AnomalyConfig, AnomalyMonitor
            from ..telemetry.timeseries import MetricHistory
            manifest = None
            if sconfig.history_path:
                manifest = tlm_events.run_manifest(
                    config, mode="serve", probe_device=False)
            self.history = MetricHistory(
                self.registry, interval_s=sconfig.history_interval_s,
                window=sconfig.history_window,
                path=sconfig.history_path, manifest=manifest)
            if sconfig.anomaly:
                self.anomaly = AnomalyMonitor(
                    self.history, self.registry,
                    run_log=tlm_events.current(),
                    flightrec=self.flightrec,
                    config=AnomalyConfig(
                        window_s=sconfig.anomaly_window_s,
                        baseline_s=sconfig.anomaly_baseline_s),
                    log_fn=_log.warning)
        # streaming (/v1/stream): a bounded session store + coordinator,
        # built only when declared (--max-sessions > 0) so a pairwise-only
        # server keeps its exact warmup grid and /metrics exposition
        self.streams = None
        if sconfig.max_sessions > 0:
            # under --ragged the store's slot pool must be the ARENA pool:
            # every routed bucket shares one max-box free-list, so two
            # sessions of different resolutions can never be handed the
            # same buffer row (the engine reuses this pool; its own
            # arena-aware construction only applies when none is injected)
            from .session import SlotPool
            store = SessionStore(
                sconfig.max_sessions, sconfig.session_ttl_s,
                pool=SlotPool(sconfig.max_sessions,
                              arena=(sconfig.max_box if sconfig.ragged
                                     else None)))
            stream_metrics = make_stream_metrics(self.registry, store,
                                                 buckets=sconfig.buckets)
            self.streams = StreamCoordinator(
                store, sconfig, self.queue, stream_metrics,
                self.count_request, faults=self.faults,
                nonfinite=self._robustness["nonfinite"],
                breaker=self.breaker, tracer=self.tracer)
            # the stream-step families are observed by the batcher (the
            # thread that owns the device), so they ride its metrics dict
            for k in ("steps", "step_seconds", "step_batch",
                      "step_occupancy"):
                self.metrics[f"stream_{k}"] = stream_metrics[k]
        # AOT engine cache (serving/aot_cache.py): keyed by the RESOLVED
        # config (the engine applies the sconfig iters-policy override, so
        # the cache identity must match the warmed keys) and the model
        self.engine_cache = None
        if engine is None and sconfig.engine_cache_dir:
            from .aot_cache import EngineCache
            rconfig = config
            if sconfig.iters_policy is not None:
                rconfig = dataclasses.replace(
                    config, iters_policy=sconfig.iters_policy)
            self.engine_cache = EngineCache(sconfig.engine_cache_dir,
                                            rconfig, model,
                                            cudnn=sconfig.cudnn)
        # engine injection: tests drive the batching policy with stubs.
        # A streaming engine shares the coordinator's slot pool: the
        # store owns the alloc/free policy, the engine owns the device
        # buffers and the warm gather/commit calls.
        self.engine = engine if engine is not None else InferenceEngine(
            config, model, sconfig, iters=iters,
            stream=sconfig.max_sessions > 0, faults=self.faults,
            pool=self.streams.pool if self.streams else None,
            cache=self.engine_cache)
        self.batcher = MicroBatcher(
            self.queue, self._run_engine, sconfig.pad_batch_to,
            sconfig.max_batch, sconfig.max_wait_ms, metrics=self.metrics,
            stream_fn=self._run_stream if self.streams else None,
            stream_group_fn=(self._run_stream_group if self.streams
                             else None),
            breaker=self.breaker, faults=self.faults,
            retries=sconfig.engine_retries,
            retry_backoff_s=sconfig.retry_backoff_ms / 1000.0,
            on_crash=self._batcher_crashed,
            ragged=sconfig.ragged,
            ragged_batch_pixels=sconfig.ragged_batch_pixels)
        self.supervisor = BatcherSupervisor(
            self, counter=self._robustness["batcher_restarts"],
            degraded_window_s=sconfig.degraded_window_s)
        self._httpd = None
        self._http_thread = None
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._gauges_wired = False

    # -- engine bridge (compile-cache accounting lives server-side so a
    #    stub engine still produces hit/miss metrics when it exposes them) -

    def _run_engine(self, bucket, im1, im2, sizes=None):
        self._trace_window.on_step(self._device_batches)
        self._device_batches += 1
        before = getattr(self.engine, "compile_misses", None)
        with stage("serve/batch"):
            # sizes (ragged per-row extents) only flows when the batcher
            # passes it, so dense-mode stub engines keep their 3-arg run()
            if sizes is not None:
                out = self.engine.run(bucket, im1, im2, sizes)
            else:
                out = self.engine.run(bucket, im1, im2)
        if before is not None:
            after = self.engine.compile_misses
            if after > before:
                self.metrics["compile_misses"].inc(after - before)
            else:
                self.metrics["compile_hits"].inc()
        return out

    def _run_stream(self, req):
        """Stream-step twin of _run_engine: same trace window, same
        compile-cache accounting, one session step per call."""
        self._trace_window.on_step(self._device_batches)
        self._device_batches += 1
        before = getattr(self.engine, "compile_misses", None)
        with stage("serve/stream"):
            out = self.streams.execute(req, self.engine)
        if before is not None:
            after = self.engine.compile_misses
            if after > before:
                self.metrics["compile_misses"].inc(after - before)
            else:
                self.metrics["compile_hits"].inc()
        return out

    def _run_stream_group(self, group):
        """Continuous-batched stream step (coalesced same-bucket
        advances): one device batch, same trace window and compile-cache
        accounting as the pairwise path."""
        self._trace_window.on_step(self._device_batches)
        self._device_batches += 1
        before = getattr(self.engine, "compile_misses", None)
        with stage("serve/stream"):
            out = self.streams.execute_group(group, self.engine)
        if before is not None:
            after = self.engine.compile_misses
            if after > before:
                self.metrics["compile_misses"].inc(after - before)
            else:
                self.metrics["compile_hits"].inc()
        return out

    def engine_executables(self) -> int:
        return getattr(self.engine, "executables", 0)

    def count_request(self, status: str) -> None:
        self.metrics["requests"].labels(status).inc()

    def reload_params(self, params, tag=None) -> dict:
        """Weight reload (POST /admin/reload): delegate to engine.reload —
        hold the new tensors against the template, probe them, copy them
        into the live weights under the device lock (no capture).  The run
        log records the swap so a quality shift can be attributed to it."""
        info = self.engine.reload(params, tag=tag)
        run_log = tlm_events.current()
        if run_log is not None:
            run_log.event("serve_weights_reloaded", version=info["version"],
                          tag=info.get("tag"), probed=info.get("probed"))
        return info

    def profile_capture(self, ms: float) -> dict:
        """POST /debug/profile?ms=: on-demand ``torch.profiler`` capture of
        the next ``ms`` milliseconds on a LIVE replica, written as a Chrome
        trace — no restart, no --trace flag decided at boot.
        Single-flight (telemetry/trace.py ``capture_profile`` holds a
        process-wide lock; a concurrent request gets CaptureBusy → 409)
        and side-effect-free on the engine: profiling never captures a
        graph."""
        from ..telemetry.trace import capture_profile
        info = capture_profile(self.profile_dir, ms, log_fn=_log.info,
                               quiesce=getattr(self.engine, "_device_lock",
                                               None))
        run_log = tlm_events.current()
        if run_log is not None:
            run_log.event("profile_capture", **info)
        return info

    def prestage_cache(self) -> dict:
        """POST /admin/cache/prestage: write every warm key's entry and
        the manifest into the attached cache directory
        (engine.export_cache) — what the fleet's rolling updater calls on
        a replica before a weight flip, so a replica spawned during or
        after the roll boots from a full directory.  Returns {exported,
        entries, dir}."""
        info = self.engine.export_cache()
        run_log = tlm_events.current()
        if run_log is not None:
            run_log.event("serve_cache_prestaged", **info)
        return info

    # -- self-healing hooks ------------------------------------------------

    def _batcher_crashed(self, exc: Exception) -> None:
        self.supervisor.on_crash(exc)

    def _breaker_opened(self) -> None:
        """Breaker open: demote every streaming session's device features
        so nothing cached before the storm is trusted after it — their
        next advance takes the transparent cold-restart path.

        Runs under the breaker's lock (the declared breaker -> store
        hierarchy edge), so the flight-recorder dump — file I/O — is
        handed to a short-lived thread: handlers blocked in
        ``breaker.allow()`` must not wait on a disk write, and a slow
        dump must not trip the watched-lock hold budget."""
        if self.streams is not None:
            n = self.streams.store.demote_all()
            if n:
                _log.warning(f"breaker open: demoted {n} streaming "
                             f"session(s) to the cold-restart path")
        threading.Thread(target=self._flight_dump, args=("breaker_open",),
                         daemon=True, name="raft-flightrec-dump").start()

    def _flight_dump(self, reason: str) -> None:
        """Write the flight-recorder rings to their configured path (no-op
        without one — /debug/traces still serves the in-memory view)."""
        if self.flightrec is None:
            return
        try:
            path = self.flightrec.dump(reason)
        except Exception as e:  # noqa: BLE001 — a dump failure must never
            _log.warning(f"flight-recorder dump failed: {e}")  # cascade
            return
        if path:
            _log.warning(f"flight recorder: wrote {path} ({reason})")

    def _admit(self) -> None:
        """Breaker gate shared by /v1/flow and /v1/stream admission."""
        if self.breaker is None:
            return
        retry = self.breaker.allow()
        if retry is not None:
            self.count_request("breaker_open")
            raise BreakerOpen(
                f"circuit breaker open (device-call error rate over the "
                f"last {self.sconfig.breaker_window} calls reached "
                f"{self.sconfig.breaker_threshold:.0%}); retry in "
                f"{retry:.1f}s", retry_after=retry)

    def health_status(self) -> str:
        """'ok' | 'degraded' — degraded while the batcher recently
        crashed (or is down) or the breaker is not closed."""
        if self.supervisor.degraded:
            return "degraded"
        if self.breaker is not None and self.breaker.state != "closed":
            return "degraded"
        return "ok"

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if not self._gauges_wired:
            self._gauges_wired = True
            self.registry.gauge("raft_serving_compile_cache_entries",
                                "Warm executables resident",
                                fn=self.engine_executables)
            from ..ops import corr_cuda, gru_cuda
            launches = self.registry.gauge(
                "raft_kernel_launches",
                "CUDA kernel launches issued by this process's wrappers, "
                "by kernel (a capture issues them; a graph's replays "
                "issue none through the wrappers)",
                labelnames=("kernel",))
            for w in (corr_cuda.corr_lookup_cuda, corr_cuda.corr_window_cuda,
                      corr_cuda.corr_ragged_cuda, corr_cuda.corr_packed_cuda,
                      gru_cuda.sep_conv_gru_cuda):
                launches.labels(w.__name__.replace("_cuda", "")).set_fn(
                    lambda w=w: w.launches)
            if tlm_watchdogs.lock_watch_enabled():
                # runtime lock-order validator (RAFT_TPU_LOCK_WATCH=1):
                # the serving locks were created through watched_lock, so
                # every acquisition edge is recorded — arm the declared
                # hierarchy (SERVING.md threading model) and export the
                # violation counters; the chaos drill asserts they stay 0
                v = tlm_watchdogs.export_lock_metrics(
                    self.registry, run_log=tlm_events.current())
                v.declare_order(SERVING_LOCK_HIERARCHY)
        if tlm_watchdogs.watchdogs_enabled():
            # graph-capture watch (the engine reports every capture it
            # observes; the family keeps the JAX package's name, which the
            # miss_trickle sentinel reads) + live device-memory gauges.
            # Registered only when watchdogs are on, so the default
            # /metrics exposition stays byte-identical.
            self._recompile_watch = tlm_watchdogs.RecompileWatch(
                counter=self.registry.counter(
                    "raft_serving_xla_recompiles_total",
                    "CUDA graph captures observed after warmup (watchdog)"),
                run_log=tlm_events.current(),
                log_fn=_log.warning,
                # a post-warmup recompile is an incident: dump the traces
                on_recompile=lambda: self._flight_dump("recompile")
                ).install()
            tlm_watchdogs.hbm_gauges(self.registry, prefix="raft_serving")
        if self.sconfig.warmup and hasattr(self.engine, "warmup"):
            n = self.engine.warmup(verbose=self.verbose)
            if self.verbose:
                loaded = getattr(self.engine, "warmup_loaded", 0)
                cache = ("" if self.engine_cache is None else
                         f" ({loaded} cache hit(s), {n - loaded} miss(es))")
                _log.info(f"warmup built {n} key(s){cache} in "
                          f"{self.engine.warmup_seconds:.1f}s")
        if self.engine_cache is not None:
            # fill the cache families from the warmup stats (registered
            # only with a cache, so a cacheless /metrics is untouched)
            from .metrics import make_engine_cache_metrics
            fam = make_engine_cache_metrics(self.registry)
            st = self.engine_cache.stats
            for name in ("hits", "misses", "loads"):
                count = getattr(st, name)
                if count:
                    fam[name].inc(count)
            for sec in st.load_seconds:
                fam["load_seconds"].observe(sec)
        if self._recompile_watch is not None:
            self._recompile_watch.arm()
        if self.history is not None:
            self.history.sample()         # t=0 baseline before any traffic
            self.history.start()
            if self.anomaly is not None:
                # arm AFTER warmup: the compile storm and the cold queue
                # are expected — steady-state invariants start here
                self.anomaly.arm()
        # the heap built so far (the model, the graphs' Python side, the
        # imports: ~190k objects) leaves the collector's generations: a
        # full collection over it paused every serving thread for tens of
        # ms, which a host-bound server showed as latency spikes (the
        # smokes' p95-drift sentinel) and as the history sampler's and the
        # tracer's cost (their allocations trigger the collections)
        gc.collect()
        gc.freeze()
        self._frozen = True
        self.batcher.start()
        self._httpd = make_http_server(self, self.sconfig.host,
                                       self.sconfig.port)
        self._http_thread = serve_in_thread(self._httpd)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self.sconfig.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Idempotent graceful (or immediate) shutdown."""
        if self._stopped.is_set():
            return
        self._draining.set()
        if not drain:
            for r in self.queue.drain_remaining():
                self.count_request("draining")
                r.fail(Draining("server shut down before this request ran"))
        self.queue.close()            # batcher drains the rest, then exits
        self.batcher.join(timeout)
        # SIGTERM/shutdown artifact: the drain is complete, so every
        # in-flight trace has closed — the dump is the final word
        self._flight_dump("shutdown")
        if self.history is not None:
            self.history.stop()           # final sample + spill close
        self._trace_window.stop()
        if self._recompile_watch is not None:
            self._recompile_watch.remove()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._frozen:
            gc.unfreeze()
            self._frozen = False
        self._stopped.set()

    def wait(self) -> None:
        """Block until stop() completes (the CLI foreground call).  This
        thread opens the profiler's first session when ``POST
        /debug/profile`` first asks for one (telemetry/trace.py
        ``host_profiler_warmup``)."""
        from ..telemetry.trace import host_profiler_warmup
        host_profiler_warmup(self._stopped)

    # -- request path ------------------------------------------------------

    def infer(self, im1: np.ndarray, im2: np.ndarray,
              deadline_ms: Optional[float] = None,
              trace_id: Optional[str] = None,
              finish_trace: bool = True) -> Request:
        """Route, pad, enqueue, block until resolved.  Called from HTTP
        handler threads (and directly by tests/the in-process bench).

        Trace lifecycle: a trace is minted here (or adopts the client's
        ``trace_id``) and CLOSES here on every failure path, with the
        status the exception maps to — shed, timeout, poisoned, error —
        and the exception carries ``.trace_id`` out to the HTTP layer.
        On success the HTTP handler finishes it after the respond span
        (``finish_trace=False``); direct callers let this method close it.
        """
        tr = self.tracer.start("pair", trace_id)
        t0 = time.monotonic()
        try:
            if self.draining:
                self.count_request("draining")
                raise Draining("server is draining; not accepting requests")
            self._admit()                 # breaker gate: shed 503 while open
            h, w = im1.shape[0], im1.shape[1]
            bucket = self.sconfig.route(h, w)
            if bucket is None:
                raise BadRequest(
                    f"no declared bucket fits ({h}, {w}); buckets: "
                    f"{[f'{bh}x{bw}' for bh, bw in self.sconfig.buckets]}")
            dl = self.sconfig.default_deadline_ms if deadline_ms is None \
                else min(deadline_ms, self.sconfig.default_deadline_ms)
            if dl <= 0:
                raise BadRequest(f"deadline_ms must be positive, got {dl}")
            im1p, pads = pad_to_shape(im1[None].astype(np.float32), bucket)
            im2p, _ = pad_to_shape(im2[None].astype(np.float32), bucket)
            rbucket = None
            if self.sconfig.ragged:
                # ragged: zero-embed the routed-bucket pair corner-
                # anchored into the shared max box and queue it UNDER the
                # max box, so requests of every resolution share one FIFO
                # (cross-resolution coalescing) and one executable.  The
                # embedding folds into pads so unpad() recovers (h, w)
                # straight from the max-box flow; the routed bucket rides
                # in rbucket — the batcher turns it into the row's sizes.
                rbucket = bucket
                (bh, bw), (mh, mw) = bucket, self.sconfig.max_box
                im1p = embed_to_shape(im1p, self.sconfig.max_box)
                im2p = embed_to_shape(im2p, self.sconfig.max_box)
                t, b_, l_, r_ = pads
                pads = (t, b_ + mh - bh, l_, r_ + mw - bw)
                bucket = self.sconfig.max_box
            req = Request(im1p, im2p, bucket, pads,
                          deadline=time.monotonic() + dl / 1000.0,
                          rbucket=rbucket)
            req.trace = tr
            if tr is not None:
                tr.span("admit", t0, time.monotonic(),
                        bucket=f"{bucket[0]}x{bucket[1]}")
            try:
                self.queue.submit(req)
            except Draining:
                self.count_request("draining")
                raise
            except Exception:       # QueueFull: overload shed, HTTP 429
                self.count_request("shed")
                raise
            # the generous margin past the deadline covers an in-flight
            # batch that dequeued the request just before its deadline:
            # it completes
            try:
                req.wait(timeout=dl / 1000.0 + max(30.0, dl / 1000.0))
            except DeadlineExceeded:
                if req.error is None:
                    # wait() itself timed out (batch overran / batcher
                    # stalled) — the batcher's purge never saw this one
                    self.count_request("timeout")
                raise
        except BaseException as e:
            if tr is not None:
                # stamp-if-absent: a group-wide failure can share ONE
                # exception instance across co-batched handlers, and the
                # first stamp must not be overwritten with another
                # request's id (the batcher fails shared errors with
                # per-request instances precisely so this stays unique)
                if getattr(e, "trace_id", None) is None:
                    e.trace_id = tr.trace_id
                tr.finish(tlm_spans.status_of(e))
            raise
        if finish_trace and tr is not None:
            tr.finish()
        return req

    def stream_call(self, op: str, session_id, image, deadline_ms,
                    trace_id: Optional[str] = None,
                    finish_trace: bool = True):
        """/v1/stream bridge: dispatch one open/advance/close to the
        stream coordinator (http handler threads).  ``close`` is pure
        bookkeeping and is never traced; open/advance follow the same
        trace lifecycle as :meth:`infer` (the coordinator mints it)."""
        if self.streams is None:
            raise BadRequest("streaming is disabled on this server "
                             "(--max-sessions 0); use /v1/flow")
        if self.draining:
            self.count_request("draining")
            raise Draining("server is draining; not accepting requests")
        if op == "close":
            # closing is bookkeeping, never a device call: always allowed
            return self.streams.close(session_id)
        self._admit()                     # breaker gate: shed 503 while open
        if op == "open":
            res = self.streams.open(image, deadline_ms, trace_id=trace_id,
                                    finish_trace=finish_trace)
        else:
            res = self.streams.advance(session_id, image, deadline_ms,
                                       trace_id=trace_id,
                                       finish_trace=finish_trace)
        if finish_trace:
            res.pop("_trace", None)       # direct callers: already closed
            res.pop("_finished_at", None)
        return res


def serve_cli(args, config: RAFTConfig, load_model) -> int:
    """Build, warm, serve until SIGINT/SIGTERM, drain, exit 0.
    ``load_model(args, config)`` returns the model to serve."""
    import json
    import os
    import signal

    from .config import parse_buckets

    # flight recorder: default <out>/flightrec.jsonl; --flightrec '' turns
    # the auto-dump off (the /debug/traces endpoint still serves the ring)
    flightrec = getattr(args, "flightrec", None)
    if flightrec is None:
        flightrec = os.path.join(getattr(args, "out", None) or ".",
                                 "flightrec.jsonl")
    # metric history spill: default <out>/metrics_ts.jsonl (the flightrec
    # pattern); --history-path '' keeps the in-memory ring + endpoint but
    # skips the file
    history_path = getattr(args, "history_path", None)
    if history_path is None:
        history_path = os.path.join(getattr(args, "out", None) or ".",
                                    "metrics_ts.jsonl")
    try:
        sconfig = ServeConfig(
            buckets=parse_buckets(args.buckets),
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            queue_depth=args.queue_depth,
            default_deadline_ms=args.deadline_ms,
            host=args.host, port=args.port,
            dp_devices=getattr(args, "serve_dp", None) or 1,
            warmup=not args.no_warmup,
            iters_policy=getattr(args, "iters_policy", None),
            trace_sample=getattr(args, "trace_sample", 1.0),
            slo_pair_ms=getattr(args, "slo_pair_ms", 1000.0),
            slo_stream_ms=getattr(args, "slo_stream_ms", 500.0),
            flightrec_path=flightrec or None,
            # argparse owns the defaults; `or`-style fallbacks would
            # silently turn an (invalid) explicit 0 into the default
            # instead of letting ServeConfig raise on it
            max_sessions=getattr(args, "max_sessions", 64),
            session_ttl_s=getattr(args, "session_ttl_s", 300.0),
            ragged=getattr(args, "ragged", False),
            ragged_batch_pixels=getattr(args, "ragged_batch_pixels", 0),
            engine_cache_dir=getattr(args, "engine_cache_dir", None),
            cudnn=getattr(args, "cudnn", None) or ServeConfig.cudnn,
            history_interval_s=getattr(args, "history_interval_s", 1.0),
            history_window=getattr(args, "history_window", 600),
            history_path=history_path or None,
            anomaly=not getattr(args, "no_anomaly", False),
            anomaly_window_s=getattr(args, "anomaly_window_s", 15.0),
            anomaly_baseline_s=getattr(args, "anomaly_baseline_s", 60.0),
            # chaos drills: the CLI flag wins, the env var arms CI/ops.
            # breaker knobs use None-checks, not `or`: --breaker-window 0
            # is the documented breaker-off switch and must survive
            chaos=(getattr(args, "chaos", None)
                   or os.environ.get("RAFT_TPU_CHAOS") or None),
            **{k: v for k, v in {
                "breaker_window": getattr(args, "breaker_window", None),
                "breaker_threshold": getattr(args, "breaker_threshold",
                                             None),
                "breaker_cooldown_s": getattr(args, "breaker_cooldown_s",
                                              None),
            }.items() if v is not None})
    except (ValueError, NotImplementedError) as e:
        print(f"ERROR: {e}")
        return 2
    from .. import IMPORT_T0
    boot = {"imports_s": time.time() - IMPORT_T0}
    spawned = os.environ.get("RAFT_TPU_SPAWN_T")
    if spawned:
        # set by the fleet's spawner: from its Popen to this package's
        # first import (the interpreter's start)
        boot["interpreter_s"] = IMPORT_T0 - float(spawned)
    t = time.monotonic()
    if not args.cpu:
        import torch
        torch.empty(1, device="cuda")   # the CUDA context
        torch.cuda.synchronize()
        boot["cuda_init_s"] = time.monotonic() - t
        t = time.monotonic()
    model = load_model(args, config)
    boot["model_s"] = time.monotonic() - t
    server = FlowServer(config, model, sconfig, iters=args.iters,
                        verbose=True,
                        trace_dir=getattr(args, "trace", None),
                        trace_steps=getattr(args, "trace_steps", None) or 4)
    out = getattr(args, "out", None)
    if out:
        server.profile_dir = os.path.join(out, "profiles")
    t0 = time.monotonic()
    server.start()
    boot.update({k: v for k, v in getattr(server.engine, "boot", {}).items()
                 if k != "keys"})
    keys = getattr(server.engine, "boot", {}).get("keys", [])
    for part in ("key_s", "warmup_s", "capture_s", "probe_s"):
        boot[f"keys_{part}"] = sum(k.get(part, 0.0) for k in keys)
    boot["start_to_ready_s"] = time.monotonic() - t0
    if not args.cpu:
        # this process's allocator (graph pools, weights, pool buffers),
        # without the CUDA context
        boot["cuda_reserved_mib"] = torch.cuda.memory_reserved() / 2 ** 20
    if spawned:
        boot["spawn_to_ready_s"] = time.time() - float(spawned)
    if server.engine_cache is not None:
        boot["engine_cache"] = server.engine_cache.stats.as_dict()
    # one JSON line: a fleet's spawner and the chip smoke read it
    print(f"[serve] boot {json.dumps(boot, default=str)}", flush=True)
    print(f"[serve] listening on {server.url}  "
          f"buckets={[f'{h}x{w}' for h, w in sconfig.buckets]}  "
          f"max_batch={sconfig.max_batch}  "
          f"batch_steps={list(sconfig.batch_steps)}  "
          f"max_wait={sconfig.max_wait_ms}ms  "
          f"queue_depth={sconfig.queue_depth}  "
          f"iters_policy={server.engine.iters_policy}  "
          f"({time.monotonic() - t0:.1f}s to ready)")
    if sconfig.ragged:
        mh, mw = sconfig.max_box
        print(f"[serve] ragged: ONE graph per (kind, batch-step) at "
              f"the {mh}x{mw} arena serves every declared bucket  "
              f"batch_pixels="
              f"{sconfig.ragged_batch_pixels or 'unbounded'}")
    if server.streams is not None:
        print(f"[serve] streaming: max_sessions={sconfig.max_sessions}  "
              f"session_ttl={sconfig.session_ttl_s:.0f}s  "
              f"quant={config.quant}  "
              f"POST {server.url}/v1/stream")
    if server.faults is not None:
        print(f"[serve] CHAOS ARMED: {sconfig.chaos} "
              f"(fault injection live — drills only)")
    if sconfig.trace_sample > 0:
        print(f"[serve] tracing: sample={sconfig.trace_sample:g}  "
              f"slo pair={sconfig.slo_pair_ms:.0f}ms "
              f"stream={sconfig.slo_stream_ms:.0f}ms  "
              f"flightrec={sconfig.flightrec_path or '(endpoint only)'}  "
              f"GET {server.url}/debug/traces")
    if server.history is not None:
        sentinels = ("armed" if server.anomaly is not None else "off")
        print(f"[serve] history: interval={sconfig.history_interval_s:g}s "
              f"window={sconfig.history_window}  sentinels={sentinels}  "
              f"spill={sconfig.history_path or '(ring only)'}  "
              f"GET {server.url}/debug/history   "
              f"POST {server.url}/debug/profile?ms=500")
    print(f"[serve] POST {server.url}/v1/flow   "
          f"GET {server.url}/healthz   GET {server.url}/metrics")

    def _stop(signum, frame):
        print(f"\n[serve] signal {signum}: draining "
              f"({len(server.queue)} queued)...")
        threading.Thread(target=server.stop, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    server.wait()
    b = server.batcher
    print(f"[serve] drained and stopped  served={b.served} "
          f"batches={b.batches} timed_out={b.timed_out}")
    return 0
