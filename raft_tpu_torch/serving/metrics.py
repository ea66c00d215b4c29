"""The serving metric set, over the telemetry registry.

The port's copy of the JAX package's ``serving/metrics.py``: the metric
families whose names SERVING.md, the tests and the Prometheus scrape
contract pin, so both packages' servers expose the same families for the
same ``ServeConfig``.  The registry primitives are re-exported from
:mod:`raft_tpu_torch.telemetry.registry`.  (The AOT engine cache's
families are not here: the port has no cache, ROADMAP item 9c.)
"""

from __future__ import annotations

import functools
from typing import Dict

from ..telemetry.registry import (_Metric,  # noqa: F401 — compat re-export
                                  Counter, Gauge, Histogram, Registry,
                                  DEFAULT_LATENCY_BUCKETS,
                                  ITERS_USED_BUCKETS, _fmt,
                                  register_process_start_time)


def make_serving_metrics(registry: Registry, config,
                         queue_depth_fn=None) -> Dict[str, _Metric]:
    """The serving stack's metric set, in one place so the names in
    SERVING.md, the tests, and the code can't drift.  ``queue_depth_fn``
    makes the depth gauge a live callback (sampled at scrape time) so it
    can never go stale between submissions."""
    occ = tuple(i / 10 for i in range(1, 11))
    batch = tuple(float(s) for s in config.batch_steps)
    register_process_start_time(registry)
    return {
        "requests": registry.counter(
            "raft_serving_requests_total",
            "Requests by terminal status",
            labelnames=("status",)),
        "pairs": registry.counter(
            "raft_serving_pairs_total",
            "Image pairs successfully served"),
        "queue_depth": registry.gauge(
            "raft_serving_queue_depth",
            "Requests currently waiting in the admission queue",
            fn=queue_depth_fn),
        "inflight": registry.gauge(
            "raft_serving_inflight_batches",
            "Device batches currently executing"),
        "batch_size": registry.histogram(
            "raft_serving_batch_size",
            "Real (unpadded) requests per device batch",
            buckets=batch),
        "batch_occupancy": registry.histogram(
            "raft_serving_batch_occupancy",
            "Real requests / padded batch size per device call",
            buckets=occ),
        "padding_waste": registry.histogram(
            "raft_batch_padding_waste_ratio",
            "Padding pixels / total pixels per device batch: batch-fill "
            "rows plus, under --ragged, each row's dead embedding beyond "
            "its routed resolution (observed on pairwise and coalesced "
            "stream batches alike)",
            buckets=occ),
        "request_latency": registry.histogram(
            "raft_serving_request_latency_seconds",
            "End-to-end request latency (enqueue to result)"),
        "queue_latency": registry.histogram(
            "raft_serving_queue_latency_seconds",
            "Time spent waiting for a batch slot"),
        "batch_latency": registry.histogram(
            "raft_serving_batch_latency_seconds",
            "Device execution time per batch"),
        "compile_hits": registry.counter(
            "raft_serving_compile_cache_hits_total",
            "Device calls served by a warm executable"),
        "compile_misses": registry.counter(
            "raft_serving_compile_cache_misses_total",
            "Device calls that had to compile (0 after warmup = the "
            "no-recompile-storm guarantee)"),
        "iters_used": (iters_used := registry.histogram(
            "raft_iters_used",
            "GRU iterations spent per request — fills only under "
            "--iters-policy converge:* (per-sample early exit); stays "
            "empty under 'fixed', where every request costs the declared "
            "count",
            buckets=ITERS_USED_BUCKETS)),
        # live mean over everything observed so far: sum/count of the
        # histogram, sampled at scrape time — never goes stale
        "iters_mean": registry.gauge(
            "raft_iters_mean",
            "Mean GRU iterations per request (adaptive-compute saving)",
            fn=iters_used.mean),
    }


def make_stream_metrics(registry: Registry, store,
                        buckets=None) -> Dict[str, _Metric]:
    """The streaming (/v1/stream) metric families — one definition site,
    same contract as :func:`make_serving_metrics`.  The session gauges are
    live callbacks on the store; the eviction counter is handed back to
    the store so it can label the reason at the decision site.
    ``buckets`` (the declared resolution buckets) wires the per-bucket
    slot-pool gauges — slots in use vs capacity, the device-memory
    utilization of the continuous-batching stream path."""
    m = {
        "sessions_active": registry.gauge(
            "raft_stream_sessions_active",
            "Sessions holding device-resident feature maps "
            "(bounded by --max-sessions)",
            fn=store.active_count),
        "sessions_resident": registry.gauge(
            "raft_stream_sessions_resident",
            "Session records resident, demoted (features evicted) included",
            fn=store.resident_count),
        "opens": registry.counter(
            "raft_stream_opens_total",
            "Sessions opened"),
        "frames": registry.counter(
            "raft_stream_frames_total",
            "Stream advances served (one flow pair each)"),
        "fnet_hits": registry.counter(
            "raft_stream_fnet_cache_hits_total",
            "Advances served from cached previous-frame features "
            "(ONE encoder pass instead of two)"),
        "fnet_misses": registry.counter(
            "raft_stream_fnet_cache_misses_total",
            "Advances that cold-restarted (features evicted: two encoder "
            "passes, pairwise cost, correct flow)"),
        "evictions": registry.counter(
            "raft_stream_evictions_total",
            "Session evictions by reason: lru (features demoted past "
            "--max-sessions), ttl (idle record reaped), capacity "
            "(record evicted outright), degraded (breaker open / faulted "
            "step: features dropped, next advance cold-restarts)",
            labelnames=("reason",)),
        "degraded": registry.counter(
            "raft_stream_degraded_total",
            "Stream advances whose warm step faulted (engine error or "
            "non-finite output) and were transparently retried through "
            "the cold-restart path"),
        # the continuous-batching observables (ROADMAP item 1): stream
        # device steps now coalesce across sessions, so these report the
        # REAL per-step width (batched advances also fold into the
        # shared raft_serving_batch_size/occupancy histograms)
        "steps": registry.counter(
            "raft_stream_steps_total",
            "Stream device steps executed (one per device call: a "
            "coalesced multi-session advance counts once)"),
        "step_seconds": registry.histogram(
            "raft_stream_step_seconds",
            "Device time per stream step (one batched step advances "
            "every coalesced session)"),
        "step_batch": registry.histogram(
            "raft_stream_step_batch",
            "Sessions coalesced per stream device step (continuous "
            "batching width; 1 = a solo step / session open)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0)),
        "step_occupancy": registry.histogram(
            "raft_stream_step_occupancy",
            "Real sessions / padded slots per stream device step (the "
            "stream twin of raft_serving_batch_occupancy)",
            buckets=tuple(i / 10 for i in range(1, 11))),
    }
    store.evictions = m["evictions"]
    if buckets:
        pool = store.pool
        in_use = registry.gauge(
            "raft_stream_slots_in_use",
            "Device-resident slot-pool rows allocated per bucket "
            "(sessions whose maps sit in batch slots, ready to coalesce)",
            labelnames=("bucket",))
        cap = registry.gauge(
            "raft_stream_slot_capacity",
            "Slot-pool rows declared per bucket (--max-sessions)",
            labelnames=("bucket",))
        for (h, w) in buckets:
            in_use.labels(f"{h}x{w}").set_fn(
                functools.partial(pool.in_use, (h, w)))
            cap.labels(f"{h}x{w}").set(pool.capacity)
        m["slots_in_use"], m["slot_capacity"] = in_use, cap
        if getattr(pool, "arena", None) is not None:
            # ragged arena (SERVING.md "Ragged serving"): the buckets all
            # map onto one max-box arena, so per-bucket in_use gauges
            # report the shared count; this gauge prices how much of the
            # allocated arena rows is LIVE page pixels (vs dead embedding)
            m["arena_live_pixels"] = registry.gauge(
                "raft_stream_arena_live_pixels",
                "Live page pixels resident in the shared ragged slot "
                "arena (sum of slot extents; the box-pixel denominator "
                "is slots_in_use x arena h x w)",
                fn=functools.partial(pool.used_pixels, pool.arena))
    return m


def make_slo_metrics(registry: Registry, slo) -> Dict[str, _Metric]:
    """SLO burn-rate families over the span data (telemetry/spans.py
    SLOTracker).  Registered only while tracing is on (trace_sample > 0)
    so `--trace-sample 0` keeps the /metrics exposition free of tracing
    families.  The violation counter is handed back to the tracker (the
    decision-site labeling pattern the session store uses)."""
    burn = registry.gauge(
        "raft_slo_burn_rate",
        "Error-budget burn rate per request class: violating fraction of "
        "the SLO window / slo_budget (1 = burning exactly the budget, "
        ">> 1 = this replica cannot meet its latency objective)",
        labelnames=("class",))
    for cls in sorted(slo.objectives):
        burn.labels(cls).set_fn(functools.partial(slo.burn_rate, cls))
    violations = registry.counter(
        "raft_slo_violations_total",
        "Requests that burned error budget, by class (slower than the "
        "class objective, or terminated shed/timeout/poisoned/error)",
        labelnames=("class",))
    for cls in sorted(slo.objectives):
        violations.labels(cls)        # pre-create: exposition shows 0
    slo.violations = violations
    return {"burn_rate": burn, "violations": violations}


def make_robustness_metrics(registry: Registry,
                            breaker=None) -> Dict[str, _Metric]:
    """The self-healing metric families (failure containment):
    always registered — they are production health signals, not debug
    toggles.  The breaker's transition counter is handed back to it (the
    decision-site labeling pattern the session store uses)."""
    m = {
        "nonfinite": registry.counter(
            "raft_nonfinite_outputs_total",
            "Flow output rows rejected by the non-finite sentinel "
            "(each fails only its own request with a 500)"),
        "batcher_restarts": registry.counter(
            "raft_batcher_restarts_total",
            "Batcher-thread crashes recovered by the supervisor "
            "(healthz reports degraded while recent)"),
    }
    if breaker is not None:
        registry.gauge(
            "raft_breaker_state",
            "Circuit breaker state: 0 closed, 1 half-open, 2 open "
            "(open sheds with 503 + Retry-After)",
            fn=breaker.state_code)
        m["breaker_transitions"] = registry.counter(
            "raft_breaker_transitions_total",
            "Breaker state transitions by destination",
            labelnames=("to",))
        breaker.transitions = m["breaker_transitions"]
    return m


def make_engine_cache_metrics(registry: Registry) -> Dict[str, _Metric]:
    """AOT engine-cache families (serving/aot_cache.py) — registered only
    when --engine-cache-dir attaches a cache, so a cacheless server's
    /metrics exposition is untouched.  The counters are filled from the
    cache's warmup stats after start(); the histogram prices reading an
    entry and checking its probe (a replay and a sha256)."""
    return {
        "hits": registry.counter(
            "raft_engine_cache_hits_total",
            "Warmup keys whose cache entry held: identity matched, no "
            "compiler ran, the captured graph's probe output bitwise the "
            "writer's"),
        "misses": registry.counter(
            "raft_engine_cache_misses_total",
            "Warmup keys that missed (absent, corrupt or stale entry, a "
            "compiler run, or a probe output other than the writer's)"),
        "loads": registry.counter(
            "raft_engine_cache_loads_total",
            "Cache entries read"),
        "load_seconds": registry.histogram(
            "raft_engine_cache_load_seconds",
            "Seconds to read a cache entry and check its probe (one replay "
            "of the key's graph and a sha256 of its output)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)),
    }


def make_fault_metrics(registry: Registry) -> Dict[str, _Metric]:
    """Registered only when --chaos/RAFT_TPU_CHAOS arms the injector, so
    an un-drilled server's /metrics exposition carries no chaos families."""
    return {
        "faults": registry.counter(
            "raft_fault_injected_total",
            "Faults injected by the chaos harness, by arm "
            "(serving/faults.py; absent unless chaos is armed)",
            labelnames=("arm",)),
    }
