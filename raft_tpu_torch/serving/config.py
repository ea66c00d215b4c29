"""Serving configuration: the knobs of the micro-batching inference service.

The port's copy of the JAX package's ``serving/config.py``: the same knob
names, defaults and validation.  Every shape the server will ever put on
the device is declared HERE, up front: the resolution buckets and the
batch steps.  The engine warms the full (bucket x batch-step) grid before
the first request — in the port each key's CUDA graph is captured
(``models/capture.py``) — so steady-state serving only replays.

``dp_devices = N`` serves each device call over N devices
(``parallel/data_parallel.py::make_dp_eval_fn``): the batch steps are
rounded up to multiples of N, and ragged serving with N > 1 raises, as in
the JAX package.  ``engine_cache_dir`` attaches the AOT engine cache
(``serving/aot_cache.py``): the kernel objects and a probe digest per
warm key, shared by a fleet's replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..config import parse_iters_policy


#: ServeConfig.cudnn's values.
CUDNN_MODES = ("benchmark", "heuristic")


def parse_buckets(spec: str) -> Tuple[Tuple[int, int], ...]:
    """Parse a CLI bucket spec like ``"432x1024,240x432"`` into an (H, W)
    tuple list.  Each side must be a positive multiple of 8 (the RAFT
    stride contract, models/raft.py)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            h, w = (int(v) for v in part.lower().split("x"))
        except ValueError:
            raise ValueError(f"bad bucket {part!r}: expected HxW, e.g. 432x1024")
        if h <= 0 or w <= 0 or h % 8 or w % 8:
            raise ValueError(f"bucket {part!r}: H and W must be positive "
                             f"multiples of 8")
        out.append((h, w))
    if not out:
        raise ValueError(f"no buckets in spec {spec!r}")
    return tuple(out)


def default_batch_steps(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) max_batch: every padded
    device call hits one of these sizes, so the compile grid stays
    O(log max_batch) per bucket instead of O(max_batch)."""
    steps = []
    s = 1
    while s < max_batch:
        steps.append(s)
        s *= 2
    steps.append(max_batch)
    return tuple(steps)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static configuration of the serving stack (see SERVING.md)."""

    # Pre-declared resolution buckets, largest-wins routing NOT — each
    # request routes to the SMALLEST bucket that contains it (minimal
    # padding); inputs larger than every bucket are rejected with 400.
    buckets: Tuple[Tuple[int, int], ...] = ((432, 1024),)
    # Micro-batcher: coalesce same-bucket requests up to max_batch, or until
    # the oldest queued request has waited max_wait_ms — whichever first.
    max_batch: int = 4
    max_wait_ms: float = 5.0
    # Batch sizes actually compiled/executed; a coalesced group is padded up
    # to the next step (occupancy = real / padded).  None = powers of two
    # up to max_batch (default_batch_steps).
    batch_steps: Tuple[int, ...] = None  # type: ignore[assignment]
    # Admission control: at most this many requests WAITING (in-flight
    # batches excluded); submissions beyond it are shed with 429 instead of
    # queueing unboundedly.
    queue_depth: int = 128
    # Per-request deadline (client can lower per call, never raise): a
    # request still queued past its deadline is dropped with 504 — late
    # answers are worthless and computing them steals capacity.
    default_deadline_ms: float = 2000.0
    # HTTP endpoint. port 0 = ephemeral (the bound port is printed and
    # available as FlowServer.port — what the bench and tests use).
    host: str = "127.0.0.1"
    port: int = 8000
    # Shard each device call over N local devices (cuda:0..N-1, one replica
    # of the captured forward each); batch steps are rounded up to
    # multiples of N.  1 = single device.
    dp_devices: int = 1
    # Capture every (bucket, batch-step) key's CUDA graph before accepting
    # traffic.  Off skips straight to lazy captures (the first request per
    # shape pays the capture — useful only for quick experiments).
    warmup: bool = True
    # Iteration policy of the served model (config.parse_iters_policy):
    # None inherits the model config; 'converge:eps[:min_iters]' turns on
    # per-sample early exit — shapes stay static so the batcher and the
    # warm compile grid are untouched, but the policy IS part of the
    # engine-cache key: every warmed executable is pinned to the policy it
    # was compiled under, and each request's iterations-used lands in the
    # raft_iters_used histogram on /metrics.
    iters_policy: Optional[str] = None
    # Streaming (/v1/stream, SERVING.md): at most this many video sessions
    # hold device-resident feature maps; past it the LRU session's maps
    # are evicted and its next advance degrades transparently to a cold
    # two-encoder restart.  0 disables the endpoint (and its warmup
    # executables) entirely.
    max_sessions: int = 64
    # Sessions idle longer than this are reaped outright (record included);
    # advancing a reaped id is a 404 — the client reopens.
    session_ttl_s: float = 300.0
    # Chaos harness (serving/faults.py): a fault-injection spec like
    # "seed=11,engine_error=0.05,nan=0.03,kill=0.01" arms the injector
    # (--chaos / RAFT_TPU_CHAOS).  None (default) = off, zero overhead.
    chaos: Optional[str] = None
    # Circuit breaker (serving/breaker.py): when the device-call error
    # rate over the last `breaker_window` calls reaches
    # `breaker_threshold` (with at least `breaker_min_volume` observed),
    # the breaker opens for `breaker_cooldown_s`: requests shed with 503
    # + Retry-After and streaming sessions demote to the cold-restart
    # path; then half-open probes decide recovery.  window 0 disables.
    breaker_window: int = 64
    breaker_threshold: float = 0.5
    breaker_min_volume: int = 8
    breaker_cooldown_s: float = 5.0
    # Request-scoped tracing (telemetry/spans.py, OBSERVABILITY.md):
    # fraction of completed request traces RETAINED (flight recorder +
    # run-log `trace` events) — error-status traces are always retained
    # while tracing is on.  Every request still records spans (the
    # response's meta.timings), retention is what's sampled.  0 disables
    # tracing outright: no spans, no meta.timings, no SLO/flight-recorder
    # machinery, and /metrics gains none of their families.
    trace_sample: float = 1.0
    # Per-class latency objectives (SLO): a completed request slower than
    # its class objective — or terminating non-ok — burns error budget.
    # raft_slo_burn_rate{class=} = violating fraction of the last
    # `slo_window` requests / `slo_budget`; >> 1 means this replica
    # cannot meet its objective (the autoscaling signal, ROADMAP item 3).
    slo_pair_ms: float = 1000.0
    slo_stream_ms: float = 500.0
    slo_budget: float = 0.01
    slo_window: int = 256
    # Flight recorder: ring capacity (last N ok traces + up to N error
    # traces) and the auto-dump path (batcher crash / breaker open /
    # recompile watchdog / shutdown; None = /debug/traces only).
    flightrec_traces: int = 64
    flightrec_path: Optional[str] = None
    # AOT engine cache directory (serving/aot_cache.py): the kernel
    # objects and one probe-digest entry per warm key, shared by a
    # fleet's replicas.  None: no cache (warmup captures every key either
    # way; a CUDA graph does not serialize).
    engine_cache_dir: Optional[str] = None
    # Engine-failure containment (batcher): same-group retries (with
    # backoff) before poisoned-batch bisection splits the blame.
    engine_retries: int = 1
    retry_backoff_ms: float = 20.0
    # healthz reports "degraded" for this long after a batcher crash
    # (and while the breaker is not closed) — the replica-gating signal.
    degraded_window_s: float = 30.0
    # Metric time-series (telemetry/timeseries.py, OBSERVABILITY.md):
    # a background thread samples the registry every history_interval_s
    # into a history_window-deep ring — GET /debug/history serves windowed
    # derived series (rates, delta-p95s), the anomaly sentinels evaluate
    # over it, and history_path (default <out>/metrics_ts.jsonl when the
    # server has an out dir) spills every sample with manifest provenance
    # for tlm top --replay.  0 disables sampling, the endpoint, and the
    # sentinels together.
    history_interval_s: float = 1.0
    history_window: int = 600
    history_path: Optional[str] = None
    # Anomaly sentinels (telemetry/anomaly.py): rule-driven detection over
    # the history — armed after warmup, surfaced as
    # raft_anomaly_active{rule=} + `anomaly` run-log events + a flight-
    # recorder dump on first fire.  Requires the history.  The two windows
    # feed AnomalyConfig; the smoke-scale defaults live there.
    anomaly: bool = True
    anomaly_window_s: float = 15.0
    anomaly_baseline_s: float = 60.0
    # Ragged mixed-resolution serving (SERVING.md "Ragged serving"): ONE
    # executable per (kind, batch-step, policy) serves EVERY declared bucket
    # — requests stay routed to their minimal bucket for padding accounting,
    # then ride the shared max-box executable with per-row (h, w) size
    # metadata; the batcher coalesces ACROSS buckets and mixed-resolution
    # stream sessions share one slot arena and one sbatch step.  The warmup
    # grid (and the AOT cache) shrinks from O(buckets x batch-steps) to
    # O(batch-steps).
    ragged: bool = False
    # Optional footprint budget for ragged coalescing: max live (un-padded)
    # pixels per request group, summed over the routed buckets of its
    # members.  A group exceeding it is split greedily in arrival order.
    # 0 = no cap (max_batch alone bounds the group).
    ragged_batch_pixels: int = 0
    # How cuDNN picks its convolution algorithms for the graphs the engine
    # captures: "benchmark" times the candidates in each process (the
    # fastest, but the pick can differ between processes at near ties);
    # "heuristic" takes cuDNN's heuristic order, the same in every process
    # for a shape and a card.
    cudnn: str = "benchmark"

    def __post_init__(self):
        if self.batch_steps is None:
            object.__setattr__(self, "batch_steps",
                               default_batch_steps(self.max_batch))
        if not self.buckets:
            raise ValueError("at least one resolution bucket is required")
        for h, w in self.buckets:
            if h % 8 or w % 8:
                raise ValueError(f"bucket ({h}, {w}): sides must be "
                                 f"multiples of 8")
        if self.cudnn not in CUDNN_MODES:
            raise ValueError(f"cudnn must be one of {CUDNN_MODES}, "
                             f"got {self.cudnn!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.dp_devices < 1:
            raise ValueError(f"dp_devices must be >= 1, got {self.dp_devices}")
        if self.iters_policy is not None:
            parse_iters_policy(self.iters_policy)   # typo -> raise, up front
        if self.max_sessions < 0:
            raise ValueError(f"max_sessions must be >= 0 (0 disables "
                             f"streaming), got {self.max_sessions}")
        if not self.session_ttl_s > 0:
            raise ValueError(f"session_ttl_s must be > 0, "
                             f"got {self.session_ttl_s}")
        if self.chaos:
            from .faults import parse_chaos_spec
            parse_chaos_spec(self.chaos)    # typo -> raise, up front
        if self.breaker_window < 0:
            raise ValueError(f"breaker_window must be >= 0 (0 disables "
                             f"the breaker), got {self.breaker_window}")
        if self.breaker_window and not 0.0 < self.breaker_threshold <= 1.0:
            raise ValueError(f"breaker_threshold must be in (0, 1], "
                             f"got {self.breaker_threshold}")
        if self.breaker_window and not self.breaker_cooldown_s > 0:
            raise ValueError(f"breaker_cooldown_s must be > 0, "
                             f"got {self.breaker_cooldown_s}")
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError(f"trace_sample must be in [0, 1] (0 disables "
                             f"tracing), got {self.trace_sample}")
        if self.trace_sample > 0:
            if self.slo_pair_ms <= 0 or self.slo_stream_ms <= 0:
                raise ValueError("slo_pair_ms and slo_stream_ms must be "
                                 "> 0 while tracing is on")
            if not 0.0 < self.slo_budget <= 1.0:
                raise ValueError(f"slo_budget must be in (0, 1], "
                                 f"got {self.slo_budget}")
            if self.slo_window < 1 or self.flightrec_traces < 1:
                raise ValueError("slo_window and flightrec_traces must "
                                 "be >= 1")
        if self.engine_retries < 0:
            raise ValueError(f"engine_retries must be >= 0, "
                             f"got {self.engine_retries}")
        if self.retry_backoff_ms < 0 or self.degraded_window_s < 0:
            raise ValueError("retry_backoff_ms and degraded_window_s "
                             "must be >= 0")
        if self.history_interval_s < 0:
            raise ValueError(f"history_interval_s must be >= 0 (0 disables "
                             f"the metric history), got "
                             f"{self.history_interval_s}")
        if self.history_interval_s > 0 and self.history_window < 2:
            raise ValueError("history_window must be >= 2 (rates and "
                             "percentiles need two samples)")
        if self.anomaly and self.history_interval_s > 0:
            from ..telemetry.anomaly import AnomalyConfig
            AnomalyConfig(window_s=self.anomaly_window_s,
                          baseline_s=self.anomaly_baseline_s)  # validate
        steps = tuple(sorted(set(self.batch_steps)))
        if not steps or steps[0] < 1:
            raise ValueError(f"batch_steps must be positive, got {steps}")
        if self.dp_devices > 1:
            # the batch splits evenly over the devices, so every executed
            # size must divide: round each step UP to a multiple of N
            n = self.dp_devices
            steps = tuple(sorted({-(-s // n) * n for s in steps}))
        if steps[-1] < self.max_batch:
            raise ValueError(f"largest batch step {steps[-1]} < max_batch "
                             f"{self.max_batch}: full batches could never run")
        object.__setattr__(self, "batch_steps", steps)
        object.__setattr__(self, "buckets", tuple(self.buckets))
        if self.ragged_batch_pixels < 0:
            raise ValueError(f"ragged_batch_pixels must be >= 0 (0 = no "
                             f"cap), got {self.ragged_batch_pixels}")
        if self.ragged and self.dp_devices > 1:
            raise NotImplementedError(
                "ragged serving under dp_devices > 1 is not wired: the "
                "ragged model entry points are single-mesh; use dense "
                "buckets or dp_devices=1")

    @property
    def max_box(self) -> Tuple[int, int]:
        """The shared ragged max box: componentwise max over the declared
        buckets (every bucket embeds corner-anchored inside it)."""
        return (max(h for h, _ in self.buckets),
                max(w for _, w in self.buckets))

    def route(self, h: int, w: int):
        """Smallest declared bucket containing (h, w), or None — minimal
        padding wins; ties break toward fewer padded pixels."""
        best = None
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                if best is None or bh * bw < best[0] * best[1]:
                    best = (bh, bw)
        return best

    def pad_batch_to(self, n: int) -> int:
        """Smallest compiled batch step >= n (n is capped at max_batch by
        the batcher, and max_batch <= max(batch_steps) by construction)."""
        for s in self.batch_steps:
            if s >= n:
                return s
        return self.batch_steps[-1]
