"""Rule-driven anomaly sentinels over the metric history.

The recovery plane (chaos drills, self-healing batcher, fleet respawn) is
complete; this is the DETECTION plane the ROADMAP north-star needs — the
running system watching its own last five minutes instead of waiting for a
human to diff BENCH artifacts.  Six rules evaluate over a
:class:`~raft_tpu_torch.telemetry.timeseries.MetricHistory` ring on every sample
(OBSERVABILITY.md "Time-series & anomaly detection" has the rule table):

* ``p95_drift``       — recent p95 request latency ≫ the trailing baseline
* ``burn_accel``      — SLO burn rate at/above budget and not improving
* ``occupancy_collapse`` — traffic flowing but batches mostly padding
* ``queue_growth``    — admission queue depth growing across the window
* ``miss_trickle``    — post-warmup compile / engine-cache misses or XLA
                        recompiles (the no-recompile-storm guarantee,
                        watched continuously instead of only in bench)
* ``restart_rate``    — batcher restarts / replica respawns / training
                        rollbacks inside one window (healing is working —
                        but something keeps breaking)

Each rule is a pure function ``(samples, config) -> Optional[str]``
(a reason string when firing, None when quiet) so tests drive them with
synthetic histories.  :class:`AnomalyMonitor` owns the edge logic: a
rising edge emits an ``anomaly`` run-log event, sets
``raft_anomaly_active{rule=}`` to 1, and — on the FIRST fire of the run —
dumps the flight recorder (the traces that explain the anomaly must not
be evicted by the traffic that caused it); a falling edge clears the
gauge and logs the recovery.  The fleet wires ``active_count`` into the
autoscaler's signal dict and :func:`replica_skew` into the router's drain
candidate selection.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..lint.concurrency import guarded_by
from .timeseries import (MetricHistory, counter_increase, gauge_at,
                         mean_between, percentile_between, rate_between)

LATENCY = "raft_serving_request_latency_seconds"
OCCUPANCY = "raft_serving_batch_occupancy"
PAIRS = "raft_serving_pairs_total"
QUEUE = "raft_serving_queue_depth"
BURN = "raft_slo_burn_rate"

# post-warmup these must all be flat; any increase is a trickle
MISS_COUNTERS = ("raft_serving_compile_cache_misses_total",
                 "raft_serving_xla_recompiles_total",
                 "raft_engine_cache_misses_total")

# self-healing activity: each increase means a component died and healed
RESTART_COUNTERS = ("raft_batcher_restarts_total",
                    "raft_fleet_replica_restarts",
                    "raft_train_rollbacks_total",
                    "raft_data_worker_respawns_total")


@dataclasses.dataclass
class AnomalyConfig:
    """Sentinel knobs — defaults tuned for the serve_bench smoke scale
    (seconds-long phases, ~1 s sampling); production fleets widen the
    windows via --anomaly-* flags."""

    window_s: float = 15.0        # recent window every rule evaluates over
    baseline_s: float = 60.0      # trailing baseline for the drift rule
    min_samples: int = 3          # fewer recent samples -> all rules quiet
    p95_drift_factor: float = 2.0    # recent p95 > factor * baseline p95
    p95_floor_s: float = 0.050       # ...and above this (noise floor)
    burn_threshold: float = 1.0      # burning >= the whole error budget
    occupancy_floor: float = 0.30    # mean occupancy below this = collapse
    queue_growth_factor: float = 2.0
    queue_min: float = 4.0           # depth below this never fires
    miss_trickle_min: float = 1.0    # post-warmup misses in the window
    restart_rate_min: float = 2.0    # heal events in one window

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError("anomaly window_s must be > 0")
        if self.baseline_s <= self.window_s:
            raise ValueError("anomaly baseline_s must exceed window_s")


def _split(samples: Sequence[dict], cfg: AnomalyConfig):
    """(baseline, recent) partition of the ring by the recent window."""
    if not samples:
        return [], []
    cut = samples[-1]["t"] - cfg.window_s
    recent = [s for s in samples if s["t"] >= cut]
    baseline = [s for s in samples if s["t"] < cut]
    return baseline, recent


def rule_p95_drift(samples, cfg: AnomalyConfig) -> Optional[str]:
    """Recent-window p95 request latency vs the trailing baseline window:
    the drift a point-in-time scrape can never see."""
    baseline, recent = _split(samples, cfg)
    baseline = [s for s in baseline
                if s["t"] >= samples[-1]["t"] - cfg.baseline_s]
    if len(recent) < cfg.min_samples or len(baseline) < 2:
        return None
    now = percentile_between(recent[0]["snap"], recent[-1]["snap"],
                             LATENCY, 0.95)
    base = percentile_between(baseline[0]["snap"], baseline[-1]["snap"],
                              LATENCY, 0.95)
    if now is None or base is None or base <= 0:
        return None
    if now >= cfg.p95_floor_s and now > cfg.p95_drift_factor * base:
        return (f"p95 {now * 1e3:.1f}ms > {cfg.p95_drift_factor:g}x "
                f"baseline {base * 1e3:.1f}ms")
    return None


def rule_burn_accel(samples, cfg: AnomalyConfig) -> Optional[str]:
    """SLO burn at/above the whole error budget and not improving across
    the window (max over request classes — any class burning is bad)."""
    _, recent = _split(samples, cfg)
    if len(recent) < cfg.min_samples:
        return None
    now = gauge_at(recent[-1]["snap"], BURN)       # None when tracing off
    past = gauge_at(recent[0]["snap"], BURN)
    if now is None:
        return None
    # labeled family: gauge_at sums children; a per-class max is stricter
    fam = recent[-1]["snap"].get(BURN)
    if isinstance(fam, dict):
        vals = [v for v in fam.values() if isinstance(v, (int, float))]
        now = max(vals) if vals else None
        pfam = recent[0]["snap"].get(BURN)
        if isinstance(pfam, dict):
            pvals = [v for v in pfam.values()
                     if isinstance(v, (int, float))]
            past = max(pvals) if pvals else 0.0
    if now is not None and now >= cfg.burn_threshold \
            and (past is None or now >= past):
        return f"burn {now:.2f} >= {cfg.burn_threshold:g} and not falling"
    return None


def rule_occupancy_collapse(samples, cfg: AnomalyConfig) -> Optional[str]:
    """Traffic flowing but device batches mostly padding — the throughput
    engine idling while users wait (bucket fragmentation, skewed load)."""
    _, recent = _split(samples, cfg)
    if len(recent) < cfg.min_samples:
        return None
    occ = mean_between(recent[0]["snap"], recent[-1]["snap"], OCCUPANCY)
    tput = rate_between(recent[0]["snap"], recent[-1]["snap"], PAIRS)
    if occ is not None and tput and tput > 0 \
            and occ < cfg.occupancy_floor:
        return (f"occupancy {occ:.2f} < {cfg.occupancy_floor:g} "
                f"at {tput:.1f} pairs/s")
    return None


def rule_queue_growth(samples, cfg: AnomalyConfig) -> Optional[str]:
    """Admission queue deepening across the window — arrivals outrunning
    service; the precursor of sheds and SLO burn."""
    _, recent = _split(samples, cfg)
    if len(recent) < cfg.min_samples:
        return None
    first = gauge_at(recent[0]["snap"], QUEUE)
    last = gauge_at(recent[-1]["snap"], QUEUE)
    if first is None or last is None:
        return None
    if last >= cfg.queue_min and last >= cfg.queue_growth_factor * first:
        return (f"queue {first:g} -> {last:g} "
                f"(x{cfg.queue_growth_factor:g} over window)")
    return None


def rule_miss_trickle(samples, cfg: AnomalyConfig) -> Optional[str]:
    """Post-warmup compile-cache / engine-cache misses or XLA recompiles:
    after arm() every one of these counters must be FLAT; a trickle means
    an unexpected shape or a cold executable on the hot path."""
    _, recent = _split(samples, cfg)
    if len(recent) < cfg.min_samples:
        return None
    incs = []
    for name in MISS_COUNTERS:
        v0 = recent[0]["snap"].get(name)
        v1 = recent[-1]["snap"].get(name)
        if isinstance(v0, (int, float)) and isinstance(v1, (int, float)):
            d = counter_increase(v0, v1)
            if d > 0:
                incs.append((name, d))
    if incs and sum(d for _, d in incs) >= cfg.miss_trickle_min:
        return "post-warmup " + ", ".join(f"{n}+{d:g}" for n, d in incs)
    return None


def rule_restart_rate(samples, cfg: AnomalyConfig) -> Optional[str]:
    """Self-healing churn: restarts / respawns / rollbacks inside one
    window.  Each individual heal is by design; a RATE of them means a
    persistent fault the ladder keeps absorbing instead of fixing."""
    _, recent = _split(samples, cfg)
    if len(recent) < cfg.min_samples:
        return None
    incs = []
    for name in RESTART_COUNTERS:
        v0 = recent[0]["snap"].get(name)
        v1 = recent[-1]["snap"].get(name)
        if isinstance(v0, (int, float)) and isinstance(v1, (int, float)):
            d = counter_increase(v0, v1)
            if d > 0:
                incs.append((name, d))
    total = sum(d for _, d in incs)
    if total >= cfg.restart_rate_min:
        detail = ", ".join(f"{n}+{d:g}" for n, d in incs)
        return f"{total:g} heal events in window ({detail})"
    return None


RULES: Dict[str, Callable] = {
    "p95_drift": rule_p95_drift,
    "burn_accel": rule_burn_accel,
    "occupancy_collapse": rule_occupancy_collapse,
    "queue_growth": rule_queue_growth,
    "miss_trickle": rule_miss_trickle,
    "restart_rate": rule_restart_rate,
}


def replica_skew(p95_by_source: Dict[str, float], factor: float = 3.0,
                 floor_s: float = 0.050) -> List[str]:
    """Sources whose p95 ≫ the median of their siblings — the router's
    drain-candidate signal (one replica running hot while the fleet is
    fine is a replica problem, not a load problem).  Needs ≥ 3 sources:
    with two, 'the median of the siblings' is just the other replica and
    either could be the outlier."""
    vals = {s: v for s, v in p95_by_source.items() if v is not None}
    if len(vals) < 3:
        return []
    ordered = sorted(vals.values())
    median = ordered[len(ordered) // 2]
    return sorted(s for s, v in vals.items()
                  if v >= floor_s and median > 0 and v > factor * median)


class AnomalyMonitor:
    """Edge-triggered sentinel evaluation over a :class:`MetricHistory`.

    Registered as an ``on_sample`` callback; quiet until :meth:`arm` (the
    warmup's compile storm and the cold queue would fire every rule).
    Rising edge: ``raft_anomaly_active{rule=}`` → 1,
    ``raft_anomaly_fires_total{rule=}`` ++, an ``anomaly`` run-log event
    with the reason, and — first fire of the run only — a flight-recorder
    dump.  Falling edge: gauge → 0 and a clearing event.  ``fired_at``
    keeps the first-fire timestamp per rule so serve_bench can report
    detection latency against its fault-injection clock.
    """

    _active = guarded_by("_lock")

    def __init__(self, history: MetricHistory, registry,
                 run_log=None, flightrec=None,
                 config: Optional[AnomalyConfig] = None,
                 rules: Optional[Dict[str, Callable]] = None,
                 log_fn: Callable[[str], None] = lambda s: None):
        self.history = history
        self.config = config or AnomalyConfig()
        self.rules = dict(rules if rules is not None else RULES)
        self.run_log = run_log
        self.flightrec = flightrec
        self._log = log_fn
        self._lock = threading.Lock()
        self._armed = False
        self._active: Dict[str, str] = {}     # rule -> current reason
        self.fired_at: Dict[str, float] = {}  # rule -> first fire time
        self.total_fires = 0
        self.gauge = registry.get_or_gauge(
            "raft_anomaly_active",
            "1 while the sentinel rule is firing, 0 otherwise "
            "(OBSERVABILITY.md rule table)", labelnames=("rule",))
        self.fires = registry.get_or_counter(
            "raft_anomaly_fires_total",
            "Rising edges per sentinel rule since start",
            labelnames=("rule",))
        for rule in self.rules:
            self.gauge.labels(rule)           # pre-create: exposition has 0
            self.fires.labels(rule)
        history.on_sample(self.evaluate)

    def arm(self) -> None:
        """Start judging — call after warmup, the moment the steady-state
        invariants (no compiles, bounded queue) are supposed to hold."""
        with self._lock:
            self._armed = True

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed

    def active(self) -> Dict[str, str]:
        """Currently-firing rules and their reasons (healthz / tests)."""
        with self._lock:
            return dict(self._active)

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def evaluate(self, rec: Optional[dict] = None) -> Dict[str, str]:
        """One evaluation pass over the history (the on_sample hook; also
        directly callable).  Returns the post-pass active map."""
        if not self.armed:
            return {}
        samples = self.history.samples(self.config.baseline_s * 2)
        fired: Dict[str, str] = {}
        for name, fn in self.rules.items():
            try:
                reason = fn(samples, self.config)
            except Exception:
                reason = None                 # a broken rule stays quiet
            if reason:
                fired[name] = reason
        with self._lock:
            rising = {n: r for n, r in fired.items()
                      if n not in self._active}
            falling = [n for n in self._active if n not in fired]
            self._active = fired
            first_ever = self.total_fires == 0 and bool(rising)
            self.total_fires += len(rising)
            now = time.time()
            for n in rising:
                self.fired_at.setdefault(n, now)
        for name, reason in rising.items():
            self.gauge.labels(name).set(1)
            self.fires.labels(name).inc()
            self._log(f"[anomaly] FIRE {name}: {reason}")
            if self.run_log is not None:
                self.run_log.event("anomaly", rule=name, edge="fire",
                                   reason=reason)
        for name in falling:
            self.gauge.labels(name).set(0)
            self._log(f"[anomaly] clear {name}")
            if self.run_log is not None:
                self.run_log.event("anomaly", rule=name, edge="clear")
        if first_ever and self.flightrec is not None:
            first = next(iter(rising))
            self.flightrec.dump(f"anomaly:{first}")
        return fired
