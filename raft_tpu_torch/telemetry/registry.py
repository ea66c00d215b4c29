"""Stdlib-only metric primitives shared by serving, training, and bench.

A deliberately small surface — Counter / Gauge / Histogram + a Registry
that renders the text exposition format (the subset Prometheus,
VictoriaMetrics and friends all scrape) — so observability costs zero
dependencies.  All mutation is lock-guarded; ``observe``/``inc`` are a dict
update and an add, cheap enough to sit on the request path.

The port's copy of the JAX package's ``telemetry/registry.py``: one
``/metrics`` format across both packages (the serving metric set lives in
``serving/metrics.py``).

Labels: a metric constructed with ``labelnames`` is a family; ``labels(v)``
returns (creating on first use) the child for that label-value tuple.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared family plumbing: child lookup keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        if not self.labelnames:
            self._children[()] = self

    def _make_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def labels(self, *values: str) -> "_Metric":
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected {len(self.labelnames)} "
                             f"label value(s), got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _label_str(self, values: Tuple[str, ...],
                   extra: str = "") -> str:
        pairs = [f'{k}="{v}"' for k, v in zip(self.labelnames, values)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def _sample_lines(self) -> Iterable[str]:
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            lines.extend(child._render_samples(self, values))
        return "\n".join(lines)

    def _render_samples(self, family: "_Metric",
                        values: Tuple[str, ...]) -> Iterable[str]:
        raise NotImplementedError

    def _snapshot_value(self):
        raise NotImplementedError

    def snapshot(self) -> dict:
        """JSON-able view of the family — the run-event-log counterpart of
        ``render()`` (events.jsonl records, tlm summary/compare)."""
        with self._lock:
            children = list(self._children.items())
        if self.labelnames:
            return {",".join(v) or "_": c._snapshot_value()
                    for v, c in children}
        return self._snapshot_value()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render_samples(self, family, values):
        yield (f"{family.name}{family._label_str(values)} "
               f"{_fmt(self.value)}")

    def _snapshot_value(self):
        return self.value


class Gauge(_Metric):
    """Settable value, or — with ``fn`` — sampled from a callback at render
    time (e.g. live queue depth), so the gauge can never go stale."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=(), fn=None):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn) -> None:
        """Make this gauge (or a labeled child — the family constructor
        can't reach children) a live callback sampled at render time."""
        self._fn = fn

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    def _render_samples(self, family, values):
        yield (f"{family.name}{family._label_str(values)} "
               f"{_fmt(self.value)}")

    def _snapshot_value(self):
        return self.value


DEFAULT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# GRU-iteration buckets for the ``raft_iters_used`` histogram (the
# adaptive-compute observable, OBSERVABILITY.md): integer-valued samples in
# 1..max_iters, bucketed to resolve both the small-iters regime (early
# exits under iters_policy='converge:...') and the fixed 12/32 defaults.
ITERS_USED_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 20.0,
                      24.0, 32.0, 48.0, 64.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        self._bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self._bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def _make_child(self):
        return Histogram(self.name, self.help, buckets=self._bounds)

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self._bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def _render_samples(self, family, values):
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
        cum = 0
        for bound, c in zip(self._bounds + (math.inf,), counts):
            cum += c
            le = family._label_str(values, f'le="{_fmt(bound)}"')
            yield f"{family.name}_bucket{le} {cum}"
        lbl = family._label_str(values)
        yield f"{family.name}_sum{lbl} {_fmt(s)}"
        yield f"{family.name}_count{lbl} {total}"

    def _snapshot_value(self):
        """count/sum/mean plus the CUMULATIVE per-bucket counts keyed by
        their ``le`` bound (the exposition's ``_bucket{le=}`` samples, as
        JSON) — what the time-series layer diffs between two snapshots to
        derive windowed p50/p95 (telemetry/timeseries.py
        ``delta_percentile``)."""
        with self._lock:
            count, s = self._count, self._sum
            counts = list(self._counts)
        cum, buckets = 0, {}
        for bound, c in zip(self._bounds + (math.inf,), counts):
            cum += c
            buckets[_fmt(bound)] = cum
        return {"count": count, "sum": round(s, 6),
                "mean": round(s / count, 6) if count else 0.0,
                "buckets": buckets}


class Registry:
    """Ordered collection of metric families; ``render()`` is the /metrics
    response body."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help, labelnames=()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name, help, labelnames=(), fn=None) -> Gauge:
        return self.register(Gauge(name, help, labelnames, fn=fn))

    def histogram(self, name, help, labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def get_or_counter(self, name, help, labelnames=()) -> Counter:
        """Atomic get-or-create for shared registries (e.g. the process
        default): a bare ``get(...) or counter(...)`` is check-then-act and
        two threads can race into the duplicate-metric ValueError."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labelnames)
            return m

    def get_or_gauge(self, name, help, labelnames=()) -> Gauge:
        """Gauge sibling of :meth:`get_or_counter` — the data loaders share
        queue-depth/occupancy gauges on the process default registry."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help, labelnames)
            return m

    def get_or_histogram(self, name, help, labelnames=(),
                         buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        """Histogram sibling of :meth:`get_or_counter` (e.g. the input
        pipeline's ``raft_data_wait_seconds`` starvation histogram)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(name, help, labelnames,
                                                   buckets)
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"

    def snapshot(self) -> dict:
        """{metric name: value} for every family — what the run-event log
        records at end of run and ``tlm compare`` diffs.  Carries one
        private key, ``_scrape_time`` (unix seconds at sample time), so
        rate/percentile math over consecutive snapshots has a well-defined
        denominator (telemetry/timeseries.py); consumers that print or
        diff skip ``_``-prefixed keys."""
        with self._lock:
            metrics = list(self._metrics.values())
        snap = {m.name: m.snapshot() for m in metrics}
        snap["_scrape_time"] = time.time()
        return snap


_PROCESS_START = time.time()


def register_process_start_time(registry: Registry) -> Gauge:
    """``raft_process_start_time_seconds`` (the standard Prometheus
    process-uptime anchor): unix time this PROCESS imported the telemetry
    layer — constant per process, so ``scrape_time - start_time`` is
    uptime and counter-rate math can tell a restart from a reset."""
    g = registry.get_or_gauge(
        "raft_process_start_time_seconds",
        "Unix time the process started (Prometheus convention; "
        "scrape_time - this = process uptime)")
    g.set(_PROCESS_START)
    return g


# Process-default registry: subsystems without their own Registry (the data
# loaders, ad-hoc tooling) count here; a FlowServer keeps its own instance
# so per-server /metrics scrapes stay isolated.
_default: Optional[Registry] = None


def default_registry() -> Registry:
    global _default
    if _default is None:
        _default = Registry()
    return _default
