"""Bounded metric history + windowed rate/percentile derivations.

A point-in-time ``/metrics`` scrape answers "what is the queue depth *now*";
nothing in the process remembers the last five minutes, so a latency drift
or a post-warmup cache-miss trickle is invisible until a human diffs BENCH
artifacts.  This module is the time axis of the observability spine
(OBSERVABILITY.md "Time-series & anomaly detection"):

* :class:`MetricHistory` — a ring buffer of ``Registry.snapshot()`` samples
  taken on a background interval, spilled to ``metrics_ts.jsonl`` with
  run-manifest provenance so ``tlm top --replay`` can reconstruct the run.
* windowed derivations over *pairs of snapshots*: counter rates
  (restart/reset tolerant), histogram-delta percentiles (p50/p95 of the
  observations that landed *between* two samples, from the cumulative
  ``_bucket{le=}`` counts), and delta means.
* :func:`prom_to_snapshot` — converts a ``parse_prom_text`` flat scrape
  (``{'name{labels}': value}``) into the same nested snapshot shape, so the
  fleet router's :class:`ScrapeHistory` over replica ``/metrics`` bodies
  reuses the exact derivation path the in-process history uses.

Everything here is stdlib-only and jax-free — ``tools/tlm.py`` imports it
for the dashboard replay, and the anomaly sentinels
(:mod:`raft_tpu_torch.telemetry.anomaly`) evaluate over these rings.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..lint.concurrency import guarded_by

# ---------------------------------------------------------------------------
# Snapshot-pair math (pure functions — the unit-tested core)
# ---------------------------------------------------------------------------


def counter_increase(v0: float, v1: float) -> float:
    """Monotonic increase between two counter readings.  A reading that
    went *down* means the process restarted (counters never decrease), so
    the whole new value is the increase — the standard Prometheus
    ``increase()`` reset rule."""
    return v1 if v1 < v0 else v1 - v0


def bucket_delta(b0: Optional[dict], b1: dict) -> Dict[str, float]:
    """Per-bucket increase between two CUMULATIVE ``{le: count}`` dicts
    (the ``buckets`` field of a histogram snapshot).  Reset-tolerant: if
    any cumulative count decreased, the earlier sample is from a previous
    process life and the later snapshot alone is the delta."""
    b0 = b0 or {}
    if any(b1.get(le, 0) < c for le, c in b0.items()):
        b0 = {}
    return {le: c - b0.get(le, 0) for le, c in b1.items()}


def delta_percentile(b0: Optional[dict], b1: dict,
                     q: float) -> Optional[float]:
    """q-percentile of the observations recorded BETWEEN two cumulative
    bucket snapshots, by linear interpolation inside the bucket that
    crosses rank q·N (the textbook ``histogram_quantile`` estimate).

    Returns None when no observations landed in the window — a quiet
    interval has no latency, not a zero latency.  The +Inf bucket clamps
    to the largest finite bound (there is no upper edge to interpolate
    toward), matching Prometheus semantics."""
    delta = bucket_delta(b0, b1)
    pairs = sorted(((float("inf") if le == "+Inf" else float(le)), c)
                   for le, c in delta.items())
    total = pairs[-1][1] if pairs else 0
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in pairs:
        if cum >= rank:
            if bound == math.inf:
                return prev_bound   # clamp: no finite upper edge
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound   # unreachable: the last cum IS total ≥ rank


def _family_child(v, label: Optional[str]):
    """Resolve a snapshot entry — scalar, histogram dict, or labeled
    family ``{joined label values: child}`` — to one child's value."""
    if not isinstance(v, dict):
        return v if label is None else None
    if "buckets" in v or "count" in v:       # unlabeled histogram
        return v if label is None else None
    if label is not None:
        return v.get(label)
    return v


def rate_between(s0: dict, s1: dict, name: str,
                 label: Optional[str] = None) -> Optional[float]:
    """Counter rate (per second) between two snapshots, reset-tolerant."""
    dt = s1.get("_scrape_time", 0) - s0.get("_scrape_time", 0)
    v0 = _family_child(s0.get(name), label)
    v1 = _family_child(s1.get(name), label)
    if dt <= 0 or not isinstance(v0, (int, float)) \
            or not isinstance(v1, (int, float)):
        return None
    return counter_increase(v0, v1) / dt


def percentile_between(s0: dict, s1: dict, name: str, q: float,
                       label: Optional[str] = None) -> Optional[float]:
    """Histogram-delta percentile between two snapshots (None when the
    metric is absent or the window saw no observations)."""
    h0 = _family_child(s0.get(name), label)
    h1 = _family_child(s1.get(name), label)
    if not isinstance(h1, dict) or "buckets" not in h1:
        return None
    b0 = h0.get("buckets") if isinstance(h0, dict) else None
    return delta_percentile(b0, h1["buckets"], q)


def mean_between(s0: dict, s1: dict, name: str,
                 label: Optional[str] = None) -> Optional[float]:
    """Mean of the observations between two histogram snapshots
    (delta-sum / delta-count, reset-tolerant)."""
    h0 = _family_child(s0.get(name), label)
    h1 = _family_child(s1.get(name), label)
    if not isinstance(h1, dict) or "count" not in h1:
        return None
    c0 = h0.get("count", 0) if isinstance(h0, dict) else 0
    u0 = h0.get("sum", 0.0) if isinstance(h0, dict) else 0.0
    dc = counter_increase(c0, h1["count"])
    du = h1["sum"] - u0 if h1["count"] >= c0 else h1["sum"]
    return du / dc if dc > 0 else None


def gauge_at(snap: dict, name: str,
             label: Optional[str] = None) -> Optional[float]:
    """Instantaneous gauge value at one snapshot; with ``label=None`` on a
    labeled family, the SUM over children (e.g. total active anomalies)."""
    v = snap.get(name)
    if isinstance(v, dict) and "buckets" not in v and "count" not in v:
        if label is not None:
            v = v.get(label)
        else:
            vals = [c for c in v.values() if isinstance(c, (int, float))]
            return sum(vals) if vals else None
    elif label is not None:
        return None
    return v if isinstance(v, (int, float)) else None


# ---------------------------------------------------------------------------
# Derived panels — the named series /debug/history and ``tlm top`` show
# ---------------------------------------------------------------------------

# (series name, kind, metric, extra) — kind ∈ rate | pctl | hmean | gauge.
# One spec table so the server endpoint, the fleet scrape, and the jsonl
# replay all derive identical series from whatever metrics are present
# (absent family → None points, never an error).
DEFAULT_PANELS: Tuple[Tuple[str, str, str, tuple], ...] = (
    ("pairs_per_s", "rate", "raft_serving_pairs_total", ()),
    ("p50_ms", "pctl", "raft_serving_request_latency_seconds", (0.50, 1e3)),
    ("p95_ms", "pctl", "raft_serving_request_latency_seconds", (0.95, 1e3)),
    ("occupancy", "hmean", "raft_serving_batch_occupancy", ()),
    ("queue_depth", "gauge", "raft_serving_queue_depth", ()),
    ("burn_pair", "gauge", "raft_slo_burn_rate", ("pair",)),
    ("burn_stream", "gauge", "raft_slo_burn_rate", ("stream",)),
    ("sessions", "gauge", "raft_stream_sessions_active", ()),
    ("compile_miss_per_s", "rate",
     "raft_serving_compile_cache_misses_total", ()),
    ("engine_cache_miss_per_s", "rate",
     "raft_engine_cache_misses_total", ()),
    ("shed_per_s", "rate", "raft_serving_requests_total", ("shed",)),
    ("anomalies", "gauge", "raft_anomaly_active", ()),
)


def derive_point(s0: dict, s1: dict,
                 panels=DEFAULT_PANELS) -> Dict[str, Optional[float]]:
    """One derived point from a consecutive snapshot pair (rates and
    percentiles describe the window s0→s1; gauges are read at s1)."""
    out: Dict[str, Optional[float]] = {}
    for name, kind, metric, extra in panels:
        if kind == "rate":
            v = rate_between(s0, s1, metric, *extra)
        elif kind == "pctl":
            q, scale = extra
            v = percentile_between(s0, s1, metric, q)
            v = v * scale if v is not None else None
        elif kind == "hmean":
            v = mean_between(s0, s1, metric, *extra)
        else:
            v = gauge_at(s1, metric, *extra)
        out[name] = round(v, 6) if isinstance(v, float) else v
    return out


def derive_series(samples: Sequence[dict],
                  panels=DEFAULT_PANELS) -> Dict[str, list]:
    """Columnar derived series over a sample list (``[{'t':..,'snap':..}]``,
    oldest first) — the /debug/history response body and the dashboard's
    input.  N samples yield N-1 points (each describes one interval)."""
    cols: Dict[str, list] = {"t": []}
    for name, *_ in panels:
        cols[name] = []
    for s0, s1 in zip(samples, samples[1:]):
        cols["t"].append(round(s1["t"], 3))
        for name, v in derive_point(s0["snap"], s1["snap"], panels).items():
            cols[name].append(v)
    return cols


# ---------------------------------------------------------------------------
# Prom-text scrape → snapshot (the fleet router's ingest path)
# ---------------------------------------------------------------------------


def _parse_flat_key(key: str) -> Tuple[str, Dict[str, str]]:
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    if rest:
        for pair in rest.rstrip("}").split(","):
            k, _, v = pair.partition("=")
            labels[k.strip()] = v.strip().strip('"')
    return name, labels


def prom_to_snapshot(flat: Dict[str, float],
                     scrape_time: Optional[float] = None) -> dict:
    """Reshape a ``parse_prom_text`` flat dict (``{'name{labels}': v}``)
    into the ``Registry.snapshot()`` nested form, so scraped replica
    metrics flow through the same rate/percentile derivations as
    in-process snapshots.  Histogram ``_bucket``/``_sum``/``_count``
    samples fold back into ``{"count", "sum", "buckets"}``; other labeled
    samples become ``{joined label values: value}`` families."""
    snap: dict = {}
    hists: Dict[str, dict] = {}
    hist_bases = {k.partition("{")[0][:-len("_bucket")] for k in flat
                  if k.partition("{")[0].endswith("_bucket")
                  and 'le="' in k}
    for key, v in flat.items():
        name, labels = _parse_flat_key(key)
        if name.endswith("_bucket") and "le" in labels:
            h = hists.setdefault(name[:-len("_bucket")],
                                 {"count": 0, "sum": 0.0, "buckets": {}})
            h["buckets"][labels["le"]] = v
        elif name.endswith("_sum") and name[:-len("_sum")] in hist_bases:
            hists.setdefault(name[:-len("_sum")],
                             {"count": 0, "sum": 0.0, "buckets": {}})["sum"] = v
        elif name.endswith("_count") and name[:-len("_count")] in hist_bases:
            hists.setdefault(name[:-len("_count")],
                             {"count": 0, "sum": 0.0, "buckets": {}})["count"] = v
        elif labels:
            fam = snap.setdefault(name, {})
            if isinstance(fam, dict):
                fam[",".join(labels.values()) or "_"] = v
        else:
            snap[name] = v
    snap.update(hists)
    snap["_scrape_time"] = time.time() if scrape_time is None else scrape_time
    return snap


# ---------------------------------------------------------------------------
# The histories
# ---------------------------------------------------------------------------


class MetricHistory:
    """Bounded ring of ``Registry.snapshot()`` samples taken on a
    background interval, with optional ``metrics_ts.jsonl`` spill.

    The sampler thread is decoupled from the request path (the TensorFlow
    paper's "continuous runtime introspection off the step path"): it costs
    one registry snapshot per interval — dict copies and gauge callbacks,
    no device work.  ``on_sample`` callbacks (the anomaly monitor) run on
    the sampler thread AFTER the ring append, outside the history lock.

    The spill file leads with a ``{"kind": "manifest", ...}`` line when a
    run manifest is supplied (provenance-first, the events.jsonl idiom),
    then one ``{"kind": "sample", "t":, "snap":}`` line per sample —
    ``tlm top --replay`` reconstructs the exact live derivation from it.
    """

    _ring = guarded_by("_lock")
    _file = guarded_by("_lock")

    def __init__(self, registry, interval_s: float = 1.0, window: int = 600,
                 path: Optional[str] = None, manifest: Optional[dict] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.interval_s = float(interval_s)
        self.window = int(window)
        self.path = path
        self._now = now_fn
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.window)
        self._file = None
        self._callbacks: List[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if path:
            self._file = open(path, "a", encoding="utf-8")
            if manifest is not None:
                self._file.write(json.dumps(
                    {"kind": "manifest", **manifest}) + "\n")
                self._file.flush()

    # -- sampling ----------------------------------------------------------

    def on_sample(self, cb: Callable[[dict], None]) -> None:
        """Register a callback fired with each new sample (sampler thread,
        no lock held) — the anomaly monitor's evaluation hook."""
        self._callbacks.append(cb)

    def sample(self) -> dict:
        """Take one sample now: snapshot the registry, append to the ring,
        spill, fire callbacks.  Also callable directly (tests, final
        flush) — the background thread just calls this on a timer."""
        snap = self.registry.snapshot()            # registry's own locks
        rec = {"t": snap.get("_scrape_time", time.time()), "snap": snap}
        with self._lock:
            self._ring.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(
                    {"kind": "sample", **rec}) + "\n")
                self._file.flush()
        for cb in list(self._callbacks):
            try:
                cb(rec)
            except Exception:
                pass        # a broken sentinel must not kill the sampler
        return rec

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="metric-history", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Idempotent: stop the sampler, take one final sample (so short
        runs spill at least one), close the spill file."""
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self.sample()
        with self._lock:
            f, self._file = self._file, None
        if f is not None:
            f.close()

    # -- queries -----------------------------------------------------------

    def samples(self, window_s: Optional[float] = None) -> List[dict]:
        """Ring contents (oldest first), optionally clipped to the trailing
        ``window_s`` seconds."""
        with self._lock:
            out = list(self._ring)
        if window_s is not None and out:
            cutoff = out[-1]["t"] - window_s
            out = [r for r in out if r["t"] >= cutoff]
        return out

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def rate(self, name: str, window_s: Optional[float] = None,
             label: Optional[str] = None) -> Optional[float]:
        s = self.samples(window_s)
        return rate_between(s[0]["snap"], s[-1]["snap"], name,
                            label) if len(s) >= 2 else None

    def percentile(self, name: str, q: float,
                   window_s: Optional[float] = None,
                   label: Optional[str] = None) -> Optional[float]:
        s = self.samples(window_s)
        return percentile_between(s[0]["snap"], s[-1]["snap"], name, q,
                                  label) if len(s) >= 2 else None

    def window_json(self, window_s: Optional[float] = None,
                    panels=DEFAULT_PANELS) -> dict:
        """The ``GET /debug/history`` response body: derived columnar
        series over the (optionally clipped) ring."""
        s = self.samples(window_s)
        return {"interval_s": self.interval_s, "retained": len(s),
                "window": self.window,
                "span_s": round(s[-1]["t"] - s[0]["t"], 3) if len(s) > 1
                else 0.0,
                "series": derive_series(s, panels)}


class ScrapeHistory:
    """Per-source ring of scraped snapshots — the fleet router's view of
    its replicas.  Each ``ingest(source, flat_prom_dict)`` reshapes the
    scrape via :func:`prom_to_snapshot` and appends to that source's ring,
    so per-replica rates/percentiles use the same math as in-process
    histories and replica skew is a cross-ring comparison."""

    _rings = guarded_by("_lock")

    def __init__(self, window: int = 600):
        self.window = int(window)
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}

    def ingest(self, source: str, flat: Dict[str, float],
               scrape_time: Optional[float] = None) -> dict:
        snap = prom_to_snapshot(flat, scrape_time)
        rec = {"t": snap["_scrape_time"], "snap": snap}
        with self._lock:
            ring = self._rings.get(source)
            if ring is None:
                ring = self._rings[source] = collections.deque(
                    maxlen=self.window)
            ring.append(rec)
        return rec

    def forget(self, source: str) -> None:
        """Drop a source's ring (replica died/replaced — its counters
        restart and its history is no longer comparable)."""
        with self._lock:
            self._rings.pop(source, None)

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def samples(self, source: str,
                window_s: Optional[float] = None) -> List[dict]:
        with self._lock:
            ring = self._rings.get(source)
            out = list(ring) if ring else []
        if window_s is not None and out:
            cutoff = out[-1]["t"] - window_s
            out = [r for r in out if r["t"] >= cutoff]
        return out

    def percentile(self, source: str, name: str, q: float,
                   window_s: Optional[float] = None) -> Optional[float]:
        s = self.samples(source, window_s)
        return percentile_between(s[0]["snap"], s[-1]["snap"], name,
                                  q) if len(s) >= 2 else None

    def window_json(self, window_s: Optional[float] = None,
                    panels=DEFAULT_PANELS) -> dict:
        """Per-source derived series — the router's ``/debug/history``."""
        return {"sources": {
            src: derive_series(self.samples(src, window_s), panels)
            for src in self.sources()}}


def load_metrics_ts(path: str) -> Tuple[Optional[dict], List[dict]]:
    """Read a ``metrics_ts.jsonl`` spill back into (manifest, samples) —
    the ``tlm top --replay`` input.  Tolerates a torn final line (the
    process may have died mid-write)."""
    manifest, samples = None, []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "manifest":
                manifest = rec
            elif rec.get("kind") == "sample":
                samples.append({"t": rec["t"], "snap": rec["snap"]})
    return manifest, samples
