"""raft_tpu_torch.telemetry — the serving plane's observability spine.

The port's copies of the JAX package's telemetry modules (the serving
stack imports them; they import no jax):

* :mod:`registry` — Counter / Gauge / Histogram metric primitives + the
  Prometheus-text Registry.
* :mod:`events` — run manifests (git sha, torch and CUDA versions, device
  name, count and power limit, config hash, argv) and the JSONL run log.
* :mod:`trace` — ``stage(name)`` as ``torch.profiler.record_function`` +
  NVTX ranges, and ``torch.profiler`` captures (a step window, or on
  demand) written as Chrome traces.
* :mod:`watchdogs` — the capture counter, device-memory gauges and the
  runtime lock-order validator behind ``watched_lock``.
* :mod:`spans` — request-scoped tracing: spans with parent links and
  status, the flight recorder, and SLO burn accounting.
* :mod:`timeseries` — ``MetricHistory``, the bounded ring of registry
  snapshots, and the delta-window derivations behind ``/debug/history``.
* :mod:`anomaly` — rule-driven sentinels evaluated over the history.
"""

from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       Registry, DEFAULT_LATENCY_BUCKETS, default_registry,
                       register_process_start_time)
from .events import (RunLog, config_hash, read_events,  # noqa: F401
                     run_manifest, start_run)
from .log import get_logger  # noqa: F401
from .trace import TraceWindow, current_stage, stage  # noqa: F401
from .spans import (FlightRecorder, RequestTrace,  # noqa: F401
                    SLOTracker, Tracer)
from .timeseries import (MetricHistory, ScrapeHistory,  # noqa: F401
                         load_metrics_ts)
from .anomaly import AnomalyConfig, AnomalyMonitor, replica_skew  # noqa: F401
