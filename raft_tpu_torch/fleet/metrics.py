"""The fleet metric set (``raft_fleet_*``) — one definition site, same
contract as :func:`raft_tpu_torch.serving.metrics.make_serving_metrics`: the
names in SERVING.md/OBSERVABILITY.md, the tests and the router can't
drift.  These live on the ROUTER's registry (its /metrics endpoint);
per-replica families stay on each replica's own /metrics — scrape both,
they share the telemetry registry classes.
"""

from __future__ import annotations

import functools
from typing import Dict

from ..telemetry.registry import Registry, _Metric
from ..telemetry.registry import register_process_start_time

REPLICA_STATES = ("starting", "ready", "degraded", "dead", "stopped")


def make_fleet_metrics(registry: Registry, manager=None,
                       sessions_fn=None, inflight_fn=None,
                       skew_fn=None) -> Dict[str, _Metric]:
    """The router/controller metric families.  The live gauges are
    callbacks on the manager / session map (sampled at scrape time, the
    serving-plane idiom) so they can never go stale."""
    replicas = registry.gauge(
        "raft_fleet_replicas",
        "Replicas by lifecycle state (starting, ready, degraded, dead, "
        "stopped)",
        labelnames=("state",))
    if manager is not None:
        for state in REPLICA_STATES:
            replicas.labels(state).set_fn(
                functools.partial(manager.count_state, state))
    m = {
        "replicas": replicas,
        "desired": registry.gauge(
            "raft_fleet_replicas_desired",
            "Replica count the manager is converging to (scale_to "
            "target, clamped to [min_replicas, max_replicas])",
            fn=(lambda: manager.desired) if manager else None),
        "requests": registry.counter(
            "raft_fleet_requests_total",
            "Router-terminal requests by status class (ok, error, shed, "
            "bad_request, no_replica)",
            labelnames=("status",)),
        "forwards": registry.counter(
            "raft_fleet_forwards_total",
            "Requests forwarded, by replica index (the routing decision "
            "record: least-loaded for /v1/flow, affinity for /v1/stream)",
            labelnames=("replica",)),
        "forward_latency": registry.histogram(
            "raft_fleet_forward_latency_seconds",
            "Router-observed replica round-trip per forward (connect + "
            "replica service + response read)"),
        "retries": registry.counter(
            "raft_fleet_retries_total",
            "Pairwise forwards replayed on another replica after a "
            "connection-level failure (/v1/flow is pure, so a replay is "
            "safe by construction)"),
        "migrations": registry.counter(
            "raft_fleet_migrations_total",
            "Stream sessions re-pinned to a healthy replica after their "
            "replica died — healed via the host-side prev-frame replay "
            "(open(prev) + advance(cur): flow equals pairwise exactly)"),
        "hot_swaps": registry.counter(
            "raft_fleet_hot_swaps_total",
            "Per-replica weight reloads applied by the rolling-update "
            "controller (one increment per replica per roll)"),
        "scale_events": registry.counter(
            "raft_fleet_scale_events_total",
            "Autoscaler decisions applied, by direction",
            labelnames=("direction",)),
        "sessions": registry.gauge(
            "raft_fleet_sessions",
            "Streaming sessions the router is tracking (each pinned to "
            "a replica, prev-frame retained for migration)",
            fn=sessions_fn),
        "inflight": registry.gauge(
            "raft_fleet_inflight",
            "Forwards currently in flight across the fleet (the router's "
            "own least-loaded signal)",
            fn=inflight_fn),
        "replica_restarts": registry.gauge(
            "raft_fleet_replica_restarts",
            "Replicas respawned after unplanned deaths (chaos kills, "
            "crashes) since the fleet started",
            fn=(lambda: manager.restarts) if manager else None),
        "replica_skew": registry.gauge(
            "raft_fleet_replica_skew",
            "Replicas whose windowed p95 request latency is an outlier "
            "vs the fleet median (telemetry.anomaly.replica_skew) — the "
            "router soft-drains them until their p95 rejoins the fleet",
            fn=skew_fn),
    }
    register_process_start_time(registry)
    return m
