"""Fleet configuration: the knobs of the multi-replica serving plane.

The port's copy of the JAX package's ``fleet/config.py`` (the same knobs,
defaults and validation).

The fleet layer composes three controllers over N single-replica
``FlowServer`` processes (SERVING.md "Fleet"): the replica manager
(spawn/monitor/restart), the admission router (least-loaded pairwise
routing + session-affinity streaming with transparent migration), and
the autoscaler / rolling-update controller (signal-driven scale
decisions with hysteresis, zero-downtime weight hot-swap).  Like
ServeConfig, everything is declared up front and validated eagerly so a
misconfigured fleet dies at construction, not under load.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Static configuration of the fleet plane (see SERVING.md "Fleet")."""

    # Initial replica count, and the autoscaler's clamp range.  The
    # manager keeps the fleet inside [min_replicas, max_replicas] even
    # under manual scale_to calls.
    replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 4
    # Router endpoint.  port 0 = ephemeral (printed and available as
    # FleetRouter.port, same contract as FlowServer).
    host: str = "127.0.0.1"
    port: int = 8100
    # Health poll cadence: every replica's /healthz (+ /metrics for the
    # autoscaler signals) is polled on this period; a replica is declared
    # dead after `unhealthy_after` consecutive failed polls OR as soon as
    # its process exits — whichever the poll sees first.  The chaos
    # acceptance bound ("recovery within one health-poll window") is
    # health_poll_s * unhealthy_after in the worst case, health_poll_s
    # when the process dies outright.
    health_poll_s: float = 1.0
    health_timeout_s: float = 5.0
    unhealthy_after: int = 3
    # Respawn a replica that died without being asked to (chaos kill,
    # OOM, crash).  The router migrates its sessions away immediately
    # either way; the respawn restores capacity.
    restart_dead: bool = True
    # Stagger replica warmup: bring replicas up one at a time so N cold
    # starts don't stampede the host and the card (N kernel builds and
    # cuDNN benchmarks of every capture at once).
    stagger: bool = True
    # Seconds to wait for one replica to warm up and print its banner.
    spawn_timeout_s: float = 300.0
    # Pin each replica to a disjoint CPU-core slice (os.sched_setaffinity
    # in the child, round-robin over the visible cores).  Off by default;
    # --pin-cpus turns it on so N replicas share one host's cores instead
    # of fighting over every core.
    pin_cpus: bool = False
    # Pairwise forward retries after a connection-level failure (replica
    # died mid-request).  /v1/flow is pure, so a replay is safe; stream
    # advances retry through the migration path instead.
    forward_retries: int = 2
    # Router-side request trace sampling (joined to replica traces via
    # the propagated X-Raft-Trace-Id; 0 disables router spans).
    trace_sample: float = 1.0
    # -- fleet time-series + replica skew (router.py) ----------------------
    # Scrape samples retained per replica in the router's history ring
    # (one per health poll — the router's /debug/history window), and
    # the replica-skew sentinel: a replica whose p95 request latency
    # over the trailing skew_window_s exceeds skew_factor x the fleet
    # median (and the skew_floor_s noise floor) is soft-drained — new
    # pairwise picks steer away while pinned sessions keep streaming —
    # until its p95 rejoins the fleet.
    history_window: int = 600
    skew_window_s: float = 30.0
    skew_factor: float = 3.0
    skew_floor_s: float = 0.050
    # -- autoscaler (controller.py) ----------------------------------------
    # Disabled by default: scale_to is always available manually; the
    # controller thread only runs when autoscale=True.
    autoscale: bool = False
    scale_poll_s: float = 5.0
    # Scale-up pressure: any replica's raft_slo_burn_rate above
    # up_burn_rate, or fleet mean queue fill (depth/limit) above
    # up_queue_frac, or any open breaker.  Scale-down calm: every
    # replica's burn below down_burn_rate AND fleet queue fill below
    # down_queue_frac.
    up_burn_rate: float = 1.0
    up_queue_frac: float = 0.5
    down_burn_rate: float = 0.25
    down_queue_frac: float = 0.05
    # Hysteresis: consecutive pressured/calm polls required before a
    # scale event, plus a cooldown after any event.  Asymmetric on
    # purpose — scale up fast, scale down reluctantly.
    up_after: int = 2
    down_after: int = 6
    cooldown_s: float = 30.0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {self.min_replicas}")
        if not (self.min_replicas <= self.replicas <= self.max_replicas):
            raise ValueError(
                f"need min_replicas <= replicas <= max_replicas, got "
                f"{self.min_replicas} / {self.replicas} / "
                f"{self.max_replicas}")
        if self.health_poll_s <= 0:
            raise ValueError("health_poll_s must be positive")
        if self.unhealthy_after < 1:
            raise ValueError("unhealthy_after must be >= 1")
        if self.forward_retries < 0:
            raise ValueError("forward_retries must be >= 0")
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError("trace_sample must be in [0, 1]")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        if self.history_window < 2:
            raise ValueError("history_window must be >= 2 (derivations "
                             "need a sample pair)")
        if self.skew_window_s <= 0:
            raise ValueError("skew_window_s must be positive")
        if self.skew_factor <= 1.0:
            raise ValueError("skew_factor must exceed 1 (a replica at the "
                             "fleet median is not an outlier)")
