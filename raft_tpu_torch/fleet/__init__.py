"""Replica fleet: session-affinity router, signal-driven autoscaling,
and zero-downtime weight hot-swap.

The port's copy of the JAX package's ``fleet/``.  The serving plane
(``raft_tpu_torch.serving``) is ONE process.  This package
multiplies it: a :class:`ReplicaManager` spawns and health-polls N
``-m serve`` subprocesses, a :class:`FleetRouter` fronts them with the
UNCHANGED ``/v1/flow`` + ``/v1/stream`` API (least-loaded for pairwise,
session affinity for streams, migration-on-death via the host-side
prev-frame record), and the controllers keep the fleet right-sized
(:class:`Autoscaler`, driven by the SLO/queue/shed signals the replicas
already export) and up to date (:class:`RollingUpdater`, rolling the
``/admin/reload`` hot-swap, which copies weights into the captured
graphs' storage, across replicas one at a time).  Every replica runs on
the one card (``cuda:0``) in its own process, with its own CUDA context
and graph pools; their kernels time-slice the card.  Entry point:
``python -m raft_tpu_torch.cli -m serve_fleet``.
"""

from .config import FleetConfig
from .controller import Autoscaler, RollingUpdater, fleet_signals
from .launch import build_fleet, serve_fleet_cli
from .manager import Replica, ReplicaManager
from .metrics import make_fleet_metrics
from .router import FleetRouter, FleetSession, FleetSessionMap

__all__ = [
    "FleetConfig",
    "Replica",
    "ReplicaManager",
    "FleetRouter",
    "FleetSession",
    "FleetSessionMap",
    "Autoscaler",
    "RollingUpdater",
    "fleet_signals",
    "make_fleet_metrics",
    "build_fleet",
    "serve_fleet_cli",
]
