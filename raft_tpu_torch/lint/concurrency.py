"""Concurrency guard annotations and the serving plane's lock hierarchy.

The port's copy of :func:`guarded_by` and :data:`SERVING_LOCK_HIERARCHY`
from the JAX package's ``lint/concurrency.py`` (the AST rules that read
them stay there).  The hierarchy gains the engine's device lock
(``InferenceEngine._device_lock``): a captured CUDA graph is not
re-entrant, so every device call of the engine (warmup's captures, the
batcher's replays, a reload's probe and weight copy) runs under it.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["guarded_by", "SERVING_LOCK_HIERARCHY"]


class _GuardSpec:
    """Sentinel returned by :func:`guarded_by` — usable both as a
    class-attribute value and as a method decorator."""

    __slots__ = ("lock",)

    def __init__(self, lock: str):
        self.lock = lock

    def __call__(self, fn):
        fn.__guarded_by__ = self.lock
        return fn

    def __repr__(self) -> str:
        return f"guarded_by({self.lock!r})"


def guarded_by(lock: str) -> _GuardSpec:
    """Declare that an attribute (class-attr form) or a whole method body
    (decorator form) is protected by ``self.<lock>``.  Pure metadata: at
    runtime the decorator returns the function unchanged and the class
    attribute is shadowed by the instance attribute ``__init__`` assigns."""
    return _GuardSpec(lock)


# The intended lock hierarchy of the serving plane, most-outer first: an
# acquisition edge that goes RIGHT → LEFT (e.g. taking the store lock while
# holding a session lock) is an inversion, flagged at runtime by
# telemetry/watchdogs.LockOrderValidator (armed via RAFT_TPU_LOCK_WATCH=1).
SERVING_LOCK_HIERARCHY: Tuple[str, ...] = (
    "FleetSessionMap._lock",      # router session table (lookup only; the
                                  # per-session lock is taken after release)
    "FleetSession.lock",          # held across a whole routed advance —
                                  # migration picks a replica under it
    "ReplicaManager._lock",       # replica table; a migrating advance asks
                                  # for a healthy replica while pinned
    "FleetRouter._lock",          # leaf of the fleet plane: in-flight
                                  # counters (taken after the manager view)
    "CircuitBreaker._lock",       # record() may demote ALL sessions (open)
    "SessionStore._lock",         # probes Session.lock.locked(), never takes
    "Session.lock",               # handler holds it across a whole advance
    "RequestQueue._lock",         # submit() runs under the session lock
    "InferenceEngine._device_lock",  # held across a whole device call (a
                                  # capture or a replay, a commit, a reload);
                                  # the locks below are taken inside it
    "InferenceEngine._lock",      # leaf: key-set bookkeeping and counters
    "FaultInjector._lock",        # leaf: chaos roll state
    "SlotPool._lock",             # leaf: slot free-list + buffer refs,
                                  # taken under the store lock on the
                                  # promote/demote/sweep paths
)
