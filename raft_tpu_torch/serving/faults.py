"""Deterministic fault injection for the serving stack (chaos harness).

Production serving fails in ways a clean test run never exercises: the
device raises mid-batch, a kernel stalls, an executable emits NaNs, a
cached session map goes bad, the batcher daemon dies to a stray bug.
"TensorFlow: a system for large-scale ML" (PAPERS.md) makes the case that
fault tolerance must be a designed-in axis of an ML system — which first
requires a way to *produce* the faults on demand.  This module is that
surface: a seeded, rate-configured injector armed via ``--chaos SPEC`` /
``RAFT_TPU_CHAOS``, with **zero overhead when off** (the server carries
``faults=None`` and every hook site is a single ``is not None`` check).

Spec grammar — comma-separated ``key=value`` pairs::

    seed=11,engine_error=0.05,latency=0.02,latency_ms=150,nan=0.03,
    session=0.05,kill=0.01

Arms (each a per-call firing rate in [0, 1]):

* ``engine_error`` — an engine device call raises :class:`FaultInjected`
  (exercises retry, poisoned-batch bisection, the circuit breaker).
* ``latency``      — an engine call sleeps ``latency_ms`` first
  (exercises deadlines and queue aging).
* ``nan``          — one row of a flow output is overwritten with NaN
  (exercises the non-finite output sentinel).
* ``session``      — a stream step's cached feature map is poisoned with
  NaN device-side (exercises the degrade-to-cold-restart path).
* ``kill``         — the batcher loop raises :class:`BatcherKilled`
  (exercises the supervisor: fail in-flight, restart, degraded healthz).

Every fire is deterministic given (seed, call order): each arm draws from
its own seeded RandomState, so a drill replays.  Fires are counted in
``raft_fault_injected_total{arm=}`` and appended to the active run log.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..lint.concurrency import guarded_by
from ..telemetry.log import get_logger
from ..telemetry.spans import current_trace_ids
from ..telemetry.watchdogs import watched_lock

_log = get_logger("serve")

ARMS = ("engine_error", "latency", "nan", "session", "kill")


class FaultInjected(RuntimeError):
    """An injected engine fault (chaos arm ``engine_error``)."""


class BatcherKilled(RuntimeError):
    """An injected batcher-thread death (chaos arm ``kill``)."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Parsed ``--chaos`` spec: per-arm rates + the shared knobs."""

    seed: int = 0
    engine_error: float = 0.0
    latency: float = 0.0
    latency_ms: float = 100.0
    nan: float = 0.0
    session: float = 0.0
    kill: float = 0.0

    @property
    def armed(self) -> bool:
        return any(getattr(self, a) > 0 for a in ARMS)


def parse_chaos_spec(spec: str) -> ChaosSpec:
    """Parse ``"seed=11,engine_error=0.05,..."``; raises ValueError on an
    unknown key, a malformed pair, or a rate outside [0, 1]."""
    fields = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad chaos entry {part!r}: expected key=value")
        key, _, val = part.partition("=")
        key = key.strip()
        try:
            if key == "seed":
                fields[key] = int(val)
            elif key == "latency_ms":
                fields[key] = float(val)
                if fields[key] < 0:
                    raise ValueError
            elif key in ARMS:
                fields[key] = float(val)
                if not 0.0 <= fields[key] <= 1.0:
                    raise ValueError
            else:
                raise KeyError(key)
        except KeyError:
            raise ValueError(
                f"unknown chaos arm {key!r}; arms: {', '.join(ARMS)} "
                f"(+ seed, latency_ms)")
        except ValueError:
            raise ValueError(
                f"bad chaos value {part!r}: rates must be floats in [0, 1], "
                f"seed an int, latency_ms a non-negative float")
    return ChaosSpec(**fields)


def _arm_seed(seed: int, arm: str) -> int:
    # distinct, stable stream per arm: the same spec replays the same fault
    # schedule regardless of which other arms are configured
    return (seed * 1_000_003 + sum(ord(c) for c in arm) * 7919) % (2 ** 31)


class FaultInjector:
    """The armed injector one FlowServer carries.  All hook sites are
    driven by :meth:`roll` — deterministic per (seed, arm, call index) —
    so a drill with a pinned seed replays its fault schedule.

    Thread model: ``roll`` takes a lock (fires happen on the batcher
    thread and, for stream arms, nowhere else — but tests poke from
    anywhere).  ``disarm()`` mutes every rate-driven arm, which is how a
    drill ends its storm without tearing the server down; ``force()``
    queues explicit outcomes for deterministic tests and is honored even
    while disarmed.
    """

    _forced = guarded_by("_lock")
    _armed = guarded_by("_lock")
    injected = guarded_by("_lock")

    def __init__(self, spec: ChaosSpec, counter=None, run_log=None):
        self.spec = spec
        self.counter = counter            # raft_fault_injected_total{arm=}
        self.run_log = run_log            # telemetry.events.RunLog or None
        self._lock = watched_lock("FaultInjector._lock")
        self._rng = {arm: np.random.RandomState(_arm_seed(spec.seed, arm))
                     for arm in ARMS}
        self._row_rng = np.random.RandomState(_arm_seed(spec.seed, "row"))
        self._forced: Dict[str, deque] = {}
        self._armed = True
        self.injected: Dict[str, int] = {arm: 0 for arm in ARMS}

    # -- control (drills + tests) -----------------------------------------

    def disarm(self) -> None:
        """End the storm: every rate-driven arm stops firing (forced
        outcomes still drain — they are explicit test instructions)."""
        with self._lock:
            self._armed = False

    def rearm(self) -> None:
        with self._lock:
            self._armed = True

    def force(self, arm: str, outcomes) -> None:
        """Queue explicit roll outcomes for ``arm`` (1/True fires) —
        consumed before the seeded rng, for deterministic tests."""
        if arm not in ARMS:
            raise ValueError(f"unknown arm {arm!r}")
        with self._lock:
            self._forced.setdefault(arm, deque()).extend(
                bool(o) for o in outcomes)

    def injected_total(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    # -- the roll ----------------------------------------------------------

    def roll(self, arm: str) -> bool:
        with self._lock:
            forced = self._forced.get(arm)
            if forced:
                hit = forced.popleft()
            elif not self._armed:
                return False
            else:
                rate = getattr(self.spec, arm)
                if rate <= 0.0:
                    return False
                hit = bool(self._rng[arm].random_sample() < rate)
            if hit:
                self.injected[arm] += 1
        if hit:
            if self.counter is not None:
                self.counter.labels(arm).inc()
            if self.run_log is not None:
                # the batch's trace ids ride along (telemetry/spans.py
                # ambient), so a drill's fault_injected events join to
                # the request traces they poisoned
                ids = current_trace_ids()
                self.run_log.event("fault_injected", arm=arm,
                                   trace_ids=list(ids) if ids else None)
            _log.warning(f"chaos: injecting fault arm={arm}")
        return hit

    # -- hook sites --------------------------------------------------------

    def pre_engine_call(self) -> None:
        """Engine-call prologue: latency spike, then injected exception."""
        if self.roll("latency"):
            time.sleep(self.spec.latency_ms / 1000.0)
        if self.roll("engine_error"):
            raise FaultInjected("injected engine fault "
                                "(chaos arm engine_error)")

    def corrupt_rows(self, flow: np.ndarray) -> np.ndarray:
        """NaN-poison one (deterministically chosen) row of a flow output
        when the ``nan`` arm fires; returns the input untouched otherwise."""
        if not self.roll("nan"):
            return flow
        flow = np.array(flow, copy=True)
        row = int(self._row_rng.randint(flow.shape[0]))
        flow[row] = np.nan
        return flow

    def corrupt_session(self, session, engine) -> None:
        """Poison a stream session's cached device feature map with NaN
        when the ``session`` arm fires — slot-pool form: the session's
        fmap ROW in the pool buffer is NaN'd in place (the engine's
        warmed ``spoison`` executable), so the poison rides the batched
        gather into the correlation volume and the flow output, which
        the non-finite sentinel must then catch and degrade that row to
        a cold restart."""
        if session.slot is None:
            return
        if self.roll("session"):
            engine.poison_slot(session.bucket, session.slot)

    def maybe_kill(self) -> None:
        """Batcher-loop hook: raise :class:`BatcherKilled` when the
        ``kill`` arm fires (the supervisor drill)."""
        if self.roll("kill"):
            raise BatcherKilled("injected batcher-thread death "
                                "(chaos arm kill)")


def make_injector(spec: Optional[str], counter=None,
                  run_log=None) -> Optional[FaultInjector]:
    """``--chaos``/env spec string -> injector, or None when the spec is
    empty/absent (the zero-overhead off state: call sites never even
    branch per arm).  An explicit spec builds the injector even with
    all-zero rates — tests drive those via ``force()``."""
    if not spec:
        return None
    return FaultInjector(parse_chaos_spec(spec), counter=counter,
                         run_log=run_log)
