"""Circuit breaker: shed fast when the engine is sick, probe, recover.

The admission queue protects against *overload*; this protects against
*failure*.  When the device-call error rate over a sliding window crosses
the threshold, the breaker opens: new work is shed immediately with 503 +
``Retry-After`` (clients back off instead of queueing behind a dying
engine and burning their deadlines), and streaming sessions are demoted
to the transparent cold-restart path so no stale per-session device state
survives the storm.  After ``cooldown_s`` the breaker goes half-open and
admits a probe trickle; one probed success closes it, a probed failure
re-opens it for another cooldown.

State machine::

    closed --(error rate >= threshold over >= min_volume calls)--> open
    open   --(cooldown elapsed)--> half-open
    half-open --(probe ok)--> closed      --(probe fails)--> open

Outcomes are recorded per *engine call* (the batcher's retry/bisection
probes included — they measure exactly the health the breaker gates on).
State is exported as ``raft_breaker_state`` (0 closed, 1 half-open,
2 open) and ``raft_breaker_transitions_total{to=}``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from ..lint.concurrency import guarded_by
from ..telemetry.log import get_logger
from ..telemetry.watchdogs import watched_lock
from .queue import RejectedError

_log = get_logger("serve")

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(RejectedError):
    """Shed: the circuit breaker is open (503; honor ``Retry-After``)."""
    http_status = 503

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class CircuitBreaker:
    """Count-based sliding-window error-rate breaker (one per server).

    ``transitions`` is wired by ``make_robustness_metrics`` (the labeled
    counter pattern the session store uses for evictions); ``on_open`` is
    the server's degrade hook (demote streaming sessions).  ``clock`` is
    injectable so the state machine unit-tests run on a fake clock.

    Thread model: ``record`` runs on the batcher thread, ``allow`` on
    every handler thread, so the whole state machine lives under
    ``_lock``.  The open transition calls ``on_open`` — which takes the
    session store's lock to demote sessions — while ``_lock`` is held:
    that is the breaker → store edge that pins this lock FIRST in the
    declared hierarchy (lint.concurrency.SERVING_LOCK_HIERARCHY).
    """

    _outcomes = guarded_by("_lock")
    _state = guarded_by("_lock")
    _opened_at = guarded_by("_lock")
    _probes_left = guarded_by("_lock")
    _last_probe_at = guarded_by("_lock")
    opens = guarded_by("_lock")

    def __init__(self, window: int = 64, threshold: float = 0.5,
                 min_volume: int = 8, cooldown_s: float = 5.0,
                 probes: int = 1, clock=time.monotonic, on_open=None):
        if window < 1:
            raise ValueError(f"breaker window must be >= 1, got {window}")
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"breaker threshold must be in (0, 1], "
                             f"got {threshold}")
        if not cooldown_s > 0:
            raise ValueError(f"breaker cooldown must be > 0, got {cooldown_s}")
        self.window = window
        self.threshold = threshold
        self.min_volume = max(1, min_volume)
        self.cooldown_s = cooldown_s
        self.probes = max(1, probes)
        self.clock = clock
        self.on_open = on_open
        self.transitions = None           # labeled counter, wired by metrics
        self._lock = watched_lock("CircuitBreaker._lock")
        self._outcomes = deque(maxlen=window)
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes_left = 0
        self._last_probe_at = 0.0
        self.opens = 0                    # lifetime open transitions

    # -- accounting --------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_code(self) -> int:
        """Gauge callback: 0 closed, 1 half-open, 2 open."""
        return _STATE_CODE[self.state]

    @guarded_by("_lock")
    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        if self.transitions is not None:
            self.transitions.labels(state).inc()
        _log.warning(f"breaker -> {state}")
        if state == OPEN:
            self.opens += 1
            self._opened_at = self.clock()
            self._outcomes.clear()
            if self.on_open is not None:
                self.on_open()

    # -- the two call sites ------------------------------------------------

    def allow(self) -> Optional[float]:
        """Admission check.  None = admit; a float = shed, with the
        suggested ``Retry-After`` seconds (remaining cooldown)."""
        with self._lock:
            if self._state == CLOSED:
                return None
            now = self.clock()
            if self._state == OPEN:
                remaining = self._opened_at + self.cooldown_s - now
                if remaining > 0:
                    return remaining
                self._transition(HALF_OPEN)
                self._probes_left = self.probes
            # half-open: admit up to `probes` in-flight probes; everyone
            # else sheds briefly until a probe outcome decides the state.
            # A granted probe can die before it ever reaches the engine
            # (400/404 after admission, queue-full, deadline purge) and
            # then never record()s — replenish the slot after a cooldown
            # so a lost probe cannot wedge the breaker into shedding
            # forever.
            if self._probes_left > 0:
                self._probes_left -= 1
                self._last_probe_at = now
                return None
            if now - self._last_probe_at >= self.cooldown_s:
                self._last_probe_at = now
                return None
            return min(1.0, self.cooldown_s)

    def record(self, ok: bool) -> None:
        """One engine-call outcome (batcher thread)."""
        with self._lock:
            if self._state == OPEN:
                return            # straggler from before the open: ignore
            if self._state == HALF_OPEN:
                self._transition(CLOSED if ok else OPEN)
                if ok:
                    self._outcomes.clear()
                return
            self._outcomes.append(bool(ok))
            if len(self._outcomes) < self.min_volume:
                return
            failures = sum(1 for o in self._outcomes if not o)
            if failures / len(self._outcomes) >= self.threshold:
                self._transition(OPEN)
