"""Opt-in runtime watchdogs: graph captures, device memory, locks.

The port's copy of the JAX package's ``telemetry/watchdogs.py``.  Each
failure mode is surfaced with **stage provenance** (the innermost
:func:`trace.stage` name active when the event fired):

* **RecompileWatch** — counts CUDA graph captures, the port's "compiles"
  (the serving engine reports each capture it observes through
  :meth:`RecompileWatch.notify`).  ``arm()`` after warmup; any capture
  after that is a recapture (a new shape, or weights that moved) and is
  recorded with its stage.
* **hbm_gauges** — device memory allocated / total as live registry
  gauges (``torch.cuda``; 0 without a device).
* **LockOrderValidator** — the runtime lock-order check
  (``RAFT_TPU_LOCK_WATCH=1``): the serving locks are created through
  :func:`watched_lock`, which records per-thread acquisition edges,
  flags cycles and inversions of the declared hierarchy
  (``lint.concurrency.SERVING_LOCK_HIERARCHY``), and bounds hold times —
  exported as ``raft_lock_order_violations_total`` /
  ``raft_lock_hold_violations_total`` / the ``raft_lock_hold_seconds``
  histogram.

* **NaN/Inf sentinel** — :func:`nan_guard` at the model's stages
  (``raft/fnet``, ``raft/corr_lookup``, ``raft/update``, as the JAX
  package places it) counts a tensor's non-finite elements on the device,
  ``isnan(x - x).sum()`` (fewer kernels than ``~isfinite(x)``): no
  ``.item()``, no host sync, so it lives inside a captured CUDA graph.
  The switch is read when a forward runs eagerly or is captured (JAX
  reads it at trace time): a graph captured with the sentinel off holds
  no added node and costs nothing.  Each
  guard's count is a device scalar collected by the innermost
  :func:`nan_tally` of the thread; the entry point reads the tally after
  the call (one sync, only when the sentinel is on) and reports each
  non-zero count in the order the guards ran, as the JAX package's host
  callbacks do: a ``{"stage", "bad_values"}`` record in
  :func:`nan_events`, a ``nonfinite`` run-log event and a warning
  (:func:`_report_nonfinite`).  A captured graph keeps its guards' counts
  as static outputs, which every replay rewrites; the graph's owner
  reports them after each replay.

The JAX package's implicit-transfer guard has no torch counterpart; the
serving stack also checks every flow row on the host (the non-finite
output sentinel of ``serving/batcher.py``).

Everything is opt-in (``install``/``enable`` calls or the
``RAFT_TPU_WATCHDOGS=1`` / ``RAFT_TPU_LOCK_WATCH=1`` env vars) and free
when off: ``watched_lock`` hands back a plain ``threading.Lock``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Set

from .log import get_logger
from .spans import current_trace_ids
from .trace import current_stage

_log = get_logger("watchdog")


def watchdogs_enabled() -> bool:
    return os.environ.get("RAFT_TPU_WATCHDOGS", "") not in ("", "0", "false")


# ----------------------------------------------------------- graph captures

class RecompileWatch:
    """Process-wide capture counter with arm/disarm semantics.

    ``install()`` adds the watch to the set :meth:`notify` reports to; each
    watch keeps its own counts.  ``arm()`` marks warmup complete: captures
    before it are expected (and counted separately), captures after it
    are *recaptures* and recorded with stage provenance + an optional
    registry counter / run-log event.
    """

    _instances: List["RecompileWatch"] = []
    _lock = threading.Lock()

    def __init__(self, counter=None, run_log=None, log_fn=None,
                 on_recompile=None):
        self.compiles = 0                  # total since construction
        self.warmup_compiles = 0
        self.recompiles = 0                # captures after arm()
        self.events: List[dict] = []       # recapture records w/ stage
        self.armed = False
        self._counter = counter            # telemetry.registry.Counter
        self._run_log = run_log            # telemetry.events.RunLog
        self._log_fn = log_fn
        self._on_recompile = on_recompile  # e.g. a flight-recorder dump

    def install(self) -> "RecompileWatch":
        with RecompileWatch._lock:
            RecompileWatch._instances.append(self)
        return self

    def remove(self) -> None:
        with RecompileWatch._lock:
            if self in RecompileWatch._instances:
                RecompileWatch._instances.remove(self)

    def arm(self) -> None:
        """Warmup is over: every capture from here on is a recapture."""
        self.armed = True

    @staticmethod
    def notify(duration: float, captures: int = 1) -> None:
        """Report ``captures`` CUDA graph captures made by a call that
        took ``duration`` seconds to every installed watch."""
        with RecompileWatch._lock:
            watches = list(RecompileWatch._instances)
        for w in watches:
            for _ in range(captures):
                w._record(duration)

    def _record(self, duration: float) -> None:
        with RecompileWatch._lock:
            self.compiles += 1
            if not self.armed:
                self.warmup_compiles += 1
                return
            stage = current_stage()
            self.recompiles += 1
            rec = {"stage": stage, "duration_s": round(duration, 4),
                   "n": self.recompiles}
            self.events.append(rec)
        if self._counter is not None:
            self._counter.inc()
        if self._run_log is not None:
            self._run_log.event("recompile", **rec)
        msg = (f"graph capture #{self.recompiles} after warmup "
               f"(stage={stage or '<unknown>'}, call took {duration:.2f}s)")
        if self._log_fn is not None:
            self._log_fn(msg)
        else:
            _log.warning(msg)
        if self._on_recompile is not None:
            # watchdog-fire hook (the serving flight recorder dumps here);
            # never let a consumer error kill the caller
            try:
                self._on_recompile()
            except Exception as e:  # noqa: BLE001
                _log.warning(f"on_recompile hook failed: {e}")


# ------------------------------------------------------------ device memory

def hbm_gauges(registry, prefix: str = "raft") -> dict:
    """Live device-memory gauges sampled at render/snapshot time: bytes
    allocated by PyTorch's caching allocator on device 0, and the device's
    total memory.  Both read 0 without a CUDA device, so the same wiring
    runs in tests and on hardware."""
    def in_use():
        import torch
        return torch.cuda.memory_allocated(0) if torch.cuda.is_available() \
            else 0

    def limit():
        import torch
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.get_device_properties(0).total_memory

    return {
        "bytes_in_use": registry.gauge(
            f"{prefix}_hbm_bytes_in_use",
            "Device memory currently allocated (device 0)", fn=in_use),
        "bytes_limit": registry.gauge(
            f"{prefix}_hbm_bytes_limit",
            "Device memory capacity (device 0)", fn=limit),
    }


# ----------------------------------------------------------- NaN sentinel

_nan_enabled = False
_nan_suppressed = False
_nan_events: List[dict] = []
_nan_run_log = None
_nan_local = threading.local()


def enable_nan_sentinel(on: bool = True, run_log=None) -> None:
    """Turn the NaN/Inf sentinel on (read when a forward runs eagerly or
    is captured: graphs captured while it is off carry no guard)."""
    global _nan_enabled, _nan_run_log
    _nan_enabled = on
    _nan_run_log = run_log
    if on:
        _nan_events.clear()


@contextlib.contextmanager
def suppress_nan_sentinel():
    """Forwards run or captured inside the block carry no guard, even
    when the watchdogs are on."""
    global _nan_suppressed
    prev = _nan_suppressed
    _nan_suppressed = True
    try:
        yield
    finally:
        _nan_suppressed = prev


def nan_sentinel_enabled() -> bool:
    return not _nan_suppressed and (_nan_enabled or watchdogs_enabled())


def nan_events() -> List[dict]:
    """Records of the non-finite counts reported, oldest first."""
    return _nan_events


def _report_nonfinite(bad_count, stage: str) -> None:
    n = int(bad_count)
    if n == 0:
        return
    rec = {"stage": stage, "bad_values": n}
    _nan_events.append(rec)
    if _nan_run_log is not None:
        _nan_run_log.event("nonfinite", **rec)
    _log.warning(f"non-finite values: {n} element(s) in stage "
                 f"{stage!r}")


class NanTally:
    """The guards one call ran, in order: (stage, device count)."""

    def __init__(self):
        self.entries: list = []

    def add(self, stage: str, bad) -> None:
        self.entries.append((stage, bad))

    def counts(self) -> list:
        """[(stage, count)] read from the device (one sync)."""
        if not self.entries:
            return []
        import torch
        values = torch.stack([b for _, b in self.entries]).tolist()
        return [(s, int(n)) for (s, _), n in zip(self.entries, values)]

    def report(self) -> None:
        for stage, n in self.counts():
            _report_nonfinite(n, stage)


@contextlib.contextmanager
def nan_tally():
    """Collect the guards this thread runs inside the block into a new
    :class:`NanTally` (yielded); the caller reports it when the values
    exist (after a replay for a captured graph)."""
    stack = _nan_local.__dict__.setdefault("stack", [])
    tally = NanTally()
    stack.append(tally)
    try:
        yield tally
    finally:
        stack.pop()


def nan_guard(x, name: Optional[str] = None):
    """Identity on ``x``; when the sentinel is on, also counts ``x``'s
    non-finite elements on the device under stage ``name`` (else the
    innermost active ``stage()``) into the thread's :func:`nan_tally`.
    Outside a tally the count is read and reported at once (a host sync,
    so not allowed inside a capture).  A guard that runs inside autograd's
    backward (an iteration recomputed under remat) counts nothing: its
    values are the forward's, counted there."""
    if not nan_sentinel_enabled():
        return x
    import torch
    if torch._C._current_graph_task_id() != -1:
        return x
    stage = name or current_stage() or "<unstaged>"
    x_ = x.detach()
    bad = torch.isnan(x_ - x_).sum()    # NaN exactly where x is NaN or +-inf
    stack = getattr(_nan_local, "stack", None)
    if stack:
        stack[-1].add(stage, bad)
    elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"nan_guard({stage!r}) inside a CUDA graph capture "
                           f"needs a nan_tally() around the capture")
    else:
        _report_nonfinite(bad, stage)
    return x


# ------------------------------------------------------ lock-order validator

_LOCK_WATCH_ENV = "RAFT_TPU_LOCK_WATCH"
_LOCK_BUDGET_ENV = "RAFT_TPU_LOCK_BUDGET_MS"

# Hold-time buckets: critical sections here are dict updates (micro-
# seconds); anything past ~10ms is already suspicious, past the budget a
# violation.
LOCK_HOLD_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                     0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def lock_watch_enabled() -> bool:
    return os.environ.get(_LOCK_WATCH_ENV, "") not in ("", "0", "false")


def default_hold_budget_s() -> float:
    try:
        return float(os.environ.get(_LOCK_BUDGET_ENV, "1000")) / 1000.0
    except ValueError:
        return 1.0


class LockOrderValidator:
    """Runtime twin of raftlint rule C3: observes every acquisition of a
    :func:`watched_lock`-wrapped lock, per thread, and flags

    * **order violations** — an acquisition edge that closes a cycle in
      the process-wide lock graph, or inverts a declared hierarchy
      (:func:`declare_order` with ``lint.concurrency
      .SERVING_LOCK_HIERARCHY``): the inversion is counted the moment the
      FIRST thread takes the wrong path, long before the matching
      opposite edge turns it into an actual deadlock;
    * **hold violations** — a lock held longer than its budget (waiting
      on a ``Condition`` built over the lock does NOT count: wait()
      releases it, so only real critical-section time accrues).

    One validator per process (:func:`lock_validator`); instances are
    also constructable directly with an injectable ``clock`` so the unit
    tests drive the state machine on fake time.  Each unique edge is
    checked once — the graph only grows, so a violating edge is counted
    once, not per occurrence (monotone counters, cheap steady state).
    """

    def __init__(self, clock=time.monotonic,
                 hold_budget_s: Optional[float] = None, log_fn=None):
        self.clock = clock
        self.hold_budget_s = (default_hold_budget_s()
                              if hold_budget_s is None else hold_budget_s)
        self.log_fn = log_fn or _log.warning
        # _meta guards the process-wide graph/violation state; the
        # per-thread held stack is threading.local (no lock needed)
        self._meta = threading.Lock()
        self._held = threading.local()
        self._graph: Dict[str, Set[str]] = {}
        self._edges_seen: Set[tuple] = set()
        self._rank: Dict[str, int] = {}
        self._budgets: Dict[str, Optional[float]] = {}
        self.order_violations = 0
        self.hold_violations = 0
        self.violations: List[dict] = []      # records, oldest first
        self.hold_hist = None                 # telemetry Histogram, wired
        self.run_log = None                   # by export_lock_metrics

    # -- wiring ------------------------------------------------------------

    def declare_order(self, names) -> None:
        """Declare the intended hierarchy, most-outer first: acquiring a
        lower-ranked (outer) lock while holding a higher-ranked one is a
        violation even before any cycle closes."""
        with self._meta:
            for i, n in enumerate(names):
                self._rank[n] = i

    def set_budget(self, name: str, budget_s: Optional[float]) -> None:
        """Per-lock hold budget; None disables the check (e.g. the session
        lock, deliberately held across a whole advance)."""
        with self._meta:
            self._budgets[name] = budget_s

    def counts(self) -> dict:
        with self._meta:
            return {"order_violations": self.order_violations,
                    "hold_violations": self.hold_violations,
                    "edges": len(self._edges_seen)}

    # -- the two hot hooks (called by _WatchedLock) ------------------------

    def _stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def on_acquired(self, name: str) -> None:
        st = self._stack()
        if st:
            top = st[-1][0]
            if top != name:
                self._check_edge(top, name)
            else:
                self._violation("reentry", f"lock {name} re-acquired while "
                                           f"already held by this thread")
        st.append((name, self.clock()))

    def on_released(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                _, t0 = st.pop(i)
                held_s = self.clock() - t0
                if self.hold_hist is not None:
                    self.hold_hist.observe(held_s)
                with self._meta:
                    budget = self._budgets.get(name, self.hold_budget_s)
                if budget is not None and held_s > budget:
                    self._hold_violation(name, held_s, budget)
                return

    # -- checks ------------------------------------------------------------

    def _check_edge(self, src: str, dst: str) -> None:
        with self._meta:
            if (src, dst) in self._edges_seen:
                return
            self._edges_seen.add((src, dst))
            rs, rd = self._rank.get(src), self._rank.get(dst)
            self._graph.setdefault(src, set()).add(dst)
            if rs is not None and rd is not None and rd < rs:
                msg = (f"hierarchy inversion: {dst} acquired while holding "
                       f"{src} (declared order puts {dst} first)")
            elif self._reachable(dst, src):
                msg = (f"cycle: acquiring {dst} while holding {src}, but "
                       f"{dst} -> ... -> {src} edges already exist — "
                       f"deadlock shape")
            else:
                return
        self._violation("order", msg)

    def _reachable(self, src: str, dst: str) -> bool:
        # _meta held by the caller
        stack, seen = [src], set()
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._graph.get(cur, ()))
        return False

    def _violation(self, kind: str, msg: str) -> None:
        rec = {"kind": kind, "msg": msg, "thread": threading.current_thread().name}
        ids = current_trace_ids()
        if ids:
            # join key: the request traces in flight on this thread when
            # the violation fired (telemetry/spans.py ambient)
            rec["trace_ids"] = list(ids)
        with self._meta:
            self.order_violations += 1
            self.violations.append(rec)
        if self.run_log is not None:
            self.run_log.event("lock_violation", **rec)
        self.log_fn(f"lock-order violation ({kind}): {msg}")

    def _hold_violation(self, name: str, held_s: float,
                        budget: float) -> None:
        rec = {"kind": "hold", "lock": name, "held_s": round(held_s, 4),
               "budget_s": budget,
               "thread": threading.current_thread().name}
        ids = current_trace_ids()
        if ids:
            rec["trace_ids"] = list(ids)
        with self._meta:
            self.hold_violations += 1
            self.violations.append(rec)
        if self.run_log is not None:
            self.run_log.event("lock_violation", **rec)
        self.log_fn(f"lock hold-time violation: {name} held "
                    f"{held_s * 1000:.1f}ms (budget {budget * 1000:.0f}ms)")


class WatchedLock:
    """Drop-in ``threading.Lock`` wrapper reporting to a validator.  Also
    works as the lock under a ``threading.Condition`` — wait() releases
    through :meth:`release`, so hold accounting pauses across waits."""

    __slots__ = ("_lock", "name", "_validator")

    def __init__(self, name: str, lock, validator: LockOrderValidator):
        self._lock = lock
        self.name = name
        self._validator = validator

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._validator.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._validator.on_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"WatchedLock({self.name!r}, {self._lock!r})"


_validator: Optional[LockOrderValidator] = None
_validator_init = threading.Lock()


def lock_validator() -> LockOrderValidator:
    """The process-wide validator (created on first use)."""
    global _validator
    with _validator_init:
        if _validator is None:
            _validator = LockOrderValidator()
        return _validator


def watched_lock(name: str, budget_s: Optional[float] = "default",
                 validator: Optional[LockOrderValidator] = None):
    """A ``threading.Lock`` — instrumented by the lock-order validator
    when ``RAFT_TPU_LOCK_WATCH=1``, plain (zero overhead) otherwise.
    ``budget_s`` bounds hold time (None disables the bound for locks
    deliberately held across long sections, e.g. a stream advance)."""
    lock = threading.Lock()
    if validator is None:
        if not lock_watch_enabled():
            return lock
        validator = lock_validator()
    if budget_s != "default":
        validator.set_budget(name, budget_s)
    return WatchedLock(name, lock, validator)


def export_lock_metrics(registry, validator: Optional[LockOrderValidator]
                        = None, run_log=None) -> LockOrderValidator:
    """Register the validator's families on ``registry``:
    ``raft_lock_order_violations_total`` (cycles/inversions/reentries),
    ``raft_lock_hold_violations_total`` (budget overruns) — live callbacks
    on the validator, so violations observed before export still show —
    and the ``raft_lock_hold_seconds`` histogram."""
    v = validator if validator is not None else lock_validator()
    registry.gauge(
        "raft_lock_order_violations_total",
        "Lock acquisition-order violations (cycle closed, declared-"
        "hierarchy inversion, or reentry) observed by the runtime "
        "lock-order validator — must stay 0",
        fn=lambda: v.counts()["order_violations"])
    registry.gauge(
        "raft_lock_hold_violations_total",
        "Lock hold times over the per-lock budget "
        "(RAFT_TPU_LOCK_BUDGET_MS, default 1000)",
        fn=lambda: v.counts()["hold_violations"])
    v.hold_hist = registry.histogram(
        "raft_lock_hold_seconds",
        "Critical-section hold time per watched-lock release "
        "(Condition waits excluded — wait() releases the lock)",
        buckets=LOCK_HOLD_BUCKETS)
    if run_log is not None:
        v.run_log = run_log
    return v
