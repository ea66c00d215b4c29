"""Deterministic fault injection for the TRAINING plane (chaos harness).

A copy of the JAX package's ``training/faults.py``.  The ``worker_kill``
and ``worker_stall`` arms act on the multi-process data loader
(``data/mp_loader.py::MPSampleLoader``), as in the JAX package.

The serving plane has a seeded injector (``serving/faults.py``); this
is the training-side twin, armed
via ``--chaos-train SPEC`` / ``RAFT_TPU_CHAOS_TRAIN``, with **zero overhead
when off** (the loop and the data loader carry ``faults=None`` and every
hook site is a single ``is not None`` check).  Long training runs fail in
ways a clean test never exercises: a decode worker is OOM-killed or
deadlocks, one batch poisons the gradients, a checkpoint write is torn by
a crash, the scheduler preempts the host mid-step.  "TensorFlow: a system
for large-scale ML" (PAPERS.md) makes the case that fault tolerance must
be a designed-in axis — which first requires a way to *produce* the
faults on demand.

Spec grammar — comma-separated ``key=value`` pairs::

    seed=11,worker_kill=0.02,worker_stall=0.01,nan_loss=0.05,
    torn_ckpt=0.5,preempt=40

Arms:

* ``worker_kill``  — rate in [0, 1]: SIGKILL one live data worker
  (exercises death detection + bounded respawn + shm slot reclamation).
* ``worker_stall`` — rate in [0, 1]: every worker receives a stall task
  and goes silent (exercises the stall detector's respawn path).
* ``nan_loss``     — rate in [0, 1]: one step's batch is NaN-poisoned, so
  its loss/grads go non-finite (exercises divergence rollback).
* ``torn_ckpt``    — rate in [0, 1]: the just-written checkpoint file is
  truncated (exercises the writer's verify-after-write + resume fallback).
* ``preempt``      — an integer STEP (not a rate): SIGTERM is delivered to
  the process at that step (exercises the preemption path: finish the
  in-flight step, emergency checkpoint, distinct exit code, resume).

Every fire is deterministic given (seed, call order): each arm draws from
its own seeded RandomState, so a drill replays.  Fires are counted in
``raft_fault_injected_total{arm=}`` on the training registry and appended
to the active run log as ``fault_injected`` events — the same observables
the serving harness exports, so ``tlm`` reads both planes identically.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..lint.concurrency import guarded_by
from ..telemetry.log import get_logger

_log = get_logger("train")

ARMS = ("worker_kill", "worker_stall", "nan_loss", "torn_ckpt", "preempt")
RATE_ARMS = ("worker_kill", "worker_stall", "nan_loss", "torn_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainChaosSpec:
    """Parsed ``--chaos-train`` spec: per-arm rates + the preempt step."""

    seed: int = 0
    worker_kill: float = 0.0
    worker_stall: float = 0.0
    nan_loss: float = 0.0
    torn_ckpt: float = 0.0
    preempt: int = -1          # step at which SIGTERM fires; -1 = off

    @property
    def armed(self) -> bool:
        return (any(getattr(self, a) > 0 for a in RATE_ARMS)
                or self.preempt >= 0)


def parse_train_chaos_spec(spec: str) -> TrainChaosSpec:
    """Parse ``"seed=5,nan_loss=0.05,preempt=40"``; raises ValueError on an
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
            elif key == "preempt":
                fields[key] = int(val)
                if fields[key] < 0:
                    raise ValueError
            elif key in RATE_ARMS:
                fields[key] = float(val)
                if not 0.0 <= fields[key] <= 1.0:
                    raise ValueError
            else:
                raise KeyError(key)
        except KeyError:
            raise ValueError(
                f"unknown train-chaos arm {key!r}; arms: {', '.join(ARMS)} "
                f"(+ seed; preempt takes a step number, the rest rates)")
        except ValueError:
            raise ValueError(
                f"bad chaos value {part!r}: rates must be floats in [0, 1], "
                f"seed an int, preempt a non-negative step number")
    return TrainChaosSpec(**fields)


def _arm_seed(seed: int, arm: str) -> int:
    # distinct, stable stream per arm: the same spec replays the same fault
    # schedule regardless of which other arms are configured
    return (seed * 1_000_003 + sum(ord(c) for c in arm) * 7919) % (2 ** 31)


class TrainFaultInjector:
    """The armed injector one training run carries.  Hook sites sit in the
    train loop (``corrupt_batch``, ``maybe_preempt``), the checkpoint
    writer (``tear_checkpoint``) and the mp data loader (``roll`` on the
    worker arms + ``pick``).

    Thread model: ``roll`` takes a lock — arms fire from the main loop,
    the loader consumer, the loader feeder thread and the checkpoint
    writer thread, each on its own seeded stream, so the schedule stays
    deterministic per (seed, arm, call index).  ``disarm()`` mutes every
    rate-driven arm (how a drill ends its storm); ``force()`` queues
    explicit outcomes for deterministic tests and is honored even while
    disarmed.
    """

    _forced = guarded_by("_lock")
    _armed = guarded_by("_lock")
    _preempt_fired = guarded_by("_lock")
    _counter = guarded_by("_lock")
    injected = guarded_by("_lock")

    def __init__(self, spec: TrainChaosSpec, counter=None, run_log=None):
        self.spec = spec
        self.run_log = run_log            # telemetry.events.RunLog or None
        self._lock = threading.Lock()
        self._rng = {arm: np.random.RandomState(_arm_seed(spec.seed, arm))
                     for arm in RATE_ARMS}
        self._pick_rng = np.random.RandomState(_arm_seed(spec.seed, "pick"))
        self._forced: Dict[str, deque] = {}
        self._armed = True
        self._preempt_fired = False
        self.injected: Dict[str, int] = {arm: 0 for arm in ARMS}
        self.counter = counter            # raft_fault_injected_total{arm=}

    @property
    def counter(self):
        return self._counter

    @counter.setter
    def counter(self, c) -> None:
        """Attach the metric counter, backfilling fires that happened before
        it existed: the CLI arms the injector before the loader's feeder and
        prefetch threads start, but the registry (and this counter) is built
        inside train() — an early worker_kill/worker_stall roll must still
        land in ``raft_fault_injected_total``.  roll() reads the counter
        under the same lock, so each fire is counted exactly once (either by
        the backfill snapshot or by the roll that observed the counter)."""
        with self._lock:
            self._counter = c
            backfill = ({arm: n for arm, n in self.injected.items() if n}
                        if c is not None else {})
        for arm, n in backfill.items():
            c.labels(arm).inc(n)

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
        consumed before the seeded rng, for deterministic tests.  Forcing
        ``preempt`` fires regardless of the configured step."""
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
            elif arm not in RATE_ARMS:
                return False           # 'preempt' is step-triggered, not rated
            else:
                rate = getattr(self.spec, arm)
                if rate <= 0.0:
                    return False
                hit = bool(self._rng[arm].random_sample() < rate)
            if hit:
                self.injected[arm] += 1
            counter = self._counter
        if hit:
            if counter is not None:
                counter.labels(arm).inc()
            if self.run_log is not None:
                self.run_log.event("fault_injected", arm=arm)
            _log.warning(f"chaos: injecting fault arm={arm}")
        return hit

    def pick(self, n: int) -> int:
        """Deterministic victim index in [0, n) — which live worker the
        ``worker_kill`` arm targets."""
        return int(self._pick_rng.randint(max(n, 1)))

    # -- hook sites --------------------------------------------------------

    def corrupt_batch(self, batch):
        """NaN-poison one step's batch when the ``nan_loss`` arm fires (the
        first field — image1 — goes fully NaN, so the loss and every grad
        are non-finite); returns the input untouched otherwise."""
        if not self.roll("nan_loss"):
            return batch
        fields = tuple(batch)
        if isinstance(fields[0], torch.Tensor):   # staged on the device
            poisoned = torch.full_like(fields[0], float("nan"))
        else:
            poisoned = np.full_like(np.asarray(fields[0]), np.nan)
        return (poisoned,) + fields[1:]

    def tear_checkpoint(self, path) -> bool:
        """Truncate the just-written checkpoint when the ``torn_ckpt`` arm
        fires — the torn-write the writer's verify pass must catch."""
        if not self.roll("torn_ckpt"):
            return False
        size = os.path.getsize(path)
        with open(path, "rb+") as f:
            f.truncate(max(size // 2, 1))
        return True

    def maybe_preempt(self, step: int) -> bool:
        """Deliver SIGTERM to this process when ``step`` reaches the
        configured preempt step (once per run), or when a forced outcome
        is queued — the training loop's preemption guard turns it into a
        finish-step + emergency-checkpoint exit."""
        with self._lock:
            forced = self._forced.get("preempt")
            if forced:
                hit = forced.popleft()
            else:
                hit = (self._armed and self.spec.preempt >= 0
                       and step == self.spec.preempt
                       and not self._preempt_fired)
            if hit:
                self._preempt_fired = True
                self.injected["preempt"] += 1
            counter = self._counter
        if hit:
            if counter is not None:
                counter.labels("preempt").inc()
            if self.run_log is not None:
                self.run_log.event("fault_injected", arm="preempt",
                                   step=step)
            _log.warning(f"chaos: injecting fault arm=preempt at step {step}")
            os.kill(os.getpid(), signal.SIGTERM)
        return hit


def make_train_injector(spec: Optional[str], counter=None,
                        run_log=None) -> Optional[TrainFaultInjector]:
    """``--chaos-train``/env spec string -> injector, or None when the spec
    is empty/absent (the zero-overhead off state).  An explicit spec builds
    the injector even with all-zero rates — tests drive those via
    ``force()``."""
    if not spec:
        return None
    return TrainFaultInjector(parse_train_chaos_spec(spec), counter=counter,
                              run_log=run_log)
