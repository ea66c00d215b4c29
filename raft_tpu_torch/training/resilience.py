"""Preemption-safe, self-healing training: the resilience layer the loop
leans on (a copy of the JAX package's ``training/resilience.py``; a host
snapshot here is the state's named numpy leaves, ``checkpoint.host_state``).

Three pieces, each independently testable:

* :class:`CheckpointWriter` — **async checkpointing**.  The step loop
  snapshots device state to host at the step boundary (one D2H copy) and
  hands the arrays to a single background writer thread through a bounded
  queue; serialization, fsync, the verify pass and retention pruning all
  happen off the step path ("TensorFlow: a system for large-scale ML",
  PAPERS.md, is the canonical argument for decoupling checkpoint I/O from
  the step).  ``sync=True`` preserves the historical blocking behavior
  bit-for-bit (``--sync-ckpt``).  The async path additionally VERIFIES
  each write (``checkpoint_readable``) before counting it, pruning, or
  promoting it to the rollback restore point — a torn write (crash, chaos
  ``torn_ckpt`` arm) is unlinked on the spot, so ``latest_checkpoint``
  never points at an unreadable file.

* :class:`PreemptionGuard` — **SIGTERM/SIGINT turn into a flag**, not an
  immediate death: the loop finishes the in-flight step, drains an
  emergency checkpoint through the same writer, stamps a ``preempted``
  run-log event and raises :class:`TrainingPreempted`, which the CLI maps
  to :data:`PREEMPT_EXIT_CODE` so schedulers can distinguish "requeue me"
  from a crash.  Resume goes through the existing
  ``restore_latest_with_fallback`` + metrics.jsonl replay filter.

* :class:`LastGood` — the **divergence-rollback restore point**: the last
  host-side state snapshot whose params/BN stats passed the finite check.
  Kept in memory (not re-read from disk) so a rollback cannot race the
  write queue; costs one host copy of the state, ``--max-rollbacks 0``
  disables it.
"""

from __future__ import annotations

import os
import queue
import signal
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..telemetry.log import get_logger
from .checkpoint import (checkpoint_readable, host_state as to_host,
                         prune_checkpoints, save_checkpoint)

_log = get_logger("train")

# Distinct exit code for a preempted (SIGTERM/SIGINT) training run that
# wrote its emergency checkpoint: "requeue and resume", not "debug a crash".
PREEMPT_EXIT_CODE = 17


class TrainingPreempted(RuntimeError):
    """The loop stopped on SIGTERM/SIGINT after finishing the in-flight
    step; ``ckpt_path`` is the emergency checkpoint (None when no ckpt_dir
    or the state was non-finite)."""

    def __init__(self, step: int, signum: Optional[int],
                 ckpt_path: Optional[Path] = None):
        super().__init__(f"training preempted at step {step} "
                         f"(signal {signum})")
        self.step = step
        self.signum = signum
        self.ckpt_path = ckpt_path


class PreemptionGuard:
    """SIGTERM/SIGINT handler that records the request instead of killing
    the process; the training loop polls ``requested`` between steps.

    A second SIGINT raises KeyboardInterrupt — the user pressing Ctrl-C
    twice really means *now*, emergency checkpoint or not.  Installation
    is a no-op off the main thread (signal.signal would raise); tests can
    still set ``requested`` directly.
    """

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None
        self._prev = []

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev.append((sig, signal.signal(sig, self._handle)))
            except (ValueError, OSError):   # embedded interpreters
                pass
        return self

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        self.signum = signum
        # a Python-level print here could re-enter the buffered stdout
        # writer the interrupted main thread may be holding (RuntimeError:
        # reentrant call) and crash the run out of the handler — os.write
        # to fd 2 is unbuffered and safe in this context
        try:
            os.write(2, (f"[train] signal {signum}: finishing the in-flight "
                         f"step, then writing an emergency checkpoint\n")
                     .encode())
        except OSError:
            pass

    def remove(self) -> None:
        for sig, prev in self._prev:
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = []


class LastGood:
    """The rollback restore point: last finite host-state snapshot.
    Updated from the writer thread (after the finite check passes), read
    from the main loop — hence the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._step: Optional[int] = None
        self._state = None

    def update(self, step: int, host_state) -> None:
        with self._lock:
            self._step = int(step)
            self._state = host_state

    def get(self):
        """(step, host_state) or (None, None)."""
        with self._lock:
            return self._step, self._state


def nonfinite_count(host_state) -> int:
    """Number of NON-finite param/BN tensors in a host snapshot (the named
    leaves of ``checkpoint.host_state``; 0 = safe to persist).  Optimizer
    moments are excluded on purpose: apply_if_finite keeps them finite,
    and a transiently large moment is not divergence."""
    return sum(1 for name, x in host_state.items()
               if name.startswith(("params/", "bn_state/"))
               and not np.isfinite(np.asarray(x)).all())


def save_if_finite(path, host_state, log_fn, final: bool = False) -> bool:
    """Never persist poisoned params: a checkpoint written after NaN
    updates slipped through (apply_if_finite passes through after its
    error budget) would later be resumed as the 'last good' state.
    Returns True when a checkpoint was actually written."""
    bad = nonfinite_count(host_state)
    if bad:
        log_fn(f"[train] NOT saving {path}: {bad} param tensor(s) "
               f"non-finite (diverged); last good checkpoint is unchanged")
        return False
    save_checkpoint(path, host_state)
    log_fn(f"[train] saved {'final ' if final else ''}{path}")
    return True


class CheckpointWriter:
    """Single background writer for training checkpoints.

    ``submit(path, host_state, step)`` enqueues a snapshot (host arrays,
    or a ``checkpoint.DeviceSnapshot`` the writer copies to the host);
    the writer thread runs the finite check, the atomic
    fsync'd write, the verify pass, retention pruning, and the last-good
    promotion — the step loop never blocks on disk.  The queue is bounded
    (default 2): a disk slower than the checkpoint cadence backpressures
    the loop instead of accumulating unbounded host copies, and the stall
    is observable (``ckpt_queue_saturated`` run-log event +
    ``raft_ckpt_queue_depth``).

    ``sync=True``: ``submit`` runs the historical inline path —
    ``save_if_finite`` + prune, no verify — preserving today's blocking
    behavior bit-for-bit (``--sync-ckpt``).

    A writer-thread failure (disk full, permission) is stored and
    re-raised on the next ``submit``/``close`` — checkpointing failures
    must fail the run, not rot silently.
    """

    def __init__(self, log_fn=print, sync: bool = False,
                 keep: Optional[int] = None, faults=None,
                 metrics: Optional[dict] = None, run_log=None,
                 on_good=None, queue_depth: int = 2):
        self._log = log_fn
        self._sync = sync
        self._keep = keep
        self._faults = faults
        self._metrics = metrics or {}
        self._run_log = run_log
        self._on_good = on_good         # on_good(step, host_state)
        self._error: Optional[BaseException] = None
        self._closed = False
        self.last_path: Optional[Path] = None   # last CONFIRMED write
        # last SUBMITTED path (main-thread only): lets the loop skip an
        # emergency/final submit that would duplicate the periodic
        # checkpoint just enqueued for the same step
        self.last_submitted: Optional[Path] = None
        self._q: Optional[queue.Queue] = None
        self._thread = None
        if not sync:
            self._q = queue.Queue(maxsize=max(1, queue_depth))
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ckpt-writer")
            self._thread.start()

    # -- main-thread surface ----------------------------------------------

    def submit(self, path, host_state, step: int, final: bool = False) -> None:
        if self._error is not None:
            raise self._error
        if self._closed:
            raise RuntimeError("CheckpointWriter is closed")
        self.last_submitted = Path(path)
        if self._sync:
            self._write(Path(path), host_state, int(step), final)
            if self._error is not None:
                raise self._error
            return
        if self._q.full():
            # saturation: the step loop is about to block on the writer —
            # the disk is slower than the checkpoint cadence
            self._log(f"[train] async-ckpt queue saturated; step loop "
                      f"blocking on the writer (slow disk or short "
                      f"--ckpt-every)")
            if self._run_log is not None:
                self._run_log.event("ckpt_queue_saturated", step=int(step))
        self._q.put((Path(path), host_state, int(step), final))
        self._set_depth()

    def drain(self) -> None:
        """Block until every queued write completed; re-raise a writer
        failure."""
        if self._q is not None:
            self._q.join()
        if self._error is not None:
            raise self._error

    def close(self) -> None:
        """Drain, stop the thread, surface any stored failure.  Idempotent."""
        if self._closed:
            if self._error is not None:
                raise self._error
            return
        self._closed = True
        if self._q is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join(timeout=30)
        if self._error is not None:
            raise self._error

    # -- writer thread -----------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            finally:
                self._q.task_done()
                self._set_depth()

    def _write(self, path: Path, host_state, step: int, final: bool) -> None:
        t0 = time.monotonic()
        try:
            # a DeviceSnapshot becomes host arrays here, off the step path
            host_state = to_host(host_state)
            if not save_if_finite(path, host_state, self._log, final=final):
                return
            if self._on_good is not None:
                # the snapshot passed the finite check: it is a valid
                # rollback restore point even if the DISK copy tears below
                self._on_good(step, host_state)
            if self._faults is not None and not self._sync:
                # the torn-write arm targets the async verify pass; the
                # sync path is pinned to today's behavior bit-for-bit
                self._faults.tear_checkpoint(path)
            if not self._sync and not checkpoint_readable(path):
                # verify-after-write: a torn file must never be the one
                # latest_checkpoint/resume finds
                try:
                    path.unlink()
                except OSError:
                    pass
                self._log(f"[train] WARNING: checkpoint {path} failed the "
                          f"verify pass (torn write); removed — the "
                          f"previous checkpoint remains the restore point")
                return
            if "saved" in self._metrics:
                self._metrics["saved"].inc()
            self.last_path = path
            # retention prunes only AFTER the confirmed save: a failed,
            # skipped, or torn write never shrinks the good set
            if self._keep:
                prune_checkpoints(path.parent, self._keep, log_fn=self._log)
        except BaseException as e:  # noqa: BLE001 — surfaced on next submit
            self._error = e
            _log.error(f"checkpoint writer failed on {path}: {e!r}")
        finally:
            if "write_seconds" in self._metrics:
                self._metrics["write_seconds"].observe(time.monotonic() - t0)

    def _set_depth(self) -> None:
        if "queue_depth" in self._metrics and self._q is not None:
            self._metrics["queue_depth"].set(self._q.qsize())
