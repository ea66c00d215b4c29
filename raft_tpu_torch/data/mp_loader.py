"""Multi-process host-side sample loading, which no torn frame can block.

The port's counterpart of the JAX package's ``data/mp_loader.py``:
worker *processes* each run ``dataset[idx]`` (decode + augment, numpy
only: no ``torch.cuda``, no device) and stream finished samples back to
the consumer, which batches and stages them (``pipeline.batched`` +
``PrefetchLoader``).  Two transports: ``'pickle'`` sends each sample
pickled; ``'shm'`` writes it into a ring of ``multiprocessing.
shared_memory`` slots (:class:`ShmRing`, layout :class:`SampleSpec`) and
sends only the slot's number.  **Under shm, yielded arrays are views
valid until the next iteration** — collate them copy-on-arrival
(``pipeline.batched`` with a ``BatchBuffers`` collator does).

Design: one pair of pipes per worker, no shared queue.

* **Results.** Each worker writes length-prefixed frames (an 8-byte length,
  then a pickle) to a pipe of its own.  The consumer holds that pipe's read
  end non-blocking and reads whatever bytes are there into the worker's own
  frame buffer; it unpickles a frame only once all its bytes have arrived.
  The consumer blocks in one place only, a ``multiprocessing.connection.
  wait`` over every worker's pipe and exit sentinel with a timeout.  So a
  worker SIGKILLed in the middle of a frame leaves a partial buffer, which
  nothing waits on: the sentinel fires, the frames that did arrive whole
  are kept, and the partial one is dropped with the worker.  (The JAX
  package's loader shares one ``multiprocessing.Queue``: a kill mid-put
  leaves a torn frame whose poll reports data and whose ``recv`` then
  waits forever; and a kill inside a queue call can leave its lock held.)
  The consumer closes its copy of each pipe's write end, so the dead
  worker's pipe ends in EOF rather than silence.
* **Tasks.** The consumer sends each worker its tasks (index, content seed
  and, under shm, the slot to write) on a second pipe, two at a time,
  and keeps the ledger of what each worker holds.  A dead or stalled
  worker's tasks are sent again to its replacement and its slots go back
  to the ring, so even a bounded run (``epochs``) delivers every sample
  after a respawn.  No feeder thread.
* **Self-healing.** A worker that dies (exit code not 0: OOM killer,
  segfault, SIGKILL) or stalls (tasks outstanding and no frame for
  ``stall_timeout`` seconds, plus a start-up allowance before its first
  frame) is killed and replaced alone, at most ``max_respawns`` times in
  two minutes; beyond that the loader raises with each worker's exit code
  and the free slots.  Counted in ``respawns`` and
  ``raft_data_worker_respawns_total``.
* **Determinism.** Each task carries a content seed from (loader seed,
  epoch, index), as in the JAX package; the worker reseeds the
  augmentor's ``RandomState`` before producing the sample, so a sample's
  content does not depend on which worker made it, or when.
* **Start method** ``'forkserver'`` by default: the consumer is a CUDA
  process with threads, where a plain fork can copy a held lock into the
  child.  The server preloads this module (and so the package), and each
  worker forks from it without importing anew.  ``'fork'`` and
  ``'spawn'`` are accepted.
"""

from __future__ import annotations

import fcntl
import itertools
import multiprocessing as mp
import os
import pickle
import signal
import struct
import time
import traceback
from collections import deque
from multiprocessing import connection as mp_connection
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.log import get_logger
from ..telemetry.registry import default_registry

_log = get_logger("data")

_SLOT_ALIGN = 64
_LEN = struct.Struct("<Q")
_STARTUP_S = 60.0       # allowance for a worker's first frame (imports)
_READ_CHUNK = 1 << 20
_PER_WORKER = 2         # tasks a worker holds: one made, one queued
_RESPAWN_WINDOW_S = 120.0


def _loader_metrics():
    reg = default_registry()
    return {
        "samples": reg.get_or_counter(
            "raft_data_samples_total",
            "Samples delivered by worker-process loaders"),
        "errors": reg.get_or_counter(
            "raft_data_errors_total",
            "Data loader failures (worker exception, silent death, stall)"),
        "free_slots": reg.get_or_gauge(
            "raft_data_shm_free_slots",
            "Shared-memory transport: slots currently on the free list"),
        "respawns": reg.get_or_counter(
            "raft_data_worker_respawns_total",
            "Worker respawns healing a dead or stalled worker"),
    }


class SampleSpec:
    """Fixed byte layout of one sample inside a shared-memory slot: an
    ordered list of (shape, dtype) fields at 64-byte-aligned offsets.  Every
    sample must match it exactly (a mismatch is a worker error)."""

    def __init__(self, fields: Sequence[Tuple[Tuple[int, ...], np.dtype]]):
        self.fields = tuple((tuple(int(d) for d in shape), np.dtype(dt))
                            for shape, dt in fields)
        offsets = []
        off = 0
        for shape, dt in self.fields:
            off = -(-off // _SLOT_ALIGN) * _SLOT_ALIGN
            offsets.append(off)
            off += int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        self.offsets = tuple(offsets)
        self.nbytes = off

    @classmethod
    def from_sample(cls, sample) -> "SampleSpec":
        return cls([(np.asarray(f).shape, np.asarray(f).dtype)
                    for f in sample])

    def views(self, buf) -> Tuple[np.ndarray, ...]:
        """Zero-copy numpy views of every field over a slot's buffer."""
        return tuple(np.ndarray(shape, dtype=dt, buffer=buf, offset=off)
                     for (shape, dt), off in zip(self.fields, self.offsets))

    def write(self, buf, sample) -> None:
        views = self.views(buf)
        if len(sample) != len(views):
            raise ValueError(f"sample has {len(sample)} fields, "
                             f"slot layout has {len(views)}")
        for dst, src in zip(views, sample):
            # exact shapes only: broadcasting would let a mis-shaped frame
            # fill the slot without an error
            if np.shape(src) != dst.shape:
                raise ValueError(f"sample field shape {np.shape(src)} != "
                                 f"slot field shape {dst.shape}")
            dst[...] = src


class ShmRing:
    """Owner side of the slot ring: ``slots`` shared-memory blocks of
    ``nbytes``; workers attach by name.  :meth:`unlink` removes the names
    and keeps the owner's mappings (views may still be live in another
    thread); :meth:`close` also unmaps, for an owner that controls every
    view's lifetime."""

    def __init__(self, slots: int, nbytes: int):
        from multiprocessing import shared_memory
        self.shms = []
        self._unlinked = False
        try:
            for _ in range(slots):
                self.shms.append(
                    shared_memory.SharedMemory(create=True, size=max(nbytes, 1)))
        except BaseException:
            self.close()
            raise
        self.names = tuple(s.name for s in self.shms)

    def views(self, spec: SampleSpec, slot: int) -> Tuple[np.ndarray, ...]:
        return spec.views(self.shms[slot].buf)

    def unlink(self) -> None:
        if self._unlinked:
            return
        self._unlinked = True
        for s in self.shms:
            try:
                s.unlink()
            except OSError:
                pass

    def close(self) -> None:
        self.unlink()
        for s in self.shms:
            try:
                s.close()
            except (OSError, BufferError):
                pass
        self.shms = []


# ---------------------------------------------------------------- framing

def _write_frame(fd: int, obj) -> None:
    """One length-prefixed pickle frame, written whole (blocking fd)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(_LEN.pack(len(payload)) + payload)
    while view:
        view = view[os.write(fd, view):]


def _read_exact(fd: int, n: int) -> Optional[bytes]:
    """``n`` bytes from a blocking fd, or None at EOF."""
    parts, got = [], 0
    while got < n:
        chunk = os.read(fd, n - got)
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _read_frame(fd: int):
    """The next frame from a blocking fd (the worker's task pipe), or None
    at EOF (the consumer is gone)."""
    head = _read_exact(fd, _LEN.size)
    if head is None:
        return None
    body = _read_exact(fd, _LEN.unpack(head)[0])
    return None if body is None else pickle.loads(body)


class _FrameReader:
    """Consumer side of one worker's result pipe: non-blocking reads into
    the frame being assembled; :meth:`pump` returns the frames completed
    so far and whether the pipe reached EOF.  A frame cut short by the
    worker's death stays partial and is dropped with the reader."""

    def __init__(self, fd: int):
        self.fd = fd
        os.set_blocking(fd, False)
        self._head = b""
        self._body: Optional[bytearray] = None
        self._got = 0

    def pump(self) -> Tuple[list, bool]:
        frames = []
        while True:
            try:
                if self._body is None:
                    chunk = os.read(self.fd, _LEN.size - len(self._head))
                    if not chunk:
                        return frames, True
                    self._head += chunk
                    if len(self._head) < _LEN.size:
                        continue
                    self._body = bytearray(_LEN.unpack(self._head)[0])
                    self._head, self._got = b"", 0
                if self._got < len(self._body):
                    k = os.readv(self.fd, [memoryview(self._body)[self._got:]])
                    if k == 0:
                        return frames, True
                    self._got += k
                if self._got == len(self._body):
                    frames.append(pickle.loads(self._body))
                    self._body = None
            except BlockingIOError:
                return frames, False


# ---------------------------------------------------------------- workers

def _attach_slots(names):
    """Worker-side attach.  Workers share the owner's resource tracker,
    where a registration is idempotent, and the owner's ``unlink``
    unregisters once: do not unregister here."""
    from multiprocessing import shared_memory
    return [shared_memory.SharedMemory(name=name) for name in names]


def _worker_loop(dataset, task_conn, result_conn, shm=None):
    """A worker: read tasks from its pipe, write one frame per task."""
    out_fd, in_fd = result_conn.fileno(), task_conn.fileno()
    _write_frame(out_fd, ("ready",))
    slots = spec = None
    if shm is not None:
        names, spec = shm
        slots = _attach_slots(names)
    while True:
        task = _read_frame(in_fd)
        if task is None or task[0] == "stop":
            break
        if task[0] == "stall":
            # injected stall (chaos arm worker_stall): alive but silent
            time.sleep(task[1])
            continue
        _, tid, idx, seed, slot = task
        try:
            aug = getattr(dataset, "augmentor", None)
            if aug is not None and hasattr(aug, "rng"):
                aug.rng = np.random.RandomState(seed)
            sample = dataset[idx]
            if slots is None:
                _write_frame(out_fd, ("ok", tid, sample))
            else:
                spec.write(slots[slot].buf, sample)
                _write_frame(out_fd, ("ok", tid, slot))
        except Exception:  # noqa: BLE001 — reported to the consumer
            _write_frame(out_fd, ("error", tid, traceback.format_exc()))
            break


class _Worker:
    """The consumer's record of one worker process."""

    def __init__(self, proc, task_conn, result_conn):
        self.proc = proc
        self.task_conn = task_conn
        self.result_conn = result_conn
        self.reader = _FrameReader(result_conn.fileno())
        self.inflight = {}            # task id -> (idx, seed, slot)
        self.ready = False
        self.last_progress = time.monotonic()
        self.eof = False

    def stalled_for(self, now: float) -> float:
        return now - self.last_progress - (0.0 if self.ready else _STARTUP_S)

    def close(self) -> None:
        for conn in (self.task_conn, self.result_conn):
            try:
                conn.close()
            except OSError:
                pass


class MPSampleLoader:
    """Iterator of samples produced by worker processes (the module
    docstring says how); feed it to ``pipeline.batched``.

    ``transport='shm'`` streams through a shared-memory slot ring of
    ``shm_slots`` slots (default ``2 * num_workers + 2``; its layout from
    ``dataset[0]``, probed once).  ``epochs`` bounds the run (None:
    endless, shuffled anew each epoch).  ``stall_timeout``: seconds
    without a frame from a worker that holds tasks before it is replaced
    (None: never).  ``faults``: a training ``TrainFaultInjector`` whose
    ``worker_kill`` and ``worker_stall`` arms act here."""

    def __init__(self, dataset, num_workers: int = 4, seed: int = 0,
                 shuffle: bool = True, epochs: Optional[int] = None,
                 stall_timeout: Optional[float] = 300.0,
                 start_method: str = "forkserver",
                 transport: str = "pickle",
                 shm_slots: Optional[int] = None,
                 faults=None, max_respawns: int = 3):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if start_method not in ("fork", "forkserver", "spawn"):
            raise ValueError(f"start_method must be fork/forkserver/spawn, "
                             f"got {start_method!r}")
        if transport not in ("pickle", "shm"):
            raise ValueError(f"transport must be pickle/shm, got {transport!r}")
        self._dataset = dataset
        self._num_workers = num_workers
        # the stall checks run at least four times per stall window
        self._poll_timeout = min(1.0, (stall_timeout or 4.0) / 4)
        self._stall_timeout = stall_timeout
        self._start_method = start_method
        self._transport = transport
        self._faults = faults
        self._max_respawns = max_respawns
        self._respawn_times: deque = deque()
        self.respawns = 0
        self._ctx = mp.get_context(start_method)
        if start_method == "forkserver":
            # the server imports the package once; each worker forks from
            # it warm (this takes effect when the server first starts)
            self._ctx.set_forkserver_preload([__name__])
        self._ring = self._spec = None
        self._free: deque = deque()
        if transport == "shm":
            self._spec = SampleSpec.from_sample(dataset[0])
            n_slots = (shm_slots if shm_slots is not None
                       else _PER_WORKER * num_workers + 2)
            if n_slots < 2:
                raise ValueError(f"shm transport needs >= 2 slots "
                                 f"(1 pending + 1 circulating), got {n_slots}")
            self._ring = ShmRing(n_slots, self._spec.nbytes)
            self._free.extend(range(n_slots))
        self._tasks = self._task_stream(len(dataset), seed, shuffle, epochs)
        self._requeued: deque = deque()    # tasks of replaced workers
        self._n_tasks = len(dataset) * epochs if epochs is not None else None
        self._issued = 0
        self._next_tid = itertools.count()
        self._ready: deque = deque()       # finished ("ok", payload)
        self._pending_slot = None          # shm slot the consumer views
        self._closed = False
        self._workers: List[_Worker] = []
        try:
            for _ in range(num_workers):
                self._workers.append(self._spawn())
        except BaseException:
            self.close()
            raise

    @staticmethod
    def _task_stream(n: int, seed: int, shuffle: bool,
                     epochs: Optional[int]):
        rng = np.random.RandomState(seed)
        for epoch in itertools.count():
            if epochs is not None and epoch >= epochs:
                return
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
            for idx in order:
                yield int(idx), (seed * 1_000_003 + epoch * 97_003
                                 + int(idx)) % (2 ** 31)

    def _spawn(self) -> _Worker:
        task_r, task_w = self._ctx.Pipe(duplex=False)
        res_r, res_w = self._ctx.Pipe(duplex=False)
        shm_args = ((self._ring.names, self._spec)
                    if self._ring is not None else None)
        proc = self._ctx.Process(target=_worker_loop,
                                 args=(self._dataset, task_r, res_w, shm_args),
                                 daemon=True)
        proc.start()
        # the worker holds the only write end of its result pipe now: its
        # death ends the pipe in EOF
        task_r.close()
        res_w.close()
        try:     # fewer wake-ups per multi-MB pickled sample (Linux)
            fcntl.fcntl(res_r.fileno(), fcntl.F_SETPIPE_SZ, _READ_CHUNK)
        except (AttributeError, OSError):
            pass
        return _Worker(proc, task_w, res_r)

    # ----------------------------------------------------------- dispatch

    def _next_task(self):
        if self._requeued:
            return self._requeued.popleft()
        if self._n_tasks is not None and self._issued >= self._n_tasks:
            return None
        task = next(self._tasks, None)
        if task is not None:
            self._issued += 1
        return task

    def _send(self, w: _Worker, frame) -> bool:
        try:
            _write_frame(w.task_conn.fileno(), frame)
            return True
        except OSError:          # the worker is gone; its sentinel says so
            return False

    def _dispatch(self) -> None:
        """Top every live worker up to its two tasks (under shm, while a
        slot is free)."""
        for w in self._workers:
            while (len(w.inflight) < _PER_WORKER and not w.eof
                   and (self._ring is None or self._free)):
                task = self._next_task()
                if task is None:
                    return
                if (self._faults is not None
                        and self._faults.roll("worker_stall")):
                    # every worker goes silent past the stall window
                    dur = (self._stall_timeout or 2.0) * 1.5 + 1.0
                    for v in self._workers:
                        self._send(v, ("stall", dur))
                idx, seed = task[:2]
                slot = self._free.popleft() if self._ring is not None else None
                tid = next(self._next_tid)
                if not w.inflight:
                    w.last_progress = time.monotonic()
                w.inflight[tid] = (idx, seed, slot)
                if not self._send(w, ("task", tid, idx, seed, slot)):
                    break

    # ---------------------------------------------------------- receiving

    def _take(self, w: _Worker, metrics) -> None:
        """Read what ``w``'s pipe holds; complete frames become ready
        samples, progress or a raised worker error."""
        frames, eof = w.reader.pump()
        w.eof = w.eof or eof
        for frame in frames:
            w.last_progress = time.monotonic()
            if frame[0] == "ready":
                w.ready = True
                continue
            status, tid, payload = frame
            w.inflight.pop(tid, None)
            if status == "error":
                self.close()
                metrics["errors"].inc()
                raise RuntimeError(f"data worker failed:\n{payload}")
            self._ready.append(payload)

    def _fill(self, metrics) -> bool:
        """Wait until a sample is ready; False when a bounded run has
        delivered everything."""
        while not self._ready:
            self._dispatch()
            if (self._n_tasks is not None and self._issued >= self._n_tasks
                    and not self._requeued
                    and not any(w.inflight for w in self._workers)):
                return False
            waitables = {}
            for w in self._workers:
                if not w.eof:
                    waitables[w.result_conn] = w
                waitables[w.proc.sentinel] = w
            fired = mp_connection.wait(list(waitables),
                                       timeout=self._poll_timeout)
            for obj in fired:
                w = waitables[obj]
                if obj is w.result_conn:
                    self._take(w, metrics)
            dead = [w for w in self._workers if not w.proc.is_alive()]
            for w in dead:
                self._take(w, metrics)          # frames that arrived whole
            if dead:
                self._heal_or_raise("death", dead, metrics)
                continue
            if self._stall_timeout is not None:
                now = time.monotonic()
                stalled = [w for w in self._workers if w.inflight
                           and w.stalled_for(now) > self._stall_timeout]
                if stalled:
                    self._heal_or_raise("stall", stalled, metrics)
        return True

    def __iter__(self) -> Iterator:
        metrics = _loader_metrics()
        try:
            while True:
                # chaos (worker_kill arm): SIGKILL one live worker, as the
                # OOM killer would
                if (self._faults is not None
                        and self._faults.roll("worker_kill")):
                    live = [w for w in self._workers if w.proc.is_alive()]
                    if live:
                        os.kill(live[self._faults.pick(len(live))].proc.pid,
                                signal.SIGKILL)
                if not self._fill(metrics):
                    return
                payload = self._ready.popleft()
                metrics["samples"].inc()
                if self._ring is None:
                    yield payload
                    continue
                # the consumer has moved past the previous sample (the
                # copy-on-arrival contract): its slot goes back on the ring
                if self._pending_slot is not None:
                    self._free.append(self._pending_slot)
                self._pending_slot = payload
                metrics["free_slots"].set(len(self._free))
                yield self._ring.views(self._spec, payload)
        finally:
            self.close()

    # ------------------------------------------------------ self-healing

    def _diagnostics(self) -> str:
        """Each worker's exit code (negative: killed by that signal, -9 is
        the OOM killer's SIGKILL; alive: a stall candidate) and the free
        slots."""
        codes = ", ".join(
            f"pid {w.proc.pid}="
            f"{'alive' if w.proc.is_alive() else w.proc.exitcode}"
            for w in self._workers)
        s = f"worker exitcodes [{codes}]"
        if self._ring is not None:
            s += f"; shm free slots {len(self._free)}/{len(self._ring.shms)}"
        return s

    def _respawn_allowed(self) -> bool:
        now = time.monotonic()
        while (self._respawn_times
               and now - self._respawn_times[0] > _RESPAWN_WINDOW_S):
            self._respawn_times.popleft()
        return len(self._respawn_times) < self._max_respawns

    def _heal_or_raise(self, reason: str, victims: List[_Worker],
                       metrics) -> None:
        diag = self._diagnostics()
        if not self._respawn_allowed():
            self.close()
            metrics["errors"].inc()
            what = ("died without reporting (killed by the OS? check dmesg "
                    "for OOM)" if reason == "death" else
                    f"held tasks but sent nothing for {self._stall_timeout}"
                    f" s (stalled storage or a deadlock)")
            raise RuntimeError(
                f"data worker(s) {what} and the respawn budget "
                f"({self._max_respawns} per {_RESPAWN_WINDOW_S:.0f}s) "
                f"is spent; {diag}")
        self._respawn_times.append(time.monotonic())
        for w in victims:
            if w.proc.is_alive():
                w.proc.kill()
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                # a kernel-stuck worker could still write a slot that a new
                # worker is given: fail rather than corrupt a sample
                self.close()
                metrics["errors"].inc()
                raise RuntimeError(f"data worker survived SIGKILL during a "
                                   f"{reason} respawn; {diag}")
            self._take(w, metrics)
            # its unfinished tasks go to its replacement, their slots back
            # on the ring
            for tid, (idx, seed, slot) in sorted(w.inflight.items()):
                self._requeued.append((idx, seed))
                if slot is not None:
                    self._free.append(slot)
            w.inflight.clear()
            w.close()
            self._workers[self._workers.index(w)] = self._spawn()
        self.respawns += 1
        metrics["respawns"].inc()
        if self._ring is not None:
            metrics["free_slots"].set(len(self._free))
        _log.warning(f"respawned {len(victims)} data worker(s) after "
                     f"{reason} ({len(self._respawn_times)}/"
                     f"{self._max_respawns} in window); {diag}")
        from ..telemetry import events as tlm_events
        run_log = tlm_events.current()
        if run_log is not None:
            run_log.event("worker_respawn", reason=reason, diagnostics=diag,
                          respawns_in_window=len(self._respawn_times))

    def close(self) -> None:
        """Stop the workers (a stop frame, then terminate and kill what
        lingers) and unlink the slot ring.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            self._send(w, ("stop",))
        deadline = time.monotonic() + 2.0
        for w in self._workers:
            w.proc.join(timeout=max(deadline - time.monotonic(), 0.0))
        for w in self._workers:
            if w.proc.is_alive():
                w.proc.kill()
            w.proc.join(timeout=5)
            w.close()
        if self._ring is not None:
            # unlink only: views of the slots may still be live in the
            # consumer; the pages return when the process exits
            self._ring.unlink()

    def __enter__(self) -> "MPSampleLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def measure_rate(sample_iter, n: int, warmup: int = 2) -> float:
    """Samples per second of an iterator, after ``warmup`` discarded
    samples."""
    it = iter(sample_iter)
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return n / (time.perf_counter() - t0)
