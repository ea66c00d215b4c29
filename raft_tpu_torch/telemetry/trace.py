"""Named-stage tracing: ``stage()`` scopes + the step-window profiler.

The port's counterpart of the JAX package's ``telemetry/trace.py``.
``stage(name)`` opens a ``torch.profiler.record_function`` range (named in
a ``torch.profiler`` trace) and, on a CUDA build with a device, an NVTX
range of the same name; it also keeps the thread-local stage stack that
:mod:`watchdogs` reads to attribute captures and lock violations to the
stage that was active.  Both ranges are host-side annotations: they
launch nothing on the device, so a stage may enclose a CUDA graph capture
or replay.

``TraceWindow`` traces a window of steps (device batches of a server)
with ``torch.profiler`` and writes a Chrome trace; :func:`capture_profile`
is the on-demand, wall-clock form behind ``POST /debug/profile``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

_stack = threading.local()

#: The file a capture writes in its directory (Chrome trace JSON, readable
#: by chrome://tracing and Perfetto).
TRACE_FILE = "trace.json"


def _stages() -> list:
    if not hasattr(_stack, "names"):
        _stack.names = []
    return _stack.names


def current_stage() -> Optional[str]:
    """Innermost active ``stage()`` name on this thread (provenance for the
    watchdogs), or None outside any stage."""
    names = _stages()
    return names[-1] if names else None


def _nvtx_on() -> bool:
    import torch
    return torch.cuda.is_available()


@contextlib.contextmanager
def stage(name: str):
    """A ``torch.profiler.record_function(name)`` range, an NVTX range on
    CUDA, and provenance bookkeeping; usable as a context manager or, via
    ``contextlib``, as a decorator."""
    import torch
    names = _stages()
    names.append(name)
    nvtx = _nvtx_on()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        names.pop()


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


_profiler_warm = False
# the thread that opens the profiler's first session for captures asked on
# other threads (host_profiler_warmup), and its handshake with them
_warm_host: Optional[int] = None
_warm_asked = threading.Event()
_warm_done = threading.Event()
_warm_error: Optional[BaseException] = None
#: Seconds a capture waits for the hosting thread to open the first session.
WARM_TIMEOUT_S = 60.0


def _warm() -> None:
    global _profiler_warm
    if not _profiler_warm:
        prof = _start_profiler()
        prof.stop()
        _profiler_warm = True


def warm_profiler() -> None:
    """Start and stop one empty ``torch.profiler`` session (the CUDA
    activity included when there is a card) on the calling thread.  The
    profiler's CUDA backend (kineto over CUPTI) initializes on its first
    session and requires that to happen on the thread that registered its
    client: a first session opened from a request handler thread (``POST
    /debug/profile``) fails that check: its sessions then lose their CUDA
    events, and a capture can hang.  The first session costs seconds (~8 s
    on an H100; 1-2 s on the CPU).  Once per process."""
    if _profiler_warm:
        return
    with _capture_lock:
        _warm()


def host_profiler_warmup(stopped: threading.Event,
                         poll_s: float = 0.5) -> None:
    """Block until ``stopped`` is set.  Meanwhile, when a capture on another
    thread needs the profiler's first session, open it here: a server's
    foreground thread (``FlowServer.wait``, the main thread of ``-m
    serve``) hosts it, so a process pays the start-up only when it is
    first profiled, never at boot."""
    global _warm_host, _warm_error
    prev, _warm_host = _warm_host, threading.get_ident()
    try:
        while not stopped.is_set():
            if _warm_asked.wait(poll_s):
                _warm_asked.clear()
                try:
                    _warm()
                except BaseException as e:  # noqa: BLE001 — the capture's
                    _warm_error = e
                _warm_done.set()
    finally:
        _warm_host = prev


def _first_session() -> None:
    """Open the profiler's first session, on the hosting thread where one
    waits (the caller holds ``_capture_lock``), else on this one."""
    global _warm_error
    host = _warm_host
    if host is None or host == threading.get_ident():
        _warm()
        return
    _warm_error = None
    _warm_done.clear()
    _warm_asked.set()
    if not _warm_done.wait(WARM_TIMEOUT_S):
        raise RuntimeError(f"the profiler's first session did not open "
                           f"within {WARM_TIMEOUT_S:g} s on its host "
                           f"thread")
    if _warm_error is not None:
        raise _warm_error


def _start_profiler():
    import torch
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop_profiler(prof, dest: str) -> str:
    """Stop ``prof`` and write its Chrome trace into directory ``dest``;
    returns the file's path."""
    prof.stop()
    return _write_trace(prof, dest)


def _write_trace(prof, dest: str) -> str:
    """Write stopped ``prof``'s Chrome trace into directory ``dest``;
    returns the file's path."""
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


class TraceWindow:
    """Start/stop a ``torch.profiler`` trace over a step window.

    ``TraceWindow(dir, first, steps)`` traces steps ``[first, first+steps)``
    — call ``on_step(i)`` before executing step ``i``; returns True while
    tracing.  A ``trace_dir`` of None makes every call a no-op, so call
    sites need no conditionals.  ``stop()`` is idempotent, must run on
    every exit path, and writes ``<trace_dir>/trace.json``.
    """

    def __init__(self, trace_dir: Optional[str], first: int = 2,
                 steps: int = 4, log_fn=None):
        self.trace_dir = trace_dir
        self.first = first
        self.last = first + steps          # exclusive
        self._prof = None
        self._done = trace_dir is None
        self._log = log_fn or (lambda msg: None)

    def on_step(self, step: int) -> bool:
        if self._done:
            return False
        if self._prof is None and self.first <= step < self.last:
            self._prof = _start_profiler()
        elif self._prof is not None and step >= self.last:
            self.stop()
        return self._prof is not None

    def stop(self) -> None:
        if self._prof is not None:
            path = _stop_profiler(self._prof, self.trace_dir)
            self._prof = None
            self._done = True
            self._log(f"wrote profiler trace to {path}")


class CaptureBusy(RuntimeError):
    """A profiler capture is already in flight (the profiler is a
    process-wide singleton).  HTTP maps this to 409."""


# torch.profiler holds one process-global profiler: the on-demand capture
# endpoint must single-flight across ALL servers in the process (tests run
# several), not per FlowServer.
_capture_lock = threading.Lock()

MAX_CAPTURE_MS = 60_000.0


def capture_profile(trace_dir: Optional[str], duration_ms: float,
                    log_fn=None, quiesce=None) -> dict:
    """Time-boxed on-demand ``torch.profiler`` capture: start a trace,
    sleep ``duration_ms`` while the serving threads keep working, stop,
    write the Chrome trace, return ``{"trace_dir", "trace_file",
    "duration_ms", "started"}`` — for profiling a LIVE replica (POST
    /debug/profile) without a restart.

    Single-flight via a process-wide non-blocking lock (:class:`CaptureBusy`
    when one is already running).  ``trace_dir=None`` allocates a fresh
    temp dir per capture; each capture lands in a timestamped subdirectory
    so repeated captures never collide.

    ``quiesce``: a lock (the serving engine's device lock) held while the
    profiler's session opens and closes, so no other thread launches a
    CUDA graph then: on an H100 a replay launched while CUPTI switched its
    activity collection on or off hung (ROADMAP C10).  The capture window
    itself runs unlocked, so what is profiled is live serving."""
    if not 0 < duration_ms <= MAX_CAPTURE_MS:
        raise ValueError(f"duration_ms must be in (0, {MAX_CAPTURE_MS:g}], "
                         f"got {duration_ms}")
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    try:
        import tempfile
        started = time.time()
        if trace_dir is None:
            dest = tempfile.mkdtemp(prefix="raft-profile-")
        else:
            dest = os.path.join(trace_dir, time.strftime(
                "%Y%m%dT%H%M%S", time.gmtime(started)))
        held = quiesce if quiesce is not None else contextlib.nullcontext()
        with held:
            if not _profiler_warm:
                _first_session()
            prof = _start_profiler()
        try:
            time.sleep(duration_ms / 1000.0)
        finally:
            with held:
                prof.stop()
            path = _write_trace(prof, dest)
        if log_fn is not None:
            log_fn(f"on-demand profiler capture: {duration_ms:g}ms "
                   f"-> {path}")
        return {"trace_dir": dest, "trace_file": path,
                "duration_ms": duration_ms, "started": round(started, 3)}
    finally:
        _capture_lock.release()
