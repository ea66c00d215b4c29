"""Start N ranks of one program on this host, each in its own process.

:func:`run_ranks` (:func:`start_ranks`, then ``results()``) spawns
``nprocs`` fresh interpreters (``spawn``: no state of the parent, its
threads or its CUDA context, is inherited), each
joining one process group and calling ``fn(rank, world, *args)``; it
returns every rank's result in rank order, or raises with the failing
rank's traceback.  Nothing can outlive its deadline: the group times out
after ``group_timeout_s``, the parent waits at most ``deadline_s`` for
all results, and on any failure or timeout every rank still running is
killed before the error is raised.  A rank sends its result before it
tears its group down; once every result is in, the ranks have
``EXIT_GRACE_S`` to exit and what is left of their teardown is killed.
``fn`` must be importable by name (a module-level function) and its
results picklable.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

EXIT_GRACE_S = 5.0     # seconds a rank has to exit after its result is in


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               group_timeout_s: float, args: Sequence, results, threads):
    ok, out = True, None
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        out = fn(rank, world, *args)
    except BaseException:                 # noqa: BLE001 — reported to the parent
        ok, out = False, traceback.format_exc()
    # the result first: the group's and the process's teardown (a CUDA
    # context, gloo's) can take seconds, and the parent needs none of it
    results.put((rank, ok, out))
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:                     # noqa: BLE001 — the result stands
        pass


class RankGroup:
    """``nprocs`` spawned ranks of one program in flight
    (:func:`start_ranks`); :meth:`results` waits for them."""

    def __init__(self, fn: Callable, nprocs: int, args: Sequence,
                 init_method: Optional[str], backend: str,
                 group_timeout_s: float, deadline_s: float,
                 threads: Optional[int]):
        self.nprocs, self.deadline_s = nprocs, deadline_s
        self._tmp = None
        if init_method is None:
            self._tmp = tempfile.mkdtemp(prefix="raft_ranks_")
            init_method = "file://" + os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, nprocs, init_method, backend, group_timeout_s,
                  tuple(args), self._queue, threads)) for r in range(nprocs)]
        self._end = time.monotonic() + deadline_s
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._stop()
            raise

    def results(self) -> List:
        """Every rank's result by rank; on a failure, a dead rank or the
        deadline, every rank still running is killed and the error
        raised."""
        out: dict = {}
        procs, n = self._procs, self.nprocs
        try:
            while len(out) < n:
                left = self._end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n)) - set(out))} gave no "
                        f"result within {self.deadline_s:.0f} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                try:
                    # a rank that has exited has flushed its result, if any
                    rank, ok, res = self._queue.get(
                        timeout=5.0 if dead else min(left, 1.0))
                except queue.Empty:
                    if dead:
                        # killed, or its interpreter crashed: no result
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{res}")
                out[rank] = res
            # every result is in: the ranks get EXIT_GRACE_S to exit on
            # their own, then _stop kills what is left of their teardown
            grace = time.monotonic() + EXIT_GRACE_S
            for p in procs:
                p.join(timeout=max(0.1, grace - time.monotonic()))
        finally:
            self._stop()
        return [out[r] for r in range(n)]

    def _stop(self) -> None:
        """Kill every rank still running (one blocked putting a result the
        parent never reads, too: it holds multiprocessing's resource
        tracker open) and shut the queue; idempotent."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=10)
        self._queue.cancel_join_thread()
        self._queue.close()
        if self._tmp is not None and os.path.isdir(self._tmp):
            for name in os.listdir(self._tmp):
                os.unlink(os.path.join(self._tmp, name))
            os.rmdir(self._tmp)


def start_ranks(fn: Callable, nprocs: int, args: Sequence = (),
                init_method: Optional[str] = None, backend: str = "gloo",
                group_timeout_s: float = 60.0, deadline_s: float = 600.0,
                threads: Optional[int] = None) -> RankGroup:
    """Start ``fn(rank, nprocs, *args)`` on ``nprocs`` spawned ranks of one
    process group (``backend``; rendezvous at ``init_method``, default a
    ``file://`` store in a fresh temporary directory) and return at once;
    ``RankGroup.results()`` collects.  ``threads``: each rank's
    ``torch.set_num_threads``."""
    return RankGroup(fn, nprocs, args, init_method, backend,
                     group_timeout_s, deadline_s, threads)


def run_ranks(fn: Callable, nprocs: int, args: Sequence = (),
              init_method: Optional[str] = None, backend: str = "gloo",
              group_timeout_s: float = 60.0, deadline_s: float = 600.0,
              threads: Optional[int] = None) -> List:
    """:func:`start_ranks`, then their results by rank."""
    return start_ranks(fn, nprocs, args, init_method, backend,
                       group_timeout_s, deadline_s, threads).results()
