"""Multi-process coordination.

The port of the JAX package's ``parallel/distributed.py``: the process
group of a multi-process (multi-card, multi-host) run, each process
loading only its slice of the global batch.

Failure semantics, the JAX module's: fail fast, then resume from a
checkpoint.  A process group is not elastic: its members are fixed at
:func:`initialize` and a member cannot be replaced mid-run.  When one
process dies, a survivor blocked in a collective gets an error from the
backend (gloo: the peer's connection closes; NCCL: the watchdog aborts it)
or, if the peer hangs instead, the group's timeout, ``RAFT_TPU_HEARTBEAT_
TIMEOUT`` seconds (default 100, the JAX package's heartbeat), expires:
either way the survivor exits non-zero instead of hanging, since it could
make no progress (every train step averages gradients over all ranks).
Recovery is operational: relaunch every process with the same ``--out``;
the trainer resumes from the newest complete checkpoint (written by rank 0
alone) after the consistent-resume guard of ``training/loop.py`` has
checked that every rank restored the same step.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

HEARTBEAT_DEFAULT_S = 100


def default_backend(device) -> str:
    """PyTorch's rule by device: gloo for CPU tensors, and NCCL for CUDA
    ones beside gloo for the host's (``"cpu:gloo,cuda:nccl"``)."""
    dev = torch.device(device)
    return "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"


def init_method_of(address: str) -> str:
    """A rendezvous URL: ``HOST:PORT`` becomes ``tcp://HOST:PORT``; a URL
    (``tcp://``, ``file://`` for processes sharing a file system) is kept."""
    return address if "://" in address else f"tcp://{address}"


def heartbeat_timeout() -> datetime.timedelta:
    """The process group's timeout: ``RAFT_TPU_HEARTBEAT_TIMEOUT`` seconds,
    default :data:`HEARTBEAT_DEFAULT_S` (the module docstring)."""
    return datetime.timedelta(seconds=float(os.environ.get(
        "RAFT_TPU_HEARTBEAT_TIMEOUT", HEARTBEAT_DEFAULT_S)))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> bool:
    """Join the process group of a multi-process run; a no-op (False) for
    one process.  Every argument left None falls back to its environment
    variable (``RAFT_TPU_COORDINATOR``, ``RAFT_TPU_NUM_PROCESSES``,
    ``RAFT_TPU_PROCESS_ID``), as in the JAX package.  ``backend``:
    explicit, or :func:`default_backend` of ``device`` (default: CUDA when
    there is a card).  The group times out after :func:`heartbeat_timeout`.
    Returns True once joined."""
    if num_processes is None:
        num_processes = int(os.environ.get("RAFT_TPU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("RAFT_TPU_COORDINATOR")
    if process_id is None and "RAFT_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["RAFT_TPU_PROCESS_ID"])
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"address and a process id (--coordinator and "
                         f"--process-id, or RAFT_TPU_COORDINATOR and "
                         f"RAFT_TPU_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dist.init_process_group(backend=backend or default_backend(device),
                            init_method=init_method_of(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=heartbeat_timeout())
    return True


def process_info() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of the global batch; raises ValueError when
    the batch does not divide over the processes."""
    pid, pcount = process_info()
    if global_batch % pcount:
        raise ValueError(f"global batch {global_batch} must divide evenly "
                         f"across {pcount} processes")
    per = global_batch // pcount
    return slice(pid * per, (pid + 1) * per)


def global_mesh(axes=("data",), shape=None, device=None):
    """The mesh over every process (``parallel/mesh.py::make_mesh``)."""
    from .mesh import make_mesh
    return make_mesh(axes=axes, shape=shape, device=device)


def assemble_global_array(local_np, mesh) -> torch.Tensor:
    """This process's local rows of a globally sharded batch, on its
    device: the counterpart of ``jax.make_array_from_process_local_data``,
    where the global array is the ranks' rows taken together."""
    return torch.as_tensor(np.asarray(local_np)).to(mesh.device)


def allgather_int(value: int, device=None) -> list:
    """``value`` from every process, in rank order (the JAX loop's
    ``process_allgather`` of the restored step); ``[value]`` alone."""
    if not (dist.is_available() and dist.is_initialized()):
        return [int(value)]
    t = torch.tensor([int(value)], dtype=torch.int64)
    if "gloo" not in str(dist.get_backend()):
        t = t.to(device)
    parts = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [int(p.item()) for p in parts]
