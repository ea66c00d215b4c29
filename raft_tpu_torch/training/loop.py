"""The training loop: the JAX package's ``training/loop.py`` (``train``)
on one device.

Single-process, one device (CUDA unless the caller passes the CPU):
checkpoint save and resume, periodic checkpoints through the async
writer with retention, divergence rollback, the non-finite halt,
preemption (SIGTERM/SIGINT -> emergency checkpoint -> exit 17), a
``torch.profiler`` window (``telemetry/trace.py::TraceWindow``) and the
step records of ``<ckpt_dir>/metrics.jsonl`` (a manifest per session,
records past the resume point dropped).  On CUDA each step is a replay of
the captured step (``training/capture.py``, the JAX loop's jitted step
with the state donated): one capture per batch shape, the state updated
in place, and every restore (resume, rollback) copied in place, so the
graph reads it; on the CPU the step is eager.  The model holds float32
master weights under both compute dtypes.  The JAX loop's recompile
watchdog has no counterpart here (a capture is per key, counted by
``captures``).

Multi-process (``torch.distributed`` initialized with more than one rank,
``parallel/distributed.py::initialize``): every rank runs this loop on its
own device and its share of each global batch (``tconfig.batch_size`` is
the global batch and must divide over the ranks), stepping through
``parallel/data_parallel.py::make_dp_train_step`` (eager: the gradients,
metrics and batch-norm statistics averaged over the ranks), from the same
seeded initial state.  Only rank 0 writes checkpoints and
``metrics.jsonl``; a resume is checked consistent first (every rank must
have restored the same step, or the run raises); the divergence rollback
is single-process only, as in the JAX loop (a per-rank rollback decision
would split the replicated state).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from ..config import RAFTConfig, TrainConfig
from ..models.raft import RAFT, init_raft_torch, resolve_device
from ..telemetry import Registry, config_hash, run_manifest
from ..telemetry import events as tlm_events
from ..telemetry.trace import TraceWindow, stage
from .capture import GraphedTrainStep
from .checkpoint import (DeviceSnapshot, host_state,
                         restore_latest_with_fallback)
from .optim import make_optimizer
from .resilience import (CheckpointWriter, LastGood, PreemptionGuard,
                         TrainingPreempted)
from .state import TrainState
from .step import make_train_step
from ..convert.weights import from_jax_train_state
from ..parallel.distributed import allgather_int, process_info


def step_seed(seed: int, step: int, rollbacks: int = 0) -> int:
    """The seed of one step's dropout generator: a function of the run's
    seed, the step and the rollbacks so far (a rollback re-randomizes what
    follows, as the JAX loop folds the retry count into its key)."""
    return ((seed + 1) * 1_000_003 + step + 104_729 * rollbacks) % (2 ** 63)


def train(config: RAFTConfig, tconfig: TrainConfig, batch_iter: Iterable,
          ckpt_dir: Optional[str] = None, resume: bool = True,
          log_fn=print, trace_dir: Optional[str] = None,
          trace_steps: int = 4, init_state: Optional[Mapping] = None,
          faults=None, device=None) -> TrainState:
    """Run the training loop over ``batch_iter``, which yields (im1, im2,
    flow, valid) batches (tensors on the device, as ``data/pipeline.py::
    PrefetchLoader`` stages them, or numpy arrays); returns the final
    state.

    The model starts from seeded random weights (``tconfig.seed``) or from
    ``init_state``, a model ``state_dict`` (``--load``: the curriculum's
    warm start), with the optimizer fresh at step 0; a readable checkpoint
    in ``ckpt_dir`` takes precedence (continuation beats warm start).
    ``faults``: an armed ``training/faults.py::TrainFaultInjector`` or
    None.  ``device``: CUDA unless ``"cpu"`` is passed."""
    dev = resolve_device(device)
    rank, world = process_info()
    multihost = world > 1
    is_main = rank == 0
    mesh = None
    if multihost:
        if tconfig.batch_size % world:
            raise ValueError(f"multi-host training requires global batch "
                             f"{tconfig.batch_size} divisible by {world} "
                             f"processes")
        from ..parallel.mesh import DATA_AXIS, make_mesh
        # this rank's card (cuda:<rank>), or the device the caller passed
        mesh = make_mesh((DATA_AXIS,),
                         device=None if device is None else dev)
        dev = mesh.device
    local_batch = tconfig.batch_size // world
    tx = make_optimizer(tconfig)
    # float32 masters under both compute dtypes (a bfloat16 forward casts
    # them in each step)
    model = init_raft_torch(config, torch.Generator().manual_seed(tconfig.seed),
                            device=dev, dtype=torch.float32)
    if init_state is not None:
        warm = RAFT(config)
        warm.load_state_dict(init_state, strict=True)
        model = warm.to(dev, torch.float32).eval()
    state = TrainState.create(model, tx)
    if local_batch % tconfig.accum_steps:
        raise ValueError(f"accum_steps {tconfig.accum_steps} must divide "
                         f"the batch {local_batch}" + (
                             f" of each of the {world} processes (global "
                             f"batch {tconfig.batch_size})" if multihost
                             else ""))
    if multihost:
        from ..parallel.data_parallel import make_dp_train_step
        step_fn = make_dp_train_step(config, tconfig, tx, mesh)
        log_fn(f"[train] multi-host: {world} processes x 1 local device "
               f"(global batch {tconfig.batch_size}) on {dev}")
    else:
        step_fn = (GraphedTrainStep(config, tconfig, tx) if dev.type == "cuda"
                   else make_train_step(config, tconfig, tx))

    start_step = 0
    if ckpt_dir and resume:
        restored, latest = restore_latest_with_fallback(ckpt_dir, state,
                                                        log_fn=log_fn)
        if latest is not None:
            state = restored
            start_step = state.step
            log_fn(f"[train] resumed from {latest} at step {start_step}")
    if multihost:
        # only rank 0 writes checkpoints, so a resume is consistent only
        # when every rank restored the same state (a shared file system, or
        # the checkpoints copied to every host); a divergent resume would
        # train inconsistent replicas: fail loudly instead
        steps = allgather_int(start_step, dev)
        if len(set(steps)) != 1:
            raise RuntimeError(
                f"inconsistent multi-host resume: per-process restored steps "
                f"{steps}; point every process at the same checkpoint "
                f"directory (shared filesystem)")

    # profiler window: steps 5..5+trace_steps after the start (steady
    # state); a short run starts it at its first step
    first = start_step + (5 if tconfig.num_steps - start_step
                          >= 5 + trace_steps else 0)
    trace_window = TraceWindow(trace_dir, first=first, steps=trace_steps,
                               log_fn=lambda m: log_fn(f"[train] {m}"))

    registry = Registry()
    m_steps = registry.counter("raft_train_steps_total",
                               "Optimizer steps executed this session")
    m_nonfinite = registry.counter("raft_train_nonfinite_total",
                                   "Logged steps with non-finite loss")
    m_ckpts = registry.counter("raft_train_checkpoints_total",
                               "Checkpoints written this session")
    m_rate = registry.gauge("raft_train_steps_per_sec",
                            "Steady-state training throughput")
    m_rollbacks = registry.counter(
        "raft_train_rollbacks_total",
        "Divergence rollbacks to the last good checkpoint snapshot")
    m_ckpt_write = registry.histogram(
        "raft_ckpt_write_seconds",
        "Checkpoint serialize+fsync(+verify) wall time, writer-side")
    m_ckpt_queue = registry.gauge(
        "raft_ckpt_queue_depth",
        "Checkpoints queued behind the async writer")
    if faults is not None:
        faults.counter = registry.counter(
            "raft_fault_injected_total",
            "Training chaos-harness fires by arm", labelnames=("arm",))

    metrics_path = (Path(ckpt_dir) / "metrics.jsonl"
                    if ckpt_dir and is_main else None)
    if metrics_path:
        metrics_path.parent.mkdir(parents=True, exist_ok=True)
        if metrics_path.exists():
            # records past the restored step (a crash between a logged step
            # and the next checkpoint) are replayed: drop them; a fresh run
            # in a reused directory keeps nothing of the dead one
            def _keep(rec: dict) -> bool:
                if start_step == 0:
                    return False
                if rec.get("event") == "manifest":
                    return rec.get("start_step", 0) < start_step
                if rec.get("event") == "run_end":
                    return rec.get("final_step", 1 << 62) <= start_step
                if "event" in rec:
                    return False
                return rec.get("step", -1) < start_step

            dropped = _rewrite_metrics_jsonl(metrics_path, _keep)
            if dropped:
                log_fn(f"[train] metrics.jsonl: dropped {dropped} "
                       f"record(s) from steps >= {start_step} (replayed)")
        manifest = run_manifest(config=config, mode="train",
                                extra={"tconfig_hash": config_hash(tconfig),
                                       "start_step": start_step})
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"event": "manifest", **manifest},
                               default=str) + "\n")

    run_log = tlm_events.current()
    guard = PreemptionGuard().install()
    last_good = LastGood()
    # the rollback is single-process: under multi-host a per-rank decision
    # would diverge the replicated state
    sentinel_on = (bool(ckpt_dir) and tconfig.max_rollbacks > 0
                   and tconfig.halt_on_nonfinite and not multihost)
    if sentinel_on:
        last_good.update(start_step, host_state(state))
    writer = None
    if ckpt_dir and is_main:
        writer = CheckpointWriter(
            log_fn=log_fn, sync=not tconfig.async_checkpointing,
            keep=tconfig.keep_checkpoints, faults=faults,
            metrics={"saved": m_ckpts, "write_seconds": m_ckpt_write,
                     "queue_depth": m_ckpt_queue},
            run_log=run_log,
            on_good=last_good.update if sentinel_on else None)

    def _drop_metrics_from(from_step: int) -> None:
        if metrics_path and metrics_path.exists():
            _rewrite_metrics_jsonl(
                metrics_path,
                lambda rec: "event" in rec or rec.get("step", -1) < from_step)

    def _write_run_end(final_step: int) -> None:
        if not metrics_path:
            return
        from ..telemetry import default_registry
        data_metrics = {k: v for k, v in default_registry().snapshot().items()
                        if k.startswith("raft_data_")}
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"event": "run_end", "final_step": final_step,
                                "metrics": {**registry.snapshot(),
                                            **data_metrics}},
                               default=str) + "\n")

    def _preempt_exit():
        estep = state.step
        ckpt_path = None
        if writer is not None:
            p = Path(ckpt_dir) / f"ckpt_{estep}.npz"
            if writer.last_submitted != p:
                writer.submit(p, host_state(state), estep, final=True)
            writer.close()
            ckpt_path = p if writer.last_path == p else None
        trace_window.stop()
        if run_log is not None:
            run_log.event("preempted", step=estep, signum=guard.signum,
                          ckpt=str(ckpt_path) if ckpt_path else None)
        log_fn(f"[train] preempted at step {estep} (signal {guard.signum}); "
               f"emergency checkpoint: "
               f"{ckpt_path or 'NOT written (non-finite state or no ckpt dir)'}")
        _write_run_end(estep)
        raise TrainingPreempted(estep, guard.signum, ckpt_path)

    try:
        t0 = time.time()
        seen = 0
        nonfinite_streak = 0
        consec_rollbacks = 0
        total_rollbacks = 0
        pending_check = None   # (step, device metrics): the lag-1 sentinel
        for batch in batch_iter:
            step = state.step
            if step >= tconfig.num_steps:
                break
            if guard.requested:
                _preempt_exit()
            trace_window.on_step(step)
            if faults is not None:
                batch = faults.corrupt_batch(tuple(batch))
                faults.maybe_preempt(step)
            with stage("train/step"):
                state, metrics = step_fn(
                    state, batch, step_seed(tconfig.seed, step,
                                            total_rollbacks))
            seen += 1
            m_steps.inc()
            # the previous step's metrics are ready by now: a small read,
            # not a bubble; on a hit both it and this step are discarded
            if sentinel_on and pending_check is not None:
                pstep, pm = pending_check
                if not (np.isfinite(float(pm["loss"]))
                        and np.isfinite(float(pm["grad_norm"]))):
                    m_nonfinite.inc()
                    consec_rollbacks += 1
                    if writer is not None:
                        writer.drain()
                    gstep, ghost = last_good.get()
                    if consec_rollbacks > tconfig.max_rollbacks:
                        trace_window.stop()
                        raise FloatingPointError(
                            f"non-finite loss/grad at step {pstep} persisted "
                            f"through {tconfig.max_rollbacks} consecutive "
                            f"rollback(s); giving up — last good checkpoint is "
                            f"step {gstep} in {ckpt_dir}")
                    m_rollbacks.inc()
                    total_rollbacks += 1
                    state = from_jax_train_state(ghost, state)
                    _drop_metrics_from(gstep)
                    if run_log is not None:
                        run_log.event("rollback", from_step=pstep,
                                      to_step=gstep,
                                      consecutive=consec_rollbacks)
                    log_fn(f"[train] non-finite loss/grad at step {pstep}: "
                           f"rolled back to step {gstep} "
                           f"({consec_rollbacks}/{tconfig.max_rollbacks} "
                           f"consecutive); continuing past the offending data "
                           f"window")
                    pending_check = None
                    continue
                consec_rollbacks = 0
            if sentinel_on:
                pending_check = (step, metrics)
            if step % tconfig.log_every == 0 or step + 1 >= tconfig.num_steps:
                m = {k: float(v) for k, v in metrics.items()}
                rate = seen / max(time.time() - t0, 1e-9)
                m_rate.set(rate)
                log_fn(f"[train] step {step}  loss {m['loss']:.4f}  "
                       f"epe {m['epe']:.3f}  1px {m['1px']:.3f}  "
                       f"gnorm {m['grad_norm']:.2f}  {rate:.2f} it/s")
                if metrics_path:
                    rec = {"step": step, "it_per_s": round(rate, 4),
                           "wall_s": round(time.time() - t0, 2)}
                    rec.update(m)
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                if not np.isfinite(m["loss"]):
                    nonfinite_streak += 1
                    if not sentinel_on:
                        m_nonfinite.inc()
                else:
                    nonfinite_streak = 0
                if (not sentinel_on and tconfig.halt_on_nonfinite
                        and nonfinite_streak >= 3):
                    trace_window.stop()
                    raise FloatingPointError(
                        f"non-finite loss at {nonfinite_streak} consecutive "
                        f"logged steps (last: step {step}); last good checkpoint "
                        f"is in {ckpt_dir or '<none>'}")
            if writer is not None and (step + 1) % tconfig.ckpt_every == 0:
                writer.submit(Path(ckpt_dir) / f"ckpt_{step + 1}.npz",
                              DeviceSnapshot(state), step + 1)
            if guard.requested:
                _preempt_exit()

        trace_window.stop()
        if writer is not None:
            fp = Path(ckpt_dir) / f"ckpt_{state.step}.npz"
            if writer.last_submitted != fp:
                writer.submit(fp, host_state(state), state.step, final=True)
            writer.close()
        _write_run_end(state.step)
    finally:
        guard.remove()
        trace_window.stop()
        if writer is not None:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — the primary exception wins
                pass
    return state


def _rewrite_metrics_jsonl(path: Path, keep) -> int:
    """Filter a metrics.jsonl in place: keep the records ``keep(rec)``
    accepts, drop undecodable (partial) lines; returns the lines removed."""
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()]
    kept = []
    for ln in lines:
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if keep(rec):
            kept.append(ln)
    if len(kept) != len(lines):
        path.write_text("".join(ln + "\n" for ln in kept))
    return len(lines) - len(kept)
