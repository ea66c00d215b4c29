"""The training plane's chaos drill on the port:
``python -m raft_tpu_torch.tools.train_chaos``.

The port of the JAX package's ``tools/train_chaos.py``.  Every fault arm
of ``training/faults.py`` fires on short synthetic runs of the port's
``training/loop.py::train`` (raft-small at 32x48, 2 iterations, batch 2;
on the card unless ``--cpu``), and the resilience layer must recover:

1. **clean** — the uninterrupted baseline, the async checkpoint writer on:
   final weights and the steps' wall times (checkpoint steps vs plain).
2. **sync control** — the same run with synchronous checkpoints: the same
   weights bit for bit, and the checkpoint steps' p95 with the writes on
   the step path.
3. **nan_loss** — one step's loss poisoned: exactly one rollback, and the
   final weights those of a clean run on the same repeated batch.
4. **preempt** — SIGTERM at a chosen step: ``TrainingPreempted`` with a
   readable emergency checkpoint; the resumed run ends at the
   uninterrupted run's weights.
5. **torn_ckpt** — the first checkpoint write torn after its rename: the
   writer's verify pass removes it, ``latest_checkpoint`` stays readable.
6. **worker_kill / worker_stall** — a data worker SIGKILLed, the pool
   stalled: the multi-process loader respawns and the stream goes on.

On the card the drill runs cuDNN's and cuBLAS's deterministic algorithms
(its equalities need a step that repeats itself bit for bit).  Each phase
has a deadline (``--phase-deadline-s``): a phase still running
at it fails the drill, which writes its verdict and exits 1 instead of
hanging.  The verdict JSON (``<out>/TRAIN_CHAOS.json``, with the card's
name and power limit) and the exit code are the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ._common import card, default_out, resolve_device

def _fixed_batch(batch, size, seed=0):
    rng = np.random.RandomState(seed)
    h, w = size
    return (rng.rand(batch, h, w, 3).astype(np.float32),
            rng.rand(batch, h, w, 3).astype(np.float32),
            (rng.rand(batch, h, w, 2).astype(np.float32) - 0.5) * 4.0,
            np.ones((batch, h, w), np.float32))


def repeated_stream(batch, size, seed=0):
    """The SAME batch forever: a rollback's replayed updates are exact."""
    b = _fixed_batch(batch, size, seed)
    while True:
        yield b


def indexed_stream(batch, size, start=0, seed=0):
    """Step-indexed batches: a resumed run passes ``start`` so the data and
    the steps pair up as in the uninterrupted run."""
    i = start
    while True:
        yield _fixed_batch(batch, size, seed * 7919 + i)
        i += 1


class TimedIter:
    """A batch stream whose pull-to-pull deltas approximate each step's
    wall time (pull N+1 follows step N's host work, a checkpoint
    submission included)."""

    def __init__(self, it):
        self.it = it
        self.t = []

    def __iter__(self):
        return self

    def __next__(self):
        self.t.append(time.monotonic())
        return next(self.it)

    def deltas(self):
        return [b - a for a, b in zip(self.t, self.t[1:])]


def _pctl(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else 0.0


def _records(ckpt_dir: Path) -> list:
    recs = []
    for ln in (ckpt_dir / "metrics.jsonl").read_text().splitlines():
        try:
            recs.append(json.loads(ln))
        except json.JSONDecodeError:
            continue
    return recs


def _run_end(ckpt_dir: Path) -> dict:
    ends = [r for r in _records(ckpt_dir) if r.get("event") == "run_end"]
    return ends[-1]["metrics"] if ends else {}


def _metric_steps(ckpt_dir: Path):
    return [r["step"] for r in _records(ckpt_dir)
            if "step" in r and "event" not in r]


def _max_diff(a, b) -> float:
    return max(float((x.detach().float().cpu() - y.detach().float().cpu())
                     .abs().max()) for x, y in zip(a.params, b.params))


class Deadline:
    """Fails the drill when a phase outlives ``seconds``: writes the verdict
    with the stuck phase named and exits the process with code 1."""

    def __init__(self, report: dict, verdict: Path, seconds: float):
        self.report, self.verdict, self.seconds = report, verdict, seconds
        self._timer = None

    def start(self, phase: str) -> None:
        self.cancel()
        self._timer = threading.Timer(self.seconds, self._expire, (phase,))
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()

    def _expire(self, phase: str) -> None:
        self.report.setdefault("problems", []).append(
            f"{phase}: still running after its {self.seconds:.0f} s "
            f"deadline")
        self.report["ok"] = False
        self.verdict.write_text(json.dumps(self.report, indent=2,
                                           default=str) + "\n")
        print(f"[chaos] TRAIN CHAOS FAIL: phase {phase} passed its "
              f"{self.seconds:.0f} s deadline", flush=True)
        os._exit(1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.train_chaos",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=default_out("train_chaos"),
                   help="output root (per-phase checkpoint dirs + verdict)")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--steps", type=int, default=None,
                   help="steps per phase run (default 9, or 7 with --smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="fewer steps, the same assertions")
    p.add_argument("--phase-deadline-s", type=float, default=300.0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(args.cpu)
    if dev.type == "cuda":
        # the drill's equalities (async == sync bitwise, a rollback and a
        # resume at the clean run's weights) need a step that repeats
        # itself: cuDNN's and cuBLAS's deterministic algorithms
        import torch
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    from ..config import RAFTConfig, TrainConfig
    from ..data.mp_loader import MPSampleLoader
    from ..data.synthetic import SyntheticFlowDataset
    from ..telemetry import run_manifest
    from ..telemetry.registry import default_registry
    from ..training.checkpoint import (checkpoint_readable,
                                       latest_checkpoint, list_checkpoints)
    from ..training.faults import TrainFaultInjector, parse_train_chaos_spec
    from ..training.loop import train
    from ..training.resilience import TrainingPreempted

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("clean", "sync", "clean_rep", "nan", "preempt", "torn"):
        # a phase's run resumes from checkpoints it finds: start empty
        shutil.rmtree(out / name, ignore_errors=True)
    steps = args.steps or (7 if args.smoke else 9)
    batch, size = 2, (32, 48)
    config = RAFTConfig.small_model(iters=2, corr_impl="pallas",
                                    gru_impl="xla")
    quiet = lambda m: None  # noqa: E731

    def tconf(**over):
        base = dict(num_steps=steps, batch_size=batch, lr=1e-4,
                    schedule="constant", ckpt_every=3, log_every=1,
                    image_size=size, seed=args.seed)
        return TrainConfig(**{**base, **over})

    def run(it, ckpt_dir, **kw):
        return train(config, kw.pop("tc", tconf()), it,
                     ckpt_dir=str(ckpt_dir), log_fn=quiet, device=dev, **kw)

    problems = []
    report = {"manifest": run_manifest(config=config, mode="train_chaos"),
              "device": str(dev), "card": card(dev), "seed": args.seed,
              "steps": steps, "phases": {}, "problems": problems}
    verdict = out / "TRAIN_CHAOS.json"
    deadline = Deadline(report, verdict, args.phase_deadline_s)

    # ---- 1. clean baseline (async checkpoints) ---------------------------
    deadline.start("clean")
    it = TimedIter(indexed_stream(batch, size, seed=args.seed))
    t0 = time.time()
    clean = run(it, out / "clean")
    deltas = it.deltas()[1:]                 # drop the first (warm-up) step
    ck = [d for i, d in enumerate(deltas, start=1) if (i + 1) % 3 == 0]
    plain = [d for i, d in enumerate(deltas, start=1) if (i + 1) % 3 != 0]
    cl = report["phases"]["clean"] = {
        "wall_s": time.time() - t0,
        "ckpt_step_p95_ms": _pctl(ck, 0.95) * 1e3,
        "plain_step_p95_ms": _pctl(plain, 0.95) * 1e3}
    print(f"[chaos] clean: ckpt-step p95 {cl['ckpt_step_p95_ms']:.1f}ms vs "
          f"plain {cl['plain_step_p95_ms']:.1f}ms (async)")

    # ---- 2. sync control -------------------------------------------------
    deadline.start("sync")
    it = TimedIter(indexed_stream(batch, size, seed=args.seed))
    sync_state = run(it, out / "sync", tc=tconf(async_checkpointing=False))
    same = all(bool((a == b).all()) for a, b in zip(clean.params,
                                                   sync_state.params))
    if not same:
        problems.append("sync-checkpoint run is not bit-identical to async")
    ck_s = [d for i, d in enumerate(it.deltas()[1:], start=1)
            if (i + 1) % 3 == 0]
    report["phases"]["sync"] = {"ckpt_step_p95_ms": _pctl(ck_s, 0.95) * 1e3,
                                "bitwise_equal_to_async": same}
    if ck and plain and cl["ckpt_step_p95_ms"] > \
            max(2.5 * cl["plain_step_p95_ms"], cl["plain_step_p95_ms"] + 50):
        problems.append(f"async ckpt-step p95 {cl['ckpt_step_p95_ms']:.1f}ms "
                        f"is an outlier vs plain "
                        f"{cl['plain_step_p95_ms']:.1f}ms — checkpoint I/O "
                        f"leaked back into the step path")
    print(f"[chaos] sync control: ckpt-step p95 "
          f"{report['phases']['sync']['ckpt_step_p95_ms']:.1f}ms "
          f"(blocking); async == sync weights: {same}")

    # ---- 3. nan_loss -> exactly one rollback -----------------------------
    deadline.start("nan_loss")
    nan_at = steps - 3
    inj = TrainFaultInjector(parse_train_chaos_spec(f"seed={args.seed}"))
    inj.force("nan_loss", [0] * nan_at + [1])
    clean_rep = run(repeated_stream(batch, size, seed=args.seed),
                    out / "clean_rep")
    nan_state = run(repeated_stream(batch, size, seed=args.seed),
                    out / "nan", faults=inj)
    rollbacks = _run_end(out / "nan").get("raft_train_rollbacks_total", 0)
    if rollbacks != 1:
        problems.append(f"nan_loss: expected exactly 1 rollback, got "
                        f"{rollbacks}")
    worst = _max_diff(clean_rep, nan_state)
    if worst > 1e-4:
        problems.append(f"nan_loss rollback: weights diverge (max |diff| "
                        f"{worst:.3g} > 1e-4)")
    logged = _metric_steps(out / "nan")
    if logged != sorted(set(logged)):
        problems.append(f"nan_loss: duplicate step records after rollback: "
                        f"{logged}")
    report["phases"]["nan_loss"] = {"rollbacks": rollbacks,
                                    "max_param_diff": worst}
    print(f"[chaos] nan_loss: {int(rollbacks)} rollback, max |param diff| "
          f"vs clean {worst:.2e}")

    # ---- 4. preempt -> emergency checkpoint + equivalent resume ----------
    deadline.start("preempt")
    d_pre = out / "preempt"
    pre_at = steps - 3
    inj = TrainFaultInjector(
        parse_train_chaos_spec(f"seed={args.seed},preempt={pre_at}"))
    resume_from = 0
    try:
        run(indexed_stream(batch, size, seed=args.seed), d_pre, faults=inj)
        problems.append("preempt: SIGTERM did not surface as "
                        "TrainingPreempted")
    except TrainingPreempted as e:
        if e.ckpt_path is None or not checkpoint_readable(e.ckpt_path):
            problems.append(f"preempt: emergency checkpoint missing or "
                            f"unreadable ({e.ckpt_path})")
        resume_from = e.step
    resumed = run(indexed_stream(batch, size, start=resume_from,
                                 seed=args.seed), d_pre)
    worst = _max_diff(clean, resumed)
    if worst > 1e-4:
        problems.append(f"preempt resume: weights diverge (max |diff| "
                        f"{worst:.3g} > 1e-4)")
    logged = _metric_steps(d_pre)
    if logged != sorted(set(logged)) or (logged and logged[-1] != steps - 1):
        problems.append(f"preempt: duplicate or orphaned step records after "
                        f"resume: {logged}")
    report["phases"]["preempt"] = {"preempt_step": pre_at,
                                   "resumed_from": resume_from,
                                   "max_param_diff": worst}
    print(f"[chaos] preempt@{pre_at}: resumed from {resume_from}, max "
          f"|param diff| vs uninterrupted {worst:.2e}")

    # ---- 5. torn_ckpt -> the verify pass removes it ----------------------
    deadline.start("torn_ckpt")
    d_torn = out / "torn"
    inj = TrainFaultInjector(parse_train_chaos_spec(f"seed={args.seed}"))
    inj.force("torn_ckpt", [1])
    run(indexed_stream(batch, size, seed=args.seed), d_torn, faults=inj)
    tears = inj.injected["torn_ckpt"]
    unreadable = [str(q) for _, q in list_checkpoints(d_torn)
                  if not checkpoint_readable(q)]
    latest = latest_checkpoint(d_torn)
    if tears != 1:
        problems.append(f"torn_ckpt: expected 1 tear, got {tears}")
    if unreadable:
        problems.append(f"torn_ckpt: unreadable checkpoint(s) left: "
                        f"{unreadable}")
    if latest is None or not checkpoint_readable(latest):
        problems.append(f"torn_ckpt: latest_checkpoint {latest} unreadable")
    report["phases"]["torn_ckpt"] = {"tears": tears, "latest": str(latest)}
    print(f"[chaos] torn_ckpt: {tears} tear, latest "
          f"{latest.name if latest else None} readable")

    # ---- 6. worker kill + stall -> respawn heals -------------------------
    def respawns():
        return default_registry().snapshot().get(
            "raft_data_worker_respawns_total", 0)

    ds = SyntheticFlowDataset(size=(24, 32), length=64, seed=args.seed)
    for phase, arm, pulls, kw in (
            ("worker_kill", "worker_kill", 24,
             dict(transport="shm", shm_slots=4, stall_timeout=8.0)),
            ("worker_stall", "worker_stall", 16,
             dict(transport="pickle", stall_timeout=1.5))):
        deadline.start(phase)
        before = respawns()
        inj = TrainFaultInjector(parse_train_chaos_spec(f"seed={args.seed}"))
        inj.force(arm, [0] * (4 if arm == "worker_kill" else 3) + [1])
        loader = MPSampleLoader(ds, num_workers=2, seed=args.seed,
                                faults=inj, max_respawns=3, **kw)
        aborted = None
        try:
            it = iter(loader)
            for _ in range(pulls):
                next(it)
        except RuntimeError as e:
            aborted = str(e)
            problems.append(f"{phase}: loader aborted instead of healing: "
                            f"{e}")
        finally:
            loader.close()
        healed = respawns() - before
        if healed < 1:
            problems.append(f"{phase}: no respawn recorded")
        report["phases"][phase] = {"respawns": healed,
                                   "fired": inj.injected[arm],
                                   "aborted": aborted}
        print(f"[chaos] {phase}: {int(healed)} respawn(s), "
              f"{'aborted' if aborted else 'zero aborts'}")
    deadline.cancel()

    report["ok"] = not problems
    verdict.write_text(json.dumps(report, indent=2, default=str) + "\n")
    print(f"[chaos] verdict -> {verdict}")
    if problems:
        print("[chaos] TRAIN CHAOS FAIL: " + "; ".join(problems))
        return 1
    print("[chaos] TRAIN CHAOS PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
