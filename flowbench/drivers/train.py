"""The captured train step (``training/capture.py::GraphedTrainStep``)
driven back to back on batches made on the device.

The traffic file gives the curriculum stage (``TrainConfig.for_stage``:
batch and crop), the pool of seeded batches and their motion.  Set-up
builds one model, one optimizer state and one step object, and drives
it through its first ``warm_steps`` steps (the first call captures the
graph), each on a batch of its own from the pool: the first three are
what the check follows.  The same object then runs the window: whole
steps, each synchronised, until ``--seconds`` have passed;
``train_samples_per_s`` is the samples of the steps completed over the
time they took.  A step whose loss is not finite is a failure.

The check (after the window, the step and its state freed): the plain
reference (``reference/train.py``) runs the first three steps from the
benchmark's weights on the same batches.  Compared, each by its gap as a
share of the reference's value:

* ``loss_gap``: the first step's loss (the later steps' losses move with
  the sign that Adam gives near-zero gradients, in float32 as much as in
  the program: PERF.md section 2; ``step_loss_gaps`` keeps all three for
  the calibration);
* ``grad_gap``: the first step's gradient as the optimizer takes it,
  read from the program's Adam state after one step (``mu / (1 - b1)``),
  by the worst leaf: the gap between the two norms of a leaf over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change_gap``: each parameter's change over the three steps, by the
  worst leaf as above, read before the fourth step; leaves whose
  reference gradient is under a thousandth of the median leaf's (nought
  to rounding, such as a bias that a norm removes) are left out.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from .. import counts, device as devmod, frames
from ..harness import Check, Outcome, Run
from ..reference import raft as ref
from ..reference import train as ref_train
from ..trace import DeviceTrace
from ..weights import make_weights
from .serve import merged

B1 = ref_train.B1
CHECKED_STEPS = 3
MOTION_DIM = 128        # B2's motion input: the motion encoder's 126 + flow


def _leaf_gap(prog: dict, want: dict, names) -> float:
    """The worst leaf's |norm_prog - norm_ref| over max(norm_ref, median)."""
    ref_norms = {n: float(want[n].norm()) for n in names}
    median = float(np.median(list(ref_norms.values())))
    return max(abs(prog[n] - ref_norms[n]) / max(ref_norms[n], median, 1e-30)
               for n in names)


def _gaps(losses, grad_norms, change_norms, ref_losses, ref_grad, ref_change,
          names, moved) -> dict:
    """The compared numbers (the module docstring), and each step's loss
    gap apart (``step_loss_gaps``)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {"loss_gap": steps[0],
            "grad_gap": _leaf_gap(grad_norms, ref_grad, names),
            "change_gap": _leaf_gap(change_norms, ref_change, moved),
            "step_loss_gaps": steps}


def _batches(tr: dict, tc, seed: int, dev):
    B = tc.batch_size
    H, W = tc.image_size
    n = tr["pool_batches"]
    im1, im2, flow, valid = frames.make_pairs(n * B, H, W, seed, dev,
                                              tr["motion"])
    return [tuple(x[k * B:(k + 1) * B] for x in (im1, im2, flow, valid))
            for k in range(n)]


def reference_readings(sd, mc, tc, batches, tf32: bool, coords=None):
    with devmod.precision(tf32=tf32):
        return ref_train.train_steps(sd, mc, tc, batches, coords_out=coords)


def run(r: Run) -> Outcome:
    cfg = merged(r.cell.config, r.overrides.get("config", {}))
    tr = merged(r.cell.traffic, r.overrides.get("traffic", {}))
    dev = torch.device(r.device)
    from raft_tpu_torch import RAFT, RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.training.optim import make_optimizer
    from raft_tpu_torch.training.state import TrainState

    if r.device == "cuda":
        torch.cuda.init()
    # the traffic file's mode, 'benchmark' as tools/bench_train.py sets it;
    # `python -m raft_tpu_torch.training` leaves cuDNN on its heuristic,
    # about 1.45x slower a chairs step (PERF.md section 7)
    devmod.cudnn_mode(r.device, tr["cudnn"])
    devmod.print_peaks(r.device)
    mc = cfg["model"]
    rc = RAFTConfig(**mc)
    tc = TrainConfig.for_stage(tr["stage"], **tr.get("recipe", {}))
    sd = make_weights(cfg, r.seed, dev)
    model = RAFT(rc).to(dev)
    model.load_state_dict(sd)
    tx = make_optimizer(tc)
    state = TrainState.create(model, tx)
    if r.device == "cuda":
        from raft_tpu_torch.training.capture import GraphedTrainStep
        step = GraphedTrainStep(rc, tc, tx)
    else:                       # the tests' rehearsal: the CPU's eager step
        from raft_tpu_torch.training.step import make_train_step
        step = make_train_step(rc, tc, tx)
    if r.fault in ("unchanged", "half_batch"):
        step = _plant(step, r.fault)
    batches = _batches(tr, tc, r.seed, dev)
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())

    # set-up: the first steps, each on its own batch; the check reads them
    losses, grad_norms, change_norms = [], None, None
    for k in range(max(tr["warm_steps"], CHECKED_STEPS)):
        state, m = step(state, batches[k % len(batches)])
        if k < CHECKED_STEPS:
            losses.append(float(m["loss"]))
        if k == 0:
            grad_norms = {n: float(mu.norm()) / (1 - B1)
                          for n, mu in zip(names, state.opt_state.mu)}
        if k == CHECKED_STEPS - 1:
            change_norms = {n: float((params[n].detach() - sd[n]).norm())
                            for n in names}
    devmod.sync(r.device)
    devmod.reset_peak(r.device)

    # traced: the profiler's session spans ``trace_steps`` whole steps in
    # the middle of the window (no replay in flight when it opens or
    # closes); the seconds it takes to open and to close and reduce are
    # not the window's
    tracer = DeviceTrace() if r.trace and r.device == "cuda" else None
    trace, paused = None, 0.0
    t_open = time.time()
    step_losses, n = [], 0
    t0 = time.perf_counter()
    while True:                 # whole steps, each synchronised
        if tracer is not None and n == tr["trace_after_steps"]:
            p0 = time.perf_counter()
            tracer.start()
            paused += time.perf_counter() - p0
        state, m = step(state, batches[(tr["warm_steps"] + n) % len(batches)])
        step_losses.append(m["loss"])
        devmod.sync(r.device)
        n += 1
        if tracer is not None and n == tr["trace_after_steps"] + tr["trace_steps"]:
            p0 = time.perf_counter()
            trace = tracer.stop()
            tracer = None
            paused += time.perf_counter() - p0
        t1 = time.perf_counter()
        if t1 - t0 - paused >= r.seconds and tracer is None:
            break
    window_s = t1 - t0 - paused
    info = devmod.describe(r.device, trace)
    failed = int(sum(not bool(torch.isfinite(x)) for x in step_losses))
    del step, state, model, tx, params, m, step_losses
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()

    B = tc.batch_size
    H, W = tc.image_size
    tcd = {k: getattr(tc, k) for k in ("gamma", "max_flow", "clip_norm",
                                       "lr", "num_steps", "pct_start",
                                       "weight_decay", "adamw_eps")}
    coords = []
    ref_losses, ref_grad, ref_change = reference_readings(
        sd, mc, tcd, batches[:CHECKED_STEPS], tf32=False, coords=coords)
    if r.fault == "control":    # the control in the program's place
        losses, gr, ch = reference_readings(sd, mc, tcd,
                                            batches[:CHECKED_STEPS], tf32=True)
        grad_norms = {k: float(v.norm()) for k, v in gr.items()}
        change_norms = {k: float(v.norm()) for k, v in ch.items()}
    grad_ref_norms = {n: float(ref_grad[n].norm()) for n in names}
    g_median = float(np.median(list(grad_ref_norms.values())))
    moved = [n for n in names if grad_ref_norms[n] >= 1e-3 * g_median]
    gaps = _gaps(losses, grad_norms, change_norms, ref_losses, ref_grad,
                 ref_change, names, moved)
    checks = [Check(k, gaps[k], float(r.cell.limits[k]))
              for k in ("loss_gap", "grad_gap", "change_gap")]
    calibration = {}
    if r.calibrate:
        calibration = {"program": gaps,
                       "left_out": sorted(set(names) - set(moved))}
        for name, tf32, part in (("control", True, slice(None)),
                                 ("half_batch", False, slice(0, B // 2))):
            lo, gr, ch = reference_readings(
                sd, mc, tcd, [tuple(x[part] for x in b)
                              for b in batches[:CHECKED_STEPS]], tf32=tf32)
            calibration[name] = _gaps(
                lo, {k: float(v.norm()) for k, v in gr.items()},
                {k: float(v.norm()) for k, v in ch.items()}, ref_losses,
                ref_grad, ref_change, names, moved)

    h8, w8 = H // 8, W // 8
    levels = counts.level_sizes(h8, w8, mc["corr_levels"])
    pos = [counts.corr_positions(c.permute(0, 2, 3, 1), levels,
                                 mc["corr_radius"]) for c in coords]
    fdim = 128 if mc["small"] else 256
    readings = {
        "steps": n, "window_s": window_s, "samples": n * B,
        "flops_per_sample": 3 * counts.model_flops(mc, H, W, mc["iters"]),
        "b1_call_s": counts.lookup_bound_s(B, h8, w8, fdim, mc["corr_levels"],
                                           mc["corr_radius"],
                                           float(np.mean(pos))),
        "b2_call_s": (counts.gru_bound_s(B, h8, w8, mc["hidden_dim"],
                                         MOTION_DIM)
                      if mc.get("gru_impl") == "pallas" else None),
    }
    print(f"flowbench window: {n} steps in {window_s:.3f} s, "
          f"{1e3 * window_s / n:.2f} ms a step", file=sys.stderr)
    e2e = {"setup_s": t_open - (r.t_process or t_open),
           "train_samples_per_s": n * B / window_s}
    return Outcome(attempted=n, failed=failed, end_to_end=e2e, checks=checks,
                   readings=readings, device=info, trace=trace,
                   calibration=calibration)


def _plant(step, fault: str):
    """The tests' faults in the timed path: 'unchanged' (the step returns
    its state as it was), 'half_batch' (the step sees only the first half
    of each batch, its loss the mean over it)."""
    def broken(state, batch, seed: int = 0):
        if fault == "half_batch":
            half = batch[0].shape[0] // 2
            return step(state, tuple(x[:half] for x in batch), seed)
        if fault == "unchanged":
            saved = [t.detach().clone() for t in state.model.parameters()]
            mu = [t.detach().clone() for t in state.opt_state.mu]
            state, m = step(state, batch, seed)
            with torch.no_grad():
                for t, s in zip(list(state.model.parameters())
                                + list(state.opt_state.mu), saved + mu):
                    t.copy_(s)
            return state, m
        raise ValueError(f"unknown fault {fault!r}")
    return broken
