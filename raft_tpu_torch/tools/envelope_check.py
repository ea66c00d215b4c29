"""The chairs recipe's envelope on the port:
``python -m raft_tpu_torch.tools.envelope_check``.

The port of the JAX package's ``tools/envelope_check.py``, its three
recipe stages.  At the chairs-stage shape (368x496 crop, global batch 10,
12 GRU iterations, freeze_bn off, per-iteration remat) on raft-things with
the CUDA kernels:

1. ``memory`` — the device's peak memory around one EXECUTED train step
   at gradient accumulation 1 and at ``--accum`` (``torch.cuda.
   reset_peak_memory_stats`` before the step, ``max_memory_allocated``
   after it; the JAX tool reads XLA's ``memory_analysis`` of the compiled
   step, which has no counterpart here), and their ratio — the
   accumulation knob's activation-memory saving, measured;
2. ``executed_step`` — that accumulated optimizer step: its wall time, its
   loss, finite or not;
3. ``loader`` — the host input pipeline at the same crop
   (``data/loader_bench.py``: in-process, the multi-process loader per
   worker count, the device augmentor end to end).

The steps are the eager train step (its peak is the step's own; a
captured step's graph pool holds its peak from capture on).  One JSON line
a stage, each with the card's name and power limit, to ``--out``.  The JAX
tool's converge-policy and quantization EPE stages (on a briefly trained
raft-small) are not part of this module.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time

import numpy as np
import torch

from ._common import card, default_out, emit, resolve_device, sync


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.envelope_check",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(368, 496))
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--accum", type=int, default=5)
    p.add_argument("--skip-loader", action="store_true")
    p.add_argument("--quick", action="store_true",
                   help="raft-small at 64x96, batch 4, accumulation 2, 2 "
                        "iterations, a short loader stage")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=default_out("envelope_check.jsonl"))
    args = p.parse_args(argv)
    dev = resolve_device(args.cpu)
    if args.quick:
        args.size, args.batch, args.iters, args.accum = (64, 96), 4, 2, 2

    from ..config import TrainConfig
    from ..models.raft import init_raft_torch
    from ..training import TrainState, make_optimizer, make_train_step
    from .bench_train import random_batch, train_config

    H, W = args.size
    B = args.batch
    cfg = train_config("float32", args.iters, small=args.quick)
    base = TrainConfig.for_stage("chairs", batch_size=B, image_size=(H, W),
                                 num_steps=1000)
    if base.freeze_bn:
        raise AssertionError("the chairs recipe trains batch norm")
    smi = card(dev)
    batch = random_batch(B, H, W, dev)
    import dataclasses
    peaks, executed = {}, None
    for accum in dict.fromkeys((1, args.accum)):
        t = dataclasses.replace(base, accum_steps=accum)
        tx = make_optimizer(t)
        state = TrainState.create(init_raft_torch(
            cfg, torch.Generator().manual_seed(0), device=dev,
            dtype=torch.float32), tx)
        step = make_train_step(cfg, t, tx)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        rec = {"stage": "memory", "accum_steps": accum, "device": str(dev),
               "card": smi, "shape": [B, H, W], "iters": args.iters,
               "step_s": dt, "loss": loss}
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            rec.update(peak_mib=peak / 2 ** 20,
                       resident_before_mib=before / 2 ** 20,
                       step_peak_mib=(peak - before) / 2 ** 20)
            peaks[accum] = peak
        else:
            rec["peak_rss_mib"] = (resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024)
        emit(rec, args.out)
        if accum == args.accum:
            executed = {"stage": "executed_step", "accum_steps": accum,
                        "device": str(dev), "card": smi, "shape": [B, H, W],
                        "iters": args.iters, "first_step_s": dt,
                        "loss": loss, "finite": bool(np.isfinite(loss))}
        del state, step, metrics
    if len(peaks) == 2:
        emit({"stage": "memory_ratio", "card": smi,
              "peak_reduction_accum": peaks[1] / peaks[args.accum],
              "note": f"device peak, accum 1 vs {args.accum}"}, args.out)
    else:
        emit({"stage": "memory_ratio", "skipped": True, "card": smi,
              "note": ("only one accum configuration ran (--accum 1)"
                       if args.accum == 1 else
                       "no device memory statistics on the CPU")}, args.out)
    emit(executed, args.out)

    if not args.skip_loader:
        from ..data.loader_bench import run as loader_run
        if args.quick:
            res = loader_run(samples=4, workers=(2,), crop=(H, W), batch=2,
                             e2e_batches=2, device=str(dev))
        else:
            res = loader_run(samples=24, workers=(2, 4), crop=(H, W),
                             device=str(dev))
        res.update(stage="loader", card=smi)
        emit(res, args.out)
    return 0 if executed["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
