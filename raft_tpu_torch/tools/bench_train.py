"""Training-step throughput of the port:
``python -m raft_tpu_torch.tools.bench_train``.

The port of the JAX package's ``tools/bench_train.py``: the full train
step (forward, sequence loss over every iteration's output, backward with
per-iteration remat, the AdamW update) at the official training shape
(368x496 crop, batch 6, 12 GRU iterations) on raft-things with the CUDA
kernels.  On the card the step is the captured one
(``training/capture.py::GraphedTrainStep``, one CUDA graph replayed a
step), timed against the eager step it captures; ``--dtype bfloat16`` runs
the BF configuration (a bf16 forward on float32 masters, the packed
lookup).  Prints one JSON line (captured and eager ms a step, samples/s,
peak MiB, the card's name and power limit) and appends it to ``--out``.
``--quick`` is a CPU-sized smoke (64x96, batch 2, 3 iterations).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from ._common import card, default_out, emit, resolve_device, sync


def train_config(dtype: str, iters: int, small: bool = False):
    """The model configuration a run trains: raft-things with the lookup
    and GRU kernels (f32 main), or under ``bfloat16`` the BF path
    (``pallas-bf16corr-ctx-gru-winpack``: bf16 compute, bf16 lookup
    operands, the packed window lookup)."""
    from ..config import RAFTConfig
    if small:
        cfg = RAFTConfig.small_model(iters=iters, corr_impl="pallas",
                                     gru_impl="xla")
    else:
        cfg = RAFTConfig.full(iters=iters, corr_impl="pallas",
                              gru_impl="pallas")
    if dtype == "bfloat16":
        cfg = dataclasses.replace(
            cfg, compute_dtype="bfloat16", corr_precision="default",
            pallas_pack=True, pallas_p_select="window", pallas_p_blk=1024)
    return cfg


def random_batch(batch: int, h: int, w: int, device, seed: int = 0):
    rng = np.random.RandomState(seed)
    arrays = (rng.rand(batch, h, w, 3), rng.rand(batch, h, w, 3),
              rng.randn(batch, h, w, 2) * 4, np.ones((batch, h, w)))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def step_ms(step, state, batch, device, reps: int, warmup: int = 2):
    """Median ms a step (host clock to the loss's read: the step's one
    sync), min and max, after ``warmup`` steps."""
    ms = []
    for i in range(warmup + reps):
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, i)
        loss = float(metrics["loss"])
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), min(ms), max(ms), loss


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m raft_tpu_torch.tools."
                                "bench_train", description=__doc__.split(
                                    "\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(368, 496))
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation micro-steps")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--quick", action="store_true",
                   help="raft-small at 64x96, batch 2, 3 iterations")
    p.add_argument("--cpu", action="store_true",
                   help="the eager step on the CPU (default: the card)")
    p.add_argument("--out", default=default_out("bench_train.jsonl"))
    args = p.parse_args(argv)
    dev = resolve_device(args.cpu)
    if args.quick:
        args.size, args.batch, args.iters, args.reps = (64, 96), 2, 3, 2

    from ..config import TrainConfig
    from ..models.raft import init_raft_torch
    from ..training import (GraphedTrainStep, TrainState, make_optimizer,
                            make_train_step)

    H, W = args.size
    cfg = train_config(args.dtype, args.iters, small=args.quick)
    tconfig = TrainConfig(num_steps=1000, batch_size=args.batch,
                          image_size=(H, W), accum_steps=args.accum)
    tx = make_optimizer(tconfig)
    batch = random_batch(args.batch, H, W, dev)
    rec = {"metric": f"{'raft-small' if args.quick else 'raft-things'} "
                     f"train step @ {args.iters} iters, "
                     f"{args.batch}x{H}x{W}, {args.dtype}"
                     + (f", accum {args.accum}" if args.accum > 1 else ""),
           "device": str(dev), "card": card(dev), "dtype": args.dtype,
           "batch": args.batch, "size": [H, W], "iters": args.iters,
           "accum_steps": args.accum, "reps": args.reps}

    def fresh():
        return TrainState.create(init_raft_torch(
            cfg, torch.Generator().manual_seed(0), device=dev,
            dtype=torch.float32), tx)

    eager = make_train_step(cfg, tconfig, tx)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
        torch.cuda.reset_peak_memory_stats(dev)
        graphed = GraphedTrainStep(cfg, tconfig, tx)
        ms, lo, hi, loss = step_ms(graphed, fresh(), batch, dev, args.reps)
        rec.update(captured_ms=ms, captured_ms_min=lo, captured_ms_max=hi,
                   captures=graphed.captures,
                   samples_per_s=args.batch / ms * 1e3,
                   peak_mib_captured=torch.cuda.max_memory_allocated(dev)
                   / 2 ** 20)
        graphed._graphs.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ms_e, lo_e, hi_e, loss_e = step_ms(eager, fresh(), batch, dev,
                                       max(2, args.reps // 2))
    rec.update(eager_ms=ms_e, eager_ms_min=lo_e, eager_ms_max=hi_e,
               loss_last=loss_e)
    if dev.type == "cuda":
        rec["peak_mib_eager"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        rec["loss_last_captured"] = loss
    else:
        rec["samples_per_s"] = args.batch / ms_e * 1e3
    if not np.isfinite(rec["loss_last"]):
        emit(rec, args.out)
        print("bench_train: the loss is not finite", file=sys.stderr)
        return 1
    emit(rec, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
