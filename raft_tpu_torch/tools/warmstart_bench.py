"""Warm-start evaluation cost on the port:
``python -m raft_tpu_torch.tools.warmstart_bench``.

The port of the JAX package's ``tools/warmstart_bench.py``.  The official
Sintel warm-start protocol is sequential: one batch-1 forward and one
host-side ``forward_interpolate`` of its 1/8 flow a frame
(``training/evaluate.py``).  This measures what that costs against a cold
batch-1 evaluation of the SAME frames, on a Sintel tree fabricated at the
release layout and resolution (``data/fabricate.py``; timing needs the
layout and the shapes, not real pixels):

- pairs/s cold and warm-started, after an untimed pass of each (the
  factories' graphs are captured in it);
- the host ``forward_interpolate`` alone at the 1/8 grid;
- with ``--policy``, the same pair under a converge policy, with the mean
  iterations each spent.

One JSON line (with the card's name and power limit) goes to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import numpy as np

from ._common import card, default_out, emit, resolve_device, sync


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.warmstart_bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(436, 1024),
                   help="frame resolution (default: Sintel's)")
    p.add_argument("--frames", type=int, default=12,
                   help="frames per scene (pairs = frames-1)")
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--small", action="store_true")
    p.add_argument("--policy", default="converge:1e-2", metavar="POLICY",
                   help="converge arm's iteration policy ('none' skips it; "
                        "on random weights the canonical eps never fires)")
    p.add_argument("--quick", action="store_true",
                   help="raft-small at 48x64, 1 scene of 3 frames, 2 "
                        "iterations")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=default_out("warmstart_bench.jsonl"))
    args = p.parse_args(argv)
    dev = resolve_device(args.cpu)
    if args.quick:
        args.size, args.frames, args.scenes = (48, 64), 3, 1
        args.small, args.iters = True, args.iters or 2

    from ..config import RAFTConfig
    from ..data.datasets import MpiSintel
    from ..data.fabricate import sintel_tree
    from ..ops.warmstart import forward_interpolate
    from ..training.evaluate import evaluate_dataset
    from ._common import seeded_model

    kw = {} if args.iters is None else {"iters": args.iters}
    if args.small:
        config = RAFTConfig.small_model(corr_impl="pallas", gru_impl="xla",
                                        **kw)
    else:
        config = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", **kw)
    h, w = args.size
    with tempfile.TemporaryDirectory() as root:
        sintel_tree(root, scenes=[f"scene_{i}" for i in range(args.scenes)],
                    n_frames=args.frames, size=(h, w))
        ds = MpiSintel(root, "training", "clean")
        n = len(ds)

        def timed(warm, cfg=None):
            cfg = cfg or config
            if cfg.iters_policy not in models:
                models[cfg.iters_policy] = seeded_model(cfg, dev)
            model = models[cfg.iters_policy]
            sync(dev)
            t0 = time.perf_counter()
            out = evaluate_dataset(model, cfg, ds, batch_size=1,
                                   warm_start=warm, verbose=False)
            sync(dev)
            dt = time.perf_counter() - t0
            if out["samples"] != n:
                raise AssertionError(f"evaluated {out['samples']} of {n}")
            return dt, out

        models = {}
        timed(False)
        timed(True)
        cold_s, _ = timed(False)
        warm_s, _ = timed(True)
        converge = None
        if args.policy and args.policy != "none":
            ccfg = dataclasses.replace(config, iters_policy=args.policy)
            timed(False, ccfg)
            timed(True, ccfg)
            c_cold_s, c_cold = timed(False, ccfg)
            c_warm_s, c_warm = timed(True, ccfg)
            converge = {
                "policy": args.policy,
                "cold_pairs_per_s": n / c_cold_s,
                "warm_pairs_per_s": n / c_warm_s,
                "cold_mean_iters": c_cold.get("mean_iters", config.iters),
                "warm_mean_iters": c_warm.get("mean_iters", config.iters),
            }
    lr = (np.random.RandomState(1).randn(h // 8, w // 8, 2) * 2
          ).astype(np.float32)
    forward_interpolate(lr)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        forward_interpolate(lr)
    fi_ms = (time.perf_counter() - t0) / reps * 1e3
    emit({"metric": "sintel warm-start eval cost (the factories' graphs "
                    "captured in an untimed pass first)",
          "device": str(dev), "card": card(dev),
          "model": "raft-small" if args.small else "raft-things",
          "iters": config.iters, "size": [h, w], "pairs": n,
          "cold_pairs_per_s": n / cold_s, "warm_pairs_per_s": n / warm_s,
          "warm_overhead_pct": (warm_s - cold_s) / cold_s * 100,
          "forward_interpolate_ms": fi_ms, "converge": converge}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
