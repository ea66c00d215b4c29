"""Where the port's inference time goes:
``python -m raft_tpu_torch.tools.profile_breakdown``.

The port of the JAX package's ``tools/profile_breakdown.py``.  It times
the captured model (``make_inference_fn``, one CUDA graph a shape) at
several GRU-iteration counts and fits ms = intercept + slope x iterations
(the slope is one iteration's cost; the intercept the encoders, the loop
set-up and the upsample), then the parts alone on the same shapes: the
feature encoder over both frames, the context encoder, the loop set-up
(the fmap2 pyramid, the hoisted context terms, the GRU kernel's weights),
one correlation lookup, the update block (motion encoder, GRU, heads) with
the GRU kernel and with its plain version, and the convex upsample.  Each
part but the loop set-up (timed eagerly) is captured as a CUDA graph and
replayed; a time is the median of CUDA-event times after warm-up.  ``--impl`` picks the lookup
configuration; one JSON line (with the card's name and power limit) goes
to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ._common import card, default_out, emit, resolve_device, time_ms

#: --impl: the correlation configuration (the GRU is --gru-impl's).
IMPLS = {
    "pallas": {},
    "pallas-win": {"pallas_p_select": "window"},
    "pallas-pack": {"pallas_pack": True},
    "pallas-bf16": {"compute_dtype": "bfloat16",
                    "corr_precision": "default"},
    "pallas-bf16-winpack": {"compute_dtype": "bfloat16",
                            "corr_precision": "default", "pallas_pack": True,
                            "pallas_p_select": "window",
                            "pallas_p_blk": 1024},
    "blockwise": {"corr_impl": "blockwise"},
    "dense": {"corr_impl": "dense"},
}


def config_for(impl: str, gru_impl: str, iters: int = 12):
    from ..config import RAFTConfig
    if impl not in IMPLS:
        raise ValueError(f"unknown --impl {impl!r}; options: {sorted(IMPLS)}")
    cfg = RAFTConfig.full(iters=iters, corr_impl="pallas", gru_impl=gru_impl)
    return dataclasses.replace(cfg, **IMPLS[impl])


def fit_line(xs, ys):
    """Least-squares (slope, intercept) of ys over xs."""
    slope, intercept = np.polyfit(np.asarray(xs, float),
                                  np.asarray(ys, float), 1)
    return float(slope), float(intercept)


def _graphed(fn, device):
    """``fn`` captured as a CUDA graph (after a warm-up on a side stream),
    returned as its replay; on the CPU ``fn`` itself."""
    if device.type != "cuda":
        return fn
    s = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.profile_breakdown",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(432, 1024))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, nargs="+", default=[4, 8, 12],
                   help="the iteration counts of the slope fit")
    p.add_argument("--impl", default="pallas", choices=sorted(IMPLS))
    p.add_argument("--gru-impl", default="pallas", choices=["xla", "pallas"])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=default_out("profile_breakdown.jsonl"))
    args = p.parse_args(argv)
    dev = resolve_device(args.cpu)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    from ..models import raft as rm
    from ._common import seeded_model

    H, W = args.size
    B = args.batch
    cfg = config_for(args.impl, args.gru_impl, max(args.iters))
    model = seeded_model(cfg, dev)
    g = torch.Generator().manual_seed(1)
    im1 = torch.rand(B, H, W, 3, generator=g).to(dev)
    im2 = torch.rand(B, H, W, 3, generator=g).to(dev)
    reps, warm = args.reps, 3
    rec = {"device": str(dev), "card": card(dev), "impl": args.impl,
           "gru_impl": args.gru_impl, "shape": [B, H, W],
           "compute_dtype": cfg.compute_dtype, "reps": reps}

    times = {}
    for n in args.iters:
        fn = rm.make_inference_fn(cfg, iters=n, device=dev)
        times[n] = time_ms(lambda: fn(model, im1, im2), dev, warm, reps)
        print(f"  iters={n:2d}: {times[n]:8.3f} ms", flush=True)
    slope, intercept = fit_line(list(times), list(times.values()))
    rec.update(model_ms=times, slope_ms_per_iter=slope,
               intercept_ms=intercept)
    print(f"per-GRU-iteration cost : {slope:8.3f} ms")
    print(f"fixed cost (intercept) : {intercept:8.3f} ms")

    parts = {}
    cdt = rm.compute_dtype(cfg)
    with torch.no_grad(), rm._forward_mode(cfg):
        x1 = rm._preprocess(im1, cdt)
        x2 = rm._preprocess(im2, cdt)
        both = torch.cat([x1, x2], 0)

        def part(name, fn, graph=True):
            run = _graphed(fn, dev) if graph else fn
            parts[name] = time_ms(run, dev, warm, reps)
            print(f"{name:<22} : {parts[name]:8.3f} ms"
                  + ("" if graph else " (eager)"), flush=True)

        part("fnet_x2_frames", lambda: rm._encode(model.fnet, both, cfg))
        part("cnet", lambda: rm._encode(model.cnet, x1, cfg))
        fmap1, fmap2, net, inp = rm.encode_pair(model, im1, im2, cfg)
        # eager: the set-up lays out the GRU kernel's weights on the host
        part("loop_setup", lambda: rm.prepare_loop(model, fmap1, fmap2, inp,
                                                   cfg), graph=False)
        loop = rm.prepare_loop(model, fmap1, fmap2, inp, cfg)
        h, w = H // 8, W // 8
        coords = (loop.coords0 + torch.randn(B, h, w, 2, generator=g)
                  .to(dev) * 2.0).contiguous()
        part("lookup", lambda: loop.lookup(coords))
        corr = loop.lookup(coords).to(cdt)
        flow = (coords - loop.coords0).to(cdt)
        for gimpl in ("pallas", "xla"):
            kw = loop.gru_kernel_weights if gimpl == "pallas" else None
            if gimpl == "pallas" and (dev.type != "cuda" or kw is None):
                continue
            part(f"update_block_{gimpl}", lambda kw=kw, gimpl=gimpl:
                 model.update_block(net, rm.to_nchw(corr), rm.to_nchw(flow),
                                    loop.gru_ctx, loop.gru_weights,
                                    gru_impl=gimpl, gru_kernel_weights=kw,
                                    inp=loop.inp))
        _, _, mask = rm.gru_step(model, cfg, loop, net, coords)
        flow_lr = coords - loop.coords0
        part("convex_upsample", lambda: rm.upsample_flow(cfg, flow_lr, mask))
    rec["parts_ms"] = parts
    if "update_block_pallas" in parts or "update_block_xla" in parts:
        ub = parts.get("update_block_pallas", parts.get("update_block_xla"))
        rec["iteration_remainder_ms"] = slope - parts["lookup"] - ub
    emit(rec, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
