"""EPE evaluation harness (Sintel / KITTI / Chairs / Things): the JAX
package's ``training/evaluate.py`` on the port's eval steps.

Pads each pair to a multiple of ``bucket`` (replicate, ``pad_mode``
'sintel' splits the padding, 'kitti' pads top and right), runs the port's
eval step (``training/step.py::make_eval_step``, or
``make_warm_eval_step`` under the Sintel warm start: ``raft_forward`` in
eval mode, so on CUDA the lookup and GRU kernels launch in every
iteration), and aggregates EPE, the 1/3/5 px rates and KITTI's Fl-all
over the valid pixels of each padded canvas.  ``bucket`` 8 is the official
InputPadder protocol; 64 collapses KITTI's per-image sizes onto one padded
shape, as in the JAX package (which compiles one executable per shape;
the port's eager forward needs no compile, but cuDNN's benchmark mode and
the kernels' launch configurations are also per shape).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import RAFTConfig, adaptive_iters
from ..data.pipeline import pad_to_multiple, unpad
from ..telemetry.log import get_logger
from ..telemetry.trace import TraceWindow, stage
from .loss import epe_metrics
from .step import make_eval_step, make_warm_eval_step

_log = get_logger("val")


def _gt_canvas(flow_gt: np.ndarray, valid: np.ndarray, pads, hw):
    """Unpadded ground truth placed into the padded prediction's canvas
    with valid = 0 in the padding, so the metrics run on the padded shape
    (inside, the padded prediction equals its unpadded slice)."""
    t, _, l, _ = pads
    H, W = hw
    h, w = flow_gt.shape[:2]
    g = np.zeros((H, W, 2), np.float32)
    v = np.zeros((H, W), np.float32)
    g[t:t + h, l:l + w] = flow_gt
    v[t:t + h, l:l + w] = valid
    return g, v


def evaluate_dataset(model, config: RAFTConfig, dataset,
                     iters: Optional[int] = None,
                     max_samples: Optional[int] = None,
                     pad_mode: str = "sintel", bucket: int = 8,
                     weighting: str = "sample", batch_size: int = 1,
                     dump_dir: Optional[str] = None,
                     warm_start: bool = False,
                     trace_dir: Optional[str] = None, trace_steps: int = 4,
                     verbose: bool = True) -> Dict[str, float]:
    """Evaluate ``model`` (on its device) over ``dataset``, which yields
    (im1, im2, flow_gt, valid) numpy samples (no augmentor).

    ``bucket``: pad H, W up to this multiple (a positive multiple of 8).
    ``weighting``: ``'sample'`` averages per-image means (the Sintel
    protocol), ``'pixel'`` pools valid pixels over the dataset (KITTI's).
    ``batch_size``: samples per forward, grouped by padded shape (the
    metrics are per sample either way).  ``dump_dir``: also write each
    unpadded prediction, KITTI's 16-bit PNG under ``pad_mode='kitti'``,
    else ``.flo``, named by the dataset's ``dump_name(idx)`` when it has
    one, else ``frame_<idx:06d>``; a dataset without ground truth
    (``has_gt`` False) then only exports.  ``warm_start``: the official
    Sintel video protocol, each frame's 1/8 flow forward-projected to seed
    the next frame of its scene, reset at ``dataset.is_scene_start``
    (sequential: ``batch_size`` must be 1).  ``trace_dir``: a
    ``torch.profiler`` trace of forwards 1..trace_steps.

    Returns the metrics, ``samples``, ``seconds``, ``shapes`` (distinct
    (batch, H, W, C) forwards) and, under a converge policy,
    ``mean_iters``."""
    if bucket <= 0 or bucket % 8:
        raise ValueError(f"bucket must be a positive multiple of 8, "
                         f"got {bucket}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if weighting not in ("sample", "pixel"):
        raise ValueError(f"weighting must be 'sample' or 'pixel', "
                         f"got {weighting!r}")
    device = next(model.parameters()).device
    adaptive = adaptive_iters(config.iters_policy)
    iters_sum = [0.0, 0]
    eval_fn = make_eval_step(config, iters=iters, with_iters=adaptive)
    has_gt = getattr(dataset, "has_gt", True)
    sums: Dict[str, float] = {}
    count = 0
    shapes_seen = set()
    t0 = time.time()
    n = len(dataset) if max_samples is None else min(max_samples, len(dataset))
    if not has_gt and dump_dir is None:
        raise ValueError(
            "dataset has no ground truth (e.g. the KITTI testing split): "
            "pass dump_dir (--dump-flow) to export predictions instead")
    if dump_dir is not None:
        from ..utils.flow_io import write_flo, write_kitti_flow
        Path(dump_dir).mkdir(parents=True, exist_ok=True)
        stale = sum(1 for p in Path(dump_dir).rglob("*") if p.is_file())
        if stale and verbose:
            _log.warning(f"--dump-flow dir {dump_dir} already holds "
                         f"{stale} file(s); stale predictions from a "
                         f"previous run will remain unless overwritten")

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def account(flows: torch.Tensor, group):
        """Metrics + dump + progress for computed (padded) flows."""
        nonlocal count
        if has_gt:
            hw = group[0][0].shape[1:3]
            for (_, _, pads, gt, valid, _), flow in zip(group, flows):
                g, v = _gt_canvas(gt, valid, pads, hw)
                m = epe_metrics(flow, to_dev(g), to_dev(v), reduce="sum")
                m = {k: float(x) for k, x in m.items()}
                vp = m.pop("valid_px")
                if weighting == "pixel":
                    # pool the TRUE count: a zero-valid sample adds nothing
                    sums["valid_px"] = sums.get("valid_px", 0.0) + vp
                for k, x in m.items():
                    inc = x if weighting == "pixel" else x / max(vp, 1.0)
                    sums[k] = sums.get(k, 0.0) + inc
        if dump_dir is not None:
            host = flows.float().cpu().numpy()
            for (_, _, pads, _, _, idx), flow in zip(group, host):
                fl = unpad(flow[None], pads)[0]
                name = (dataset.dump_name(idx)
                        if hasattr(dataset, "dump_name") else None)
                if pad_mode == "kitti":     # the KITTI server's 16-bit PNG
                    path = Path(dump_dir) / (name or f"frame_{idx:06d}.png")
                else:
                    path = Path(dump_dir) / (
                        name.rsplit(".", 1)[0] + ".flo" if name
                        else f"frame_{idx:06d}.flo")
                path.parent.mkdir(parents=True, exist_ok=True)
                (write_kitti_flow if pad_mode == "kitti" else write_flo)(
                    fl, path)
        prev = count
        count += len(group)
        if verbose and has_gt and count // 50 > prev // 50:
            running = (sums["epe"] / max(sums.get("valid_px", 1.0), 1.0)
                       if weighting == "pixel" else sums["epe"] / count)
            _log.info(f"eval {count}/{n}  epe so far {running:.3f}")

    def account_iters(iters_used: torch.Tensor):
        for v in iters_used.cpu().numpy():
            iters_sum[0] += float(v)
            iters_sum[1] += 1

    trace_window = TraceWindow(trace_dir, first=1, steps=trace_steps,
                               log_fn=_log.info if verbose else None)
    calls = 0

    def flush(group):
        nonlocal calls
        shapes_seen.add((len(group),) + group[0][0].shape[1:])
        trace_window.on_step(calls)
        calls += 1
        with stage("val/forward"):
            out = eval_fn(model, to_dev(np.concatenate([g[0] for g in group])),
                          to_dev(np.concatenate([g[1] for g in group])))
        if adaptive:
            out, iters_used = out
            account_iters(iters_used)
        account(out, group)

    def load(idx):
        im1, im2, flow_gt, valid = dataset[idx]
        im1p, pads = pad_to_multiple(im1[None], bucket, pad_mode)
        im2p, _ = pad_to_multiple(im2[None], bucket, pad_mode)
        return im1p, im2p, pads, flow_gt, valid, idx

    try:
        if warm_start:
            from ..ops.warmstart import warm_start_seed
            if batch_size != 1:
                raise ValueError("warm_start evaluation is sequential "
                                 "(frame t seeds frame t+1): use "
                                 "--eval-batch 1")
            if not hasattr(dataset, "is_scene_start"):
                raise ValueError(
                    "warm_start needs a dataset with scene structure "
                    "(is_scene_start), e.g. MpiSintel")
            warm_fn = make_warm_eval_step(config, iters=iters,
                                          with_iters=adaptive)
            # frame t+1's decode and padding overlap frame t's forward
            from concurrent.futures import ThreadPoolExecutor
            prev_lr = None
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(load, 0) if n else None
                try:
                    for idx in range(n):
                        item = fut.result()
                        if idx + 1 < n:
                            fut = pool.submit(load, idx + 1)
                        im1p, im2p = item[0], item[1]
                        shapes_seen.add((1,) + im1p.shape[1:])
                        trace_window.on_step(idx)
                        h8, w8 = im1p.shape[1] // 8, im1p.shape[2] // 8
                        init = warm_start_seed(
                            prev_lr, (h8, w8),
                            reset=dataset.is_scene_start(idx))
                        with stage("val/forward"):
                            res = warm_fn(model, to_dev(im1p), to_dev(im2p),
                                          to_dev(init))
                        if adaptive:
                            flow, flow_lr, iters_used = res
                            account_iters(iters_used)
                        else:
                            flow, flow_lr = res
                        prev_lr = flow_lr.float().cpu().numpy()
                        account(flow, [item])
                finally:
                    if fut is not None:
                        fut.cancel()
        else:
            groups: Dict[tuple, list] = {}
            for idx in range(n):
                item = load(idx)
                group = groups.setdefault(item[0].shape, [])
                group.append(item)
                if len(group) == batch_size:
                    flush(group)
                    group.clear()
            for group in groups.values():   # shape-group remainders
                if group:
                    flush(group)
    finally:
        trace_window.stop()
    if weighting == "pixel":
        denom = max(sums.pop("valid_px", 0.0), 1.0)
        out = {k: v / denom for k, v in sums.items()}
    else:
        out = {k: v / max(count, 1) for k, v in sums.items()}
    out["samples"] = count
    out["seconds"] = time.time() - t0
    if adaptive and iters_sum[1]:
        out["mean_iters"] = iters_sum[0] / iters_sum[1]
    out["shapes"] = len(shapes_seen)
    return out


def evaluate_cli(args, config: RAFTConfig, load_model) -> int:
    """``-m val``: check the flags, build the dataset, evaluate, print the
    metrics.  ``load_model(args, config)`` returns the model on its
    device.  Returns the exit code (2 for a bad flag or an empty dataset)."""
    from ..data import datasets as D
    if args.bucket is not None and (args.bucket < 8 or args.bucket % 8):
        print(f"ERROR: --bucket must be a positive multiple of 8, "
              f"got {args.bucket}")
        return 2
    if args.eval_batch is not None and args.eval_batch < 1:
        print(f"ERROR: --eval-batch must be >= 1, got {args.eval_batch}")
        return 2
    if args.max_samples is not None and args.max_samples < 1:
        print(f"ERROR: --max-samples must be >= 1, got {args.max_samples}")
        return 2
    if args.warm_start:
        if args.dataset != "sintel":
            print("ERROR: --warm-start is the Sintel video protocol "
                  "(scene-structured frame sequences); only --dataset "
                  "sintel supports it")
            return 2
        if args.eval_batch not in (None, 1):
            print("ERROR: --warm-start is sequential (frame t seeds frame "
                  "t+1); drop --eval-batch")
            return 2
    if args.dstype and args.dataset != "sintel":
        print(f"ERROR: --dstype only applies to --dataset sintel "
              f"(got --dataset {args.dataset})")
        return 2
    if args.split == "testing":
        if args.dataset not in ("kitti", "sintel"):
            print("ERROR: --split testing is only wired for --dataset "
                  "kitti / sintel")
            return 2
        if not args.dump_flow:
            print(f"ERROR: the {args.dataset} testing split has no ground "
                  "truth — pass --dump-flow DIR to export a server "
                  "submission")
            return 2
    bucket = 8
    if args.dataset == "synthetic":
        # the procedural held-out split (another seed than training's)
        from ..data.synthetic import SyntheticFlowDataset
        size = tuple(args.train_size) if args.train_size else (96, 128)
        ds = SyntheticFlowDataset(size=size, length=64, seed=9001)
        pad_mode = "sintel"
    elif args.data is None:
        print("ERROR: --data <dataset root> is required for val mode")
        return 2
    elif args.dataset == "sintel":
        split = "test" if args.split == "testing" else "training"
        ds = D.MpiSintel(args.data, split, args.dstype or "clean")
        pad_mode = "sintel"
    elif args.dataset == "chairs":
        ds = D.FlyingChairs(args.data, "validation")
        pad_mode = "sintel"
    elif args.dataset == "things":
        ds = D.FlyingThings3D(args.data)
        pad_mode = "sintel"
    else:   # kitti
        ds = D.Kitti(args.data, args.split or "training")
        pad_mode = "kitti"
        bucket = 64          # per-image sizes onto one padded shape
    if len(ds) == 0:
        print(f"ERROR: dataset {args.dataset!r} found 0 samples under "
              f"{args.data!r} — check --data (and --split)")
        return 2
    if not ds.has_gt and not args.dump_flow:
        print("ERROR: dataset has no ground-truth flow (testing split, or "
              "a root missing flow_occ/) — metrics are impossible; pass "
              "--dump-flow DIR to export predictions instead")
        return 2
    if args.bucket is not None:
        bucket = args.bucket
    weighting = args.weighting or ("pixel" if args.dataset == "kitti"
                                   else "sample")
    model = load_model(args, config)
    metrics = evaluate_dataset(model, config, ds, iters=args.iters,
                               pad_mode=pad_mode, bucket=bucket,
                               weighting=weighting,
                               batch_size=args.eval_batch or 1,
                               dump_dir=args.dump_flow,
                               warm_start=args.warm_start,
                               trace_dir=args.trace,
                               trace_steps=args.trace_steps or 4,
                               max_samples=args.max_samples)
    name = f"{args.dataset} ({'small' if args.small else 'full'})"
    if not ds.has_gt:
        print(f"[val] {name}: no ground truth — exported "
              f"{metrics['samples']} prediction(s) to {args.dump_flow} "
              f"(server-submission naming) in {metrics['seconds']:.1f}s")
        return 0
    weights = ("the --load checkpoint" if args.load else
               "seeded RANDOM weights (no --load): these EPEs measure an "
               "untrained model")
    print(f"[val] {name} on {weights}: " + "  ".join(
        f"{k}={v:.4f}" for k, v in metrics.items()))
    return 0
