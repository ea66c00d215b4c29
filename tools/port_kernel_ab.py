#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels of two checkouts on one GPU.

    python3 tools/port_kernel_ab.py PARENT_ROOT CHANGE_ROOT [--rounds N]

Each root is a checkout of the repository (for instance a ``git archive``
of the parent commit unpacked into a directory that ``.gitignore`` lists).
The kernels of one checkout run in a process of their own, the checkouts in
turns (parent, change, change, parent, ...), each process building its
kernels from its own sources and timing them on the inputs of this
checkout's ``chip_smoke.kernel_inputs`` (same seed): the correlation
lookup and the window lookup (float32 and bfloat16 operands, each on
phase 3's noisy coords and on windows scattered over the map) and the
SepConvGRU (float32 and bfloat16 I/O) on the 54x128 query grid of a
432x1024 pair,
the ragged lookup (float32, also on scattered windows, and bfloat16) on
the 3-item 440x1248 box, the packed lookup (float32 under 'all', also on
scattered windows, and 'window'; bfloat16 under 'window') on the 54x128
grid.  A checkout whose GRU kernel
reads prepared weights (``prepare_gru_weights``) gets them; an older one
its fused float32 weights.  Then whole requests at 432x1024, 12
iterations, on seeded random weights, through ``make_inference_fn`` (a
checkout that has ``models/capture.py`` replays a captured CUDA graph, an
older one runs eager): the float32 main path under
p_select 'all' and 'window', the BF path (``chip_smoke.py`` phase 6c:
bfloat16 compute, 'default' corr, pack, p_select 'window'),
pallas-bf16corr-ctx-gru (bfloat16 compute, 'default' corr, p_select
'all') and its -win twin (p_select 'window'), and the BF path's loop set-up
(``prepare_loop``) alone.  Prints the card's name and power limit, then
one line per process: ms per call on the device (CUDA events; a kernel
200 calls after 5 of warm-up, a request or set-up the median of 8 after
one of warm-up) and, in brackets, the host's ms to issue a call (a device
time close to it is the host's, not the kernel's); then the kernels and
copies the device runs for one request of each path (torch.profiler).  Last,
whether each kernel call's output is bitwise the same in the two
checkouts.  Cards differ between machines, so only times of one run are
compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _time_one(root: str, tag: str, outputs: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import raft_tpu_torch as rt
    from raft_tpu_torch import _build
    from raft_tpu_torch.ops import corr_cuda, gru_cuda

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    r = 4
    x = smoke.kernel_inputs(np.random.RandomState(0), dev, r=r)
    f1, levels, coords, wild = x["fmap1"], x["levels"], x["coords"], x["wild"]
    rf1, rlevels, rcoords, sizes8 = x["rf1"], x["rlevels"], x["rcoords"], x["sizes8"]
    rwild = x["rwild"]
    h, mot, ctx = x["gru"]
    bf1, blevels = f1.bfloat16(), [lv.bfloat16() for lv in levels]
    rbf1, rblevels = rf1.bfloat16(), [lv.bfloat16() for lv in rlevels]
    hb, mb, cb = h.bfloat16(), mot.bfloat16(), tuple(c.bfloat16() for c in ctx)
    model = rt.init_raft_torch(rt.RAFTConfig.full(), device=dev,
                               generator=torch.Generator().manual_seed(0))
    fw = gru_cuda.fuse_gru_weights(model.update_block.gru, 128, 128)
    fw_bf = {k: v.bfloat16().float() for k, v in fw.items()}
    if hasattr(gru_cuda, "prepare_gru_weights"):
        kw = gru_cuda.prepare_gru_weights(fw, torch.float32)
        kw_bf = gru_cuda.prepare_gru_weights(fw_bf, torch.bfloat16)
    else:                                  # float32 copies of the weights
        kw, kw_bf = fw, fw_bf

    def ms(fn, reps=200):
        """(device ms, host ms) per call: CUDA events around ``reps``
        back-to-back calls, and the host's time to issue them."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, host

    def median_ms(fn, n=8):
        """(device ms, host ms), the medians of ``n`` calls after one of
        warm-up, each alone: CUDA events around it and the host's time to
        issue it."""
        fn()
        torch.cuda.synchronize()
        dev_ms, host_ms = [], []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end))
        return statistics.median(dev_ms), statistics.median(host_ms)

    lookup = corr_cuda.corr_lookup_cuda
    calls = {
        "corr_lookup": lambda: lookup(f1, levels, coords, r),
        "corr_lookup_scattered": lambda: lookup(f1, levels, wild, r),
        "corr_lookup_bf16": lambda: lookup(bf1, blevels, coords, r),
        "corr_lookup_bf16_scattered": lambda: lookup(bf1, blevels, wild, r),
        "corr_window": lambda: corr_cuda.corr_window_cuda(f1, levels, coords, r),
        "corr_window_scattered": lambda: corr_cuda.corr_window_cuda(
            f1, levels, wild, r),
        "corr_window_bf16": lambda: corr_cuda.corr_window_cuda(
            bf1, blevels, coords, r),
        "corr_window_bf16_scattered": lambda: corr_cuda.corr_window_cuda(
            bf1, blevels, wild, r),
        "corr_ragged": lambda: corr_cuda.corr_ragged_cuda(
            rf1, rlevels, rcoords, sizes8, r),
        "corr_ragged_scattered": lambda: corr_cuda.corr_ragged_cuda(
            rf1, rlevels, rwild, sizes8, r),
        "corr_ragged_bf16": lambda: corr_cuda.corr_ragged_cuda(
            rbf1, rblevels, rcoords, sizes8, r),
        "corr_packed_all": lambda: corr_cuda.corr_packed_cuda(
            f1, levels, coords, r, "all"),
        "corr_packed_all_scattered": lambda: corr_cuda.corr_packed_cuda(
            f1, levels, wild, r, "all"),
        "corr_packed_window": lambda: corr_cuda.corr_packed_cuda(
            f1, levels, coords, r, "window"),
        "corr_packed_bf16_window": lambda: corr_cuda.corr_packed_cuda(
            bf1, blevels, coords, r, "window"),
        "sep_conv_gru": lambda: gru_cuda.sep_conv_gru_cuda(kw, h, mot, ctx),
        "sep_conv_gru_bf16": lambda: gru_cuda.sep_conv_gru_cuda(kw_bf, hb, mb, cb)}
    np.savez(outputs, **{k: fn().float().cpu().numpy() for k, fn in calls.items()})
    times = {k: ms(fn) for k, fn in calls.items()}

    # whole requests, as chip_smoke.py drives them
    from raft_tpu_torch.models.raft import encode_pair, prepare_loop
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(1)
    im1 = rng.rand(1, smoke.H_IMG, smoke.W_IMG, 3).astype(np.float32)
    im2 = np.roll(im1, (1, 3), axis=(1, 2))
    cfg_k = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    cfg_w = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                               pallas_p_select="window")
    bf = dict(corr_impl="pallas", gru_impl="pallas", compute_dtype="bfloat16",
              corr_precision="default")
    cfg_bf = rt.RAFTConfig.full(**bf, pallas_pack=True, pallas_p_select="window",
                                pallas_p_blk=1024)
    cfg_bfc = rt.RAFTConfig.full(**bf)
    cfg_bfw = rt.RAFTConfig.full(**bf, pallas_p_select="window",
                                 pallas_p_blk=1024)
    model_bf = rt.init_raft_torch(cfg_bf, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    from torch.profiler import ProfilerActivity, profile

    def device_ops(fn) -> int:
        """Kernels and copies the device runs for one ``fn()`` call."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(k.count for k in prof.key_averages()
                   if k.device_type == torch.autograd.DeviceType.CUDA)

    ops = {}
    for name, cfg, mdl in (("e2e_main", cfg_k, model), ("e2e_window", cfg_w, model),
                           ("e2e_bf", cfg_bf, model_bf),
                           ("e2e_bf16corr_ctx_gru", cfg_bfc, model_bf),
                           ("e2e_bf16corr_ctx_gru_win", cfg_bfw, model_bf)):
        infer = rt.make_inference_fn(cfg, iters=smoke.ITERS)
        times[name] = median_ms(lambda: infer(mdl, im1, im2))
        ops[name] = device_ops(lambda: infer(mdl, im1, im2))
    with torch.no_grad():
        a, b = (torch.from_numpy(x).to(dev) for x in (im1, im2))
        fm1, fm2, _, inp = encode_pair(model_bf, a, b, cfg_bf)
        times["bf_loop_setup"] = median_ms(
            lambda: prepare_loop(model_bf, fm1, fm2, inp, cfg_bf))
    print(f"{tag}: " + " ".join(f"{k} {d:.4f} (host {h:.4f})"
                                 for k, (d, h) in times.items())
          + "; device ops per request: "
          + " ".join(f"{k} {n}" for k, n in ops.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=3,
                    help="pairs of turns: parent, change, change, parent, ...")
    ap.add_argument("--one", nargs=3, metavar=("ROOT", "TAG", "OUTPUTS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _time_one(*args.one)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    order = []
    for i in range(args.rounds):
        pair = [("parent", args.parent), ("change", args.change)]
        order += pair if i % 2 == 0 else pair[::-1]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, root) in enumerate(order):
            subprocess.run([sys.executable, __file__, "--one", root, tag,
                            f"{tmp}/{tag}_{i}.npz", args.parent, args.change],
                           check=True)
        import numpy as np
        with np.load(f"{tmp}/parent_0.npz") as a, \
                np.load(f"{tmp}/change_1.npz") as b:
            same = {k: bool(np.array_equal(a[k], b[k], equal_nan=True))
                    for k in a.files}
    print(f"kernel outputs bitwise equal, parent and change: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
