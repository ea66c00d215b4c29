#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels of two checkouts on one GPU.

    python3 tools/port_kernel_ab.py PARENT_ROOT CHANGE_ROOT [--rounds N]

Each root is a checkout of the repository (for instance a ``git archive``
of the parent commit unpacked into a directory that ``.gitignore`` lists).
The kernels of one checkout run in a process of their own, the checkouts in
turns (parent, change, change, parent, ...), each process building its
kernels from its own sources and timing them on the inputs of this
checkout's ``chip_smoke.kernel_inputs`` (same seed): the correlation
lookup (float32 and bfloat16 operands, on phase 3's noisy coords and on
windows scattered over the map), the window lookup and the SepConvGRU
(float32 and bfloat16 I/O) on the 54x128 query grid of a 432x1024 pair,
the ragged lookup on the 3-item 440x1248 box.  A checkout whose GRU kernel
reads prepared weights (``prepare_gru_weights``) gets them; an older one
its fused float32 weights.  Prints the card's name and power limit, then
one line per process: ms per call on the device (CUDA events, 200 calls
after 5 of warm-up) and, in brackets, the host's ms to issue a call (a
device time close to it is the host's, not the kernel's).  Cards differ
between machines, so only times of one run are compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path


def _time_one(root: str, tag: str) -> None:
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
    h, mot, ctx = x["gru"]
    bf1, blevels = f1.bfloat16(), [lv.bfloat16() for lv in levels]
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

    lookup = corr_cuda.corr_lookup_cuda
    times = {
        "corr_lookup": ms(lambda: lookup(f1, levels, coords, r)),
        "corr_lookup_scattered": ms(lambda: lookup(f1, levels, wild, r)),
        "corr_lookup_bf16": ms(lambda: lookup(bf1, blevels, coords, r)),
        "corr_lookup_bf16_scattered": ms(lambda: lookup(bf1, blevels, wild, r)),
        "corr_window": ms(lambda: corr_cuda.corr_window_cuda(f1, levels, coords, r)),
        "corr_ragged": ms(lambda: corr_cuda.corr_ragged_cuda(
            rf1, rlevels, rcoords, sizes8, r)),
        "sep_conv_gru": ms(lambda: gru_cuda.sep_conv_gru_cuda(kw, h, mot, ctx)),
        "sep_conv_gru_bf16": ms(lambda: gru_cuda.sep_conv_gru_cuda(kw_bf, hb, mb, cb))}
    print(f"{tag}: " + " ".join(f"{k} {d:.4f} (host {h:.4f})"
                                 for k, (d, h) in times.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=3,
                    help="pairs of turns: parent, change, change, parent, ...")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "TAG"),
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
    for tag, root in order:
        subprocess.run([sys.executable, __file__, "--one", root, tag,
                        args.parent, args.change], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
