"""Input-pipeline throughput: ``python -m raft_tpu_torch.data.loader_bench``.

The port's counterpart of the JAX package's ``data/loader_bench.py``, on
FlyingChairs files (a fabricated tree at the release's 384x512 frame size
unless ``--data`` names a real one), so the rates include the decode of
PPM frames and ``.flo`` flows.  Stages:

* ``host_path`` — one process, in turns sample by sample: decode +
  augment (the host recipe) vs decode only (what a worker ships under
  ``--device-aug``), in pairs/s;
* ``mp`` — ``MPSampleLoader`` per worker count and transport (pickle,
  shm), decode + augment, in pairs/s after a warm-up that drains the
  workers' first results;
* ``device_aug_e2e`` — decode-only shm workers -> ``BatchBuffers`` ->
  ``PrefetchLoader`` with the device augmentor on the side stream, in
  pairs/s of delivered augmented batches (each synchronised before the
  next is taken), on the CUDA device unless ``--cpu``.

Prints one JSON object; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from .augment import FlowAugmentor
from .augment_device import (DecodeOnlyDataset, make_batch_augment_fn,
                             make_device_augmentor)
from .datasets import FlyingChairs
from .mp_loader import MPSampleLoader, measure_rate


def host_path_rates(root, crop, samples: int) -> dict:
    """In-process pairs/s, decode + augment vs decode only, the two
    alternating sample by sample so a burst of load hits both."""
    aug = FlyingChairs(root, augmentor=FlowAugmentor(crop, min_scale=-0.1,
                                                     max_scale=1.0))
    dec = DecodeOnlyDataset(FlyingChairs(root))
    t_aug = t_dec = 0.0
    n = len(aug)
    for i in range(samples):
        t0 = time.perf_counter()
        aug[i % n]
        t1 = time.perf_counter()
        dec[i % n]
        t_aug += t1 - t0
        t_dec += time.perf_counter() - t1
    return {"decode_augment_pairs_per_s": samples / t_aug,
            "decode_only_pairs_per_s": samples / t_dec}


def mp_rate(ds, workers: int, samples: int, transport: str) -> float:
    """Pairs/s of an MPSampleLoader over ``ds`` (its first results,
    made while it started, are drained before the clock starts)."""
    loader = MPSampleLoader(ds, num_workers=workers, seed=0,
                            transport=transport)
    try:
        return measure_rate(iter(loader), samples, warmup=2 * workers + 2)
    finally:
        loader.close()


def device_aug_rate(root, crop, workers: int, batch: int, batches: int,
                    device) -> dict:
    """Augmented batches delivered end to end: decode-only shm workers,
    collation, staging and the device augmentor."""
    from .pipeline import BatchBuffers, PrefetchLoader, batched
    ds = DecodeOnlyDataset(FlyingChairs(root))
    fn = make_batch_augment_fn(make_device_augmentor("chairs", crop),
                               hw=ds.canonical_hw)
    loader = MPSampleLoader(ds, num_workers=workers, seed=0, transport="shm")
    pf = PrefetchLoader(batched(iter(loader), batch,
                                collator=BatchBuffers.for_loader(batch, 2)),
                        device, augment_fn=fn)

    def synced(it):
        for b in it:
            if b[0].is_cuda:
                torch.cuda.synchronize()
            yield b

    try:
        rate = measure_rate(synced(pf), batches, warmup=3)
    finally:
        pf.close()
        loader.close()
    return {"device": str(device), "batch": batch, "workers": workers,
            "pairs_per_s": rate * batch}


def run(root=None, samples: int = 32, workers=(1, 2, 4), crop=(368, 496),
        batch: int = 10, e2e_batches: int = 8, device="cuda") -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        if root is None:
            from .fabricate import chairs_tree
            root = chairs_tree(Path(tmp) / "chairs", n_pairs=24)
        res = {"crop": list(crop), "samples_per_point": samples,
               "host_path": host_path_rates(root, crop, samples), "mp": {}}
        aug_ds = FlyingChairs(root, augmentor=FlowAugmentor(
            crop, min_scale=-0.1, max_scale=1.0))
        for w in workers:
            res["mp"][f"workers_{w}"] = {
                tr: mp_rate(aug_ds, w, samples, tr)
                for tr in ("pickle", "shm")}
        res["device_aug_e2e"] = device_aug_rate(
            root, crop, max(workers), batch, e2e_batches,
            torch.device(device))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m raft_tpu_torch.data."
                                     "loader_bench")
    p.add_argument("--data", default=None, metavar="ROOT",
                   help="a FlyingChairs root (default: a fabricated tree "
                        "of 24 pairs at 384x512 in a temporary directory)")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--crop", type=int, nargs=2, default=(368, 496))
    p.add_argument("--workers", type=int, nargs="+", default=(1, 2, 4))
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="run the device augmentor on the CPU")
    p.add_argument("--out", default=None, metavar="PATH")
    args = p.parse_args(argv)
    res = run(args.data, args.samples, tuple(args.workers), tuple(args.crop),
              args.batch, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
