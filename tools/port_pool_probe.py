#!/usr/bin/env python3
"""Where a served configuration's CUDA graph pools go, key by key, on one
GPU, beside their static prices (``raft_tpu_torch/lint/budget.py``).

    python3 tools/port_pool_probe.py [--size 432 1024] [--max-batch 4] \\
        [--sessions 4] [--small] [--out FILE]

Builds the port's ``InferenceEngine`` for the configuration (raft-things
f32 with the kernels by default; ``--small``: raft-small), warms it key by
key and after each key reads the allocator's snapshot: the segments of
each factory's private pool (``segment_pool_id``), their allocated and
free bytes, and the largest blocks allocated during the key's capture
(the allocator's history, with the op that asked for each).  Then prices
the same keys from fake tensors (``serving_pool_prices``) and prints, per
key, the measured growth of its pool beside the price.  Prints the card's
name and power limit first; with ``--out``, the whole record as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _pools(pool_ids) -> dict:
    import torch
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", ()))
        if pid in pool_ids:
            d = out.setdefault(pool_ids[pid], {"reserved": 0, "allocated": 0,
                                               "segments": 0})
            d["reserved"] += seg["total_size"]
            d["allocated"] += seg["allocated_size"]
            d["segments"] += 1
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, nargs=2, default=(432, 1024))
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import torch

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.lint import budget
    from raft_tpu_torch.lint.budget import enumerate_warmup_grid
    from raft_tpu_torch.models.raft import init_raft_torch
    from raft_tpu_torch.serving import ServeConfig
    from raft_tpu_torch.serving.engine import InferenceEngine
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (RAFTConfig.small_model(corr_impl="pallas") if args.small else
           RAFTConfig.full(corr_impl="pallas", gru_impl="pallas"))
    h, w = args.size
    sc = ServeConfig(buckets=((h, w),), max_batch=args.max_batch,
                     max_sessions=args.sessions)
    model = init_raft_torch(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    eng = InferenceEngine(cfg, model, sc, iters=cfg.iters, stream=True)
    eng._prepare_kernels()
    names = {id(eng._fn): "pair", id(eng._encode_fn): "encode",
             id(eng._stream_fn): "stream", id(eng._sbatch_fn): "sbatch"}
    rec = {"config": "small" if args.small else "full", "image_hw": [h, w],
           "max_batch": args.max_batch, "sessions": args.sessions,
           "keys": []}
    grid = enumerate_warmup_grid(eng.config, sc, stream=True)
    before = {}
    for key in grid:
        kind, kh, kw, b, _ = key
        torch.cuda.synchronize()
        torch.cuda.memory._record_memory_history(max_entries=200000)
        eng._warm_key(eng._key(kh, kw, b, kind), kind, kh, kw, b)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        pool_ids = {tuple(f.graphs.pool): names[id(f)]
                    for f in eng._factories
                    if f.graphs is not None and f.graphs.pool is not None}
        now = _pools(pool_ids)
        pool = {"pair": "pair", "encode": "encode", "stream": "stream",
                "sbatch": "sbatch"}.get(kind)
        grow = (now.get(pool, {}).get("reserved", 0)
                - before.get(pool, {}).get("reserved", 0)) if pool else 0
        allocs = []
        for tr in snap.get("device_traces", [[]])[0]:
            if tr.get("action") == "alloc":
                frames = [f"{f.get('name')}@{Path(f.get('filename', '')).name}"
                          f":{f.get('line')}" for f in tr.get("frames", [])
                          if "raft_tpu_torch" in f.get("filename", "")
                          or "torch/nn" in f.get("filename", "")][:3]
                allocs.append((tr["size"], frames))
        allocs.sort(key=lambda a: -a[0])
        row = {"key": [kind, kh, kw, b], "pool": pool,
               "pool_growth_mib": grow / 2 ** 20,
               "pools_mib": {k: v["reserved"] / 2 ** 20
                             for k, v in now.items()},
               "allocs": len(allocs),
               "alloc_mib": sum(a[0] for a in allocs) / 2 ** 20,
               "largest": [(round(s / 2 ** 20, 1), f) for s, f in
                           allocs[:8]]}
        rec["keys"].append(row)
        print(json.dumps(row), flush=True)
        before = now
    priced = budget.serving_pool_prices(cfg, sc)
    rec["priced"] = priced
    rec["measured_total_mib"] = sum(v["reserved"] for v in before.values()) \
        / 2 ** 20
    rec["priced_total_mib"] = priced["total_bytes"] / 2 ** 20
    for k in priced["keys"]:
        print(f"priced {k['key'][:4]}: peak {k['peak_bytes'] / 2 ** 20:.1f} "
              f"MiB, kept {k['kept_bytes'] / 2 ** 20:.1f} MiB", flush=True)
    print(json.dumps({"measured_total_mib": rec["measured_total_mib"],
                      "priced_total_mib": rec["priced_total_mib"],
                      "measured_pools_mib": {
                          k: v["reserved"] / 2 ** 20
                          for k, v in before.items()},
                      "priced_pools_mib": {
                          k: v["price"] / 2 ** 20
                          for k, v in priced["pools"].items()}}),
          flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
