#!/usr/bin/env python3
"""cuDNN's two ways of choosing convolution algorithms, per serving key,
on one GPU: how fast each captured key replays, and whether two processes
capture the same bits.

    python3 tools/port_cudnn_modes.py [--configs smoke,fleet,s1] [--reps 20]

For each serving configuration and each ``ServeConfig.cudnn`` mode
("benchmark": cuDNN times its candidates in each process; "heuristic": its
heuristic order, fixed for a shape and a card) two fresh processes each
build the port's ``InferenceEngine`` with seeded random weights, warm it
(one CUDA graph capture per key) and then, per captured key, hash the
key's output on its seeded probe input (``serving/aot_cache.py``, what an
engine-cache hit compares) and time the key's call on that input (CUDA
events, the median of ``--reps`` after 3 of warm-up).  The configurations:

* ``smoke``: ``serve_bench --smoke --fleet``'s replicas (raft-small,
  32x48, 2 iterations, converge:1e-2, max batch 4, 64 sessions);
* ``fleet``: ``chip_smoke.py`` phase 13's replicas (raft-things f32 with
  the kernels, 432x1024, 12 iterations, batch 1, 2 sessions);
* ``s1``: the full-size serving configuration (raft-things f32 with the
  kernels, 432x1024, max batch 4, 4 sessions).

Prints the card's name and power limit, one JSON line per process, then
one line per key: each mode's ms (the two processes' medians) and the
heuristic's ratio to the benchmark, and whether the two processes' probe
digests agree in each mode; last, a JSON summary per configuration (the
largest ratio, the keys whose digests differ).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CONFIGS = {
    "smoke": dict(small=True, iters=2, policy="converge:1e-2", hw=(32, 48),
                  max_batch=4, sessions=64, gru="xla"),
    "fleet": dict(small=False, iters=12, policy=None, hw=(432, 1024),
                  max_batch=1, sessions=2, gru="pallas"),
    "s1": dict(small=False, iters=12, policy=None, hw=(432, 1024),
               max_batch=4, sessions=4, gru="pallas"),
}


def child(name: str, mode: str, reps: int) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import init_raft_torch
    from raft_tpu_torch.serving import ServeConfig
    from raft_tpu_torch.serving.aot_cache import digest_outputs, probe_seed
    from raft_tpu_torch.serving.engine import InferenceEngine
    c = CONFIGS[name]
    make = RAFTConfig.small_model if c["small"] else RAFTConfig.full
    config = make(iters=c["iters"], corr_impl="pallas", gru_impl=c["gru"])
    model = init_raft_torch(config, torch.Generator().manual_seed(0),
                            device="cuda")
    h, w = c["hw"]
    sconfig = ServeConfig(buckets=((h, w),), max_batch=c["max_batch"],
                          max_sessions=c["sessions"],
                          iters_policy=c["policy"], cudnn=mode)
    engine = InferenceEngine(config, model, sconfig, iters=c["iters"],
                             stream=True)
    t0 = time.perf_counter()
    engine.warmup(verbose=False)
    warm_s = time.perf_counter() - t0
    keys = {}
    for key in list(engine._exec):
        kind, kh, kw, b, _ = key
        call = engine._probe_call(kind, kh, kw, b, probe_seed(key))
        if call is None:
            continue
        digest = digest_outputs(call())
        for _ in range(3):
            call()
        ms = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        keys[f"{kind}-{kh}x{kw}-b{b}"] = {
            "ms": statistics.median(ms), "digest": digest[:16]}
    print(json.dumps({"config": name, "mode": mode, "warmup_s": warm_s,
                      "keys": keys}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--configs", default="smoke,fleet,s1")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--child", nargs=2, metavar=("CONFIG", "MODE"))
    args = p.parse_args()
    if args.child:
        child(*args.child, args.reps)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for name in args.configs.split(","):
        runs = {"benchmark": [], "heuristic": []}
        # processes in turns: benchmark, heuristic, heuristic, benchmark
        for mode in ("benchmark", "heuristic", "heuristic", "benchmark"):
            r = subprocess.run(
                [sys.executable, __file__, "--child", name, mode,
                 "--reps", str(args.reps)], capture_output=True, text=True,
                timeout=600)
            line = (r.stdout.strip().splitlines() or [""])[-1]
            print(line, flush=True)
            if r.returncode:
                print(r.stderr[-3000:], flush=True)
                rc = 1
                continue
            runs[mode].append(json.loads(line))
        if not all(len(v) == 2 for v in runs.values()):
            continue
        worst, unstable = 0.0, {"benchmark": [], "heuristic": []}
        for key in runs["benchmark"][0]["keys"]:
            ms = {m: statistics.median(r["keys"][key]["ms"]
                                       for r in runs[m]) for m in runs}
            same = {m: runs[m][0]["keys"][key]["digest"]
                    == runs[m][1]["keys"][key]["digest"] for m in runs}
            ratio = ms["heuristic"] / ms["benchmark"]
            worst = max(worst, ratio)
            for m in runs:
                if not same[m]:
                    unstable[m].append(key)
            print(f"{name} {key}: benchmark {ms['benchmark']:.4f} ms, "
                  f"heuristic {ms['heuristic']:.4f} ms ({ratio:.3f}x); "
                  f"digests equal across processes: benchmark "
                  f"{same['benchmark']}, heuristic {same['heuristic']}",
                  flush=True)
        print(json.dumps({"config": name, "worst_ratio": round(worst, 4),
                          "digests_differ": unstable,
                          "warmup_s": {m: [r["warmup_s"] for r in runs[m]]
                                       for m in runs}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
