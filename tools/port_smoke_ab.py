#!/usr/bin/env python3
"""The port's pairwise serving smokes, checkouts and server knobs in turns.

    python3 tools/port_smoke_ab.py --arm parent=build/parent --arm change=. \\
        [--arm bench=.:--cudnn benchmark] [--rounds 2] [--modes closed,open]

Each ARM is ``LABEL=ROOT[:EXTRA ARGS]``: a checkout of the repository and
extra ``serve_bench`` flags.  Per round, every arm runs ``python -m
raft_tpu_torch.tools.serve_bench --smoke`` (raft-small at 32x48, the JAX
tool's gates: tracing under 5% of pairs/s, history under 2%, spans
covering at least 95% of a request on average and 75% each) in each mode
(closed loop; open loop at 20 requests/s), on the card unless ``--cpu``.
Prints the card's name and power limit, then one line per run: the exit
code, pairs/s, the tracing and history controls (their pairs/s, the
overhead and whether the measured phase was re-run), the span coverage
(mean, min) and the smoke's failure line if any (a run over ``--timeout``
is stopped with SIGABRT, which prints its threads' stacks); last, per arm
and mode, the passes and the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def run_one(root: Path, mode: str, extra: list, cpu: bool,
            timeout: float) -> dict:
    out = Path(tempfile.mkstemp(suffix=".jsonl")[1])
    argv = [sys.executable, "-m", "raft_tpu_torch.tools.serve_bench",
            "--smoke", "--out", str(out), *extra]
    if mode == "open":
        argv += ["--mode", "open", "--rate", "20"]
    if cpu:
        argv.append("--cpu")
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    proc = subprocess.Popen(argv, cwd=str(root), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        # the interpreter's fault handler prints every thread's stack on
        # SIGABRT: where the run hung
        proc.send_signal(signal.SIGABRT)
        try:
            stdout, stderr = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        rc = "timeout"
    recs = [json.loads(x) for x in out.read_text().splitlines() if x]
    out.unlink()
    rec = recs[-1] if recs else {}
    fail = [x for x in stdout.splitlines() if "SMOKE FAIL" in x]
    tr, hi = rec.get("trace_overhead", {}), rec.get("history_overhead", {})
    acc = rec.get("trace_accounting") or {}
    return {"rc": rc, "pairs_per_sec": rec.get("pairs_per_sec"),
            "untraced": tr.get("untraced_pairs_per_sec"),
            "traced": tr.get("traced_pairs_per_sec"),
            "trace_pct": tr.get("overhead_pct"),
            "trace_retried": bool(tr.get("retried")),
            "history_pct": hi.get("overhead_pct"),
            "history_retried": bool(hi.get("retried")),
            "coverage_mean": acc.get("span_coverage_mean"),
            "coverage_min": acc.get("span_coverage_min"),
            "worst_gaps": acc.get("worst_trace_gaps"),
            "anomaly_fires": {k: v for k, v in
                              (rec.get("anomaly_fires") or {}).items() if v},
            "batch": rec.get("batch_size_mean"),
            "p50_ms": (rec.get("latency_ms") or {}).get("p50"),
            "fail": fail[-1][:300] if fail else None,
            "stderr": stderr[-12000:] if rc and not fail else None}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arm", action="append", required=True)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--modes", default="closed,open")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--timeout", type=float, default=240.0,
                   help="seconds a run may take; then its threads' stacks "
                        "are printed and it counts as failed")
    args = p.parse_args()
    arms = []
    for spec in args.arm:
        label, _, rest = spec.partition("=")
        root, _, extra = rest.partition(":")
        arms.append((label, Path(root).resolve(), shlex.split(extra)))
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    runs = {}
    for rnd in range(args.rounds):
        order = arms if rnd % 2 == 0 else arms[::-1]
        for label, root, extra in order:
            for mode in args.modes.split(","):
                res = run_one(root, mode, extra, args.cpu, args.timeout)
                runs.setdefault((label, mode), []).append(res)
                print(json.dumps({"round": rnd, "arm": label, "mode": mode,
                                  **res}), flush=True)
    for (label, mode), rs in runs.items():
        def med(k):
            vals = [r[k] for r in rs if r[k] is not None]
            return statistics.median(vals) if vals else None
        print(json.dumps({"arm": label, "mode": mode,
                          "passed": sum(r["rc"] == 0 for r in rs),
                          "runs": len(rs),
                          **{f"median_{k}": med(k) for k in (
                              "pairs_per_sec", "trace_pct", "history_pct",
                              "coverage_mean", "coverage_min", "p50_ms")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
