"""Readings for the limits of ``correct``, many seeds in one process.

    python3 flowbench/calibrate.py --workload <name> --seeds 11,12,13 \
        --seconds 5 [--out chiprun_out/calib.jsonl]

For each seed one run of the cell as the command makes it (set-up, a
short window at the cell's own load, the check), and beside the
program's numbers the control's (the plain reference computed with TF32
on, in the program's place) and, for a training cell, the half-batch
fault's (the reference on half of each batch).  One JSON line a seed.
The benchmark's own runs never run this; ``PERF.md`` gives the readings
each limit was set from.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from flowbench import harness
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.time()
        line = harness.run_cell(harness.Run(
            cell=cell, seed=seed, seconds=args.seconds, trace=False,
            t_process=t0, calibrate=True))
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.time() - t0, **line}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
