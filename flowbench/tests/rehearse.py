"""A CPU rehearsal of one cell at the tests' tiny size, in its own
process: ``python3 flowbench/tests/rehearse.py <cell> <trace> [fault]``.
Prints what the command prints (the checks, then the result line) and
exits as the command would; the device is the CPU, so no device metric
can appear."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    import torch
    torch.set_num_threads(2)        # the tests run several of these at once
    from flowbench import harness
    from flowbench.tests.conftest import TINY
    cell, trace = sys.argv[1], bool(int(sys.argv[2]))
    fault = sys.argv[3] if len(sys.argv) > 3 else None
    line = harness.run_cell(harness.Run(
        cell=harness.load_cell(cell), seed=2 ** 33 + 7, seconds=1.0,
        trace=trace, device="cpu", t_process=time.time(), fault=fault,
        overrides=TINY))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
