"""The benchmark's command: one run of one cell.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
directory and ``raft_tpu_torch``.  It needs CUDA (it exits 2 without a
card, printing no result) and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), then ``checks``, each compared number with its
limit.  ``PERF.md`` (sections 2 to 4) says what each part measures.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """Wall-clock second this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = _process_start()
ROOT = Path(__file__).resolve().parent.parent

# a library the port imports must not load JAX by itself
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "flowbench" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from flowbench import harness
    return harness.main(argv, t_process=T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
