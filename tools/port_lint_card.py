#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14 without the rest of the script, on one GPU:
builds the kernels, then (a) every kernel entry's launch envelope against
its source's query, ``cudaFuncGetAttributes`` and the occupancy API, (c)
one captured request and one eager train step with contract checking on,
(d) the span accounting of a closed loop at 8 clients on raft-small at
32x48.  Part (b), the graph pools, needs phases 8 and 9's measured pools
and runs only inside the whole script.

    python3 tools/port_lint_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from raft_tpu_torch import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    print(f"build {_build.build_all():.1f} s", flush=True)
    print(_build.compiler_report(), flush=True)
    dev = torch.device("cuda")
    t1 = time.perf_counter()
    rec = {"device": smi, "envelopes": cs.lint_envelopes()}
    rec["contracts"] = cs.lint_contracts(dev)
    rec["span_accounting"] = cs.lint_spans(dev)
    rec["s"] = time.perf_counter() - t1
    rec["with_build_s"] = time.perf_counter() - t0
    print(json.dumps({"lint": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
