"""The harness's core: find a cell by name, run it, print its line.

Everything is found by the names in ``BENCHMARK.json`` at the checkout's
root, so a later cell, configuration, traffic mix or per-layer metric
comes as files and an entry, with no edit here:

* the cell's ``config`` -> the configuration's ``file`` (sizes, the
  port's settings, the weights' recipe);
* the cell's ``traffic`` -> ``flowbench/traffic/<traffic>.json``, whose
  ``driver`` names the general generator in ``flowbench/drivers/`` that
  reads its parameters;
* the cell's name -> ``flowbench/limits/<cell>.json``, the limit of each
  number that decides ``correct``;
* each per-layer metric -> ``flowbench/metrics/<metric>.py``, a reader
  with ``read(readings) -> float | None``.

A driver returns what the window measured (``Outcome``); the harness
keeps the cell's end-to-end metrics (``--trace 0``) or asks each per-layer
reader (``--trace 1``), and leaves out a metric whose reader finds
nothing to read.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Run:
    """What a driver is asked to do.  ``device`` is 'cuda' for every run
    of the command; the CPU is for the tests' rehearsals only.
    ``calibrate`` also reads the control's and the faults' numbers
    (``flowbench/calibrate.py``); ``fault`` plants one fault in the timed
    path, or puts the control in the program's place ('control'), for
    the tests."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_process: Optional[float] = None
    calibrate: bool = False
    fault: Optional[str] = None
    overrides: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    readings: dict
    device: dict
    trace: Optional[dict] = None
    calibration: dict = dataclasses.field(default_factory=dict)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or _load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    moves_here = set()
    e2e = []
    for m in bench["end_to_end"]:
        if name in m.get("workloads", cells):
            e2e.append(m)
            moves_here.add(m["name"])
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves_here)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load_json(ROOT / conf["file"]),
                traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "flowbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(run: Run) -> dict:
    """One run; returns the result line's object (with ``checks`` last)."""
    driver = importlib.import_module(
        f"flowbench.drivers.{run.cell.traffic['driver']}")
    out: Outcome = driver.run(run)
    metrics = {}
    if run.trace:
        readings = dict(out.readings, trace=out.trace,
                        platform=out.device["platform"])
        for m in run.cell.per_layer:
            value = load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    correct = (out.failed == 0 and bool(out.checks)
               and all(c.ok for c in out.checks))
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if run.trace:
        line["breakdown"] = (out.trace or {}).get(
            "breakdown", {"device_ops": [], "idle_gaps": []})
    if out.calibration:
        line["calibration"] = out.calibration
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(line: dict) -> None:
    """The checks on standard error as its last lines, then the result as
    the last line of standard output."""
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(f"correct: {line['correct']} (attempted {line['attempted']}, "
          f"failed {line['failed']})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="flowbench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_process: Optional[float] = None) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"flowbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}:"
              f" no result", file=sys.stderr)
        return 2
    line = run_cell(Run(cell=cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t_process=t_process))
    found = forbidden_modules()
    if found:
        print(f"flowbench: the process loaded {found}: no result",
              file=sys.stderr)
        return 3
    emit(line)
    return 0
