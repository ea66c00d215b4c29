"""The shape of the result line, from the CPU rehearsal of each driver,
and the characters of every name and unit in ``BENCHMARK.json``."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def rehearse(cell: str, trace: int, fault: str = None):
    args = [sys.executable, "flowbench/tests/rehearse.py", cell, str(trace)]
    out = subprocess.run(args + ([fault] if fault else []), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("cell", ["things-serve-closed8", "things-train-chairs"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(cell, trace):
    line, err = rehearse(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]          # the checks come last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run writes no number under a device metric's name
        assert not any(k.startswith(("b1_", "b2_", "idle_", "mfu"))
                       for k in line["metrics"])
    else:
        assert "setup_s" in line["metrics"]
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}:" in err
    # the checks are standard error's last lines
    assert err.strip().splitlines()[-1].startswith("correct:")


def test_benchmark_names_and_units():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(
            ROOT, "flowbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "flowbench", "limits", w["name"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "flowbench", "metrics", m["name"] + ".py"))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
