"""Run manifests + the structured JSONL run-event log.

The port's copy of the JAX package's ``telemetry/events.py``.  A
**manifest** — git sha, torch and CUDA versions, device name, count and
power limit, dtype/kernel config hash, argv — lets any artifact a run
leaves behind be attributed to an exact commit + config + hardware.

The **RunLog** is an append-only ``events.jsonl``: one JSON object per
event, ``{"t": <unix seconds>, "event": <kind>, ...fields}``, with the
manifest always the first record.  ``tools/tlm.py`` tails, summarizes and
diffs these logs.

torch is imported only inside the device query, so the module loads in
tooling that never touches a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import IO, Optional

SCHEMA_VERSION = 1


def _git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD sha of the repo containing this file (or ``cwd``); None outside
    a checkout or without a git binary — never raises."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def config_hash(config) -> Optional[str]:
    """Short stable hash of a config dataclass (RAFTConfig, TrainConfig,
    ServeConfig...): the dtype/kernel identity of a run.  Two runs with the
    same hash executed the same numeric program modulo weights/data."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        payload = dataclasses.asdict(config)
    elif isinstance(config, dict):
        payload = config
    else:
        payload = {"repr": repr(config)}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


_DEVICE_KEYS = ("backend", "device_kind", "device_count", "torch_version",
                "cuda_version", "power_limit")


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it (e.g.
    "700.00 W"), or None without the tool — never raises."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _device_info() -> dict:
    """Backend/device identity from torch: its version and CUDA version,
    the device name and count, and the first card's power limit (a card
    set below its maximum runs slower under load, so a number is
    attributable only with it).  ``backend`` is ``"cuda"`` when a device
    is visible, else ``"cpu"``."""
    import torch
    info = dict.fromkeys(_DEVICE_KEYS)
    info["torch_version"] = torch.__version__
    info["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        info["backend"] = "cuda"
        info["device_kind"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
        info["power_limit"] = _power_limit()
    else:
        info["backend"] = "cpu"
        info["device_kind"] = "cpu"
        info["device_count"] = 1
    return info


def run_manifest(config=None, mode: Optional[str] = None,
                 extra: Optional[dict] = None,
                 probe_device: bool = True) -> dict:
    """The provenance record stamped into every artifact this stack emits.

    Keys are stable (tlm compare diffs them field-by-field); ``extra``
    merges caller-specific fields (e.g. bench's winning candidate name).
    ``probe_device=False`` skips the device query entirely (a server's
    metric-history spill stamps its manifest before warmup): the device
    fields are None.
    """
    m = {
        "schema": SCHEMA_VERSION,
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": _git_sha(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
        "mode": mode,
        "config_hash": config_hash(config),
    }
    if probe_device:
        m.update(_device_info())
    else:
        m.update(dict.fromkeys(_DEVICE_KEYS))
    if extra:
        m.update(extra)
    return m


class RunLog:
    """Append-only JSONL event stream for one run.

    ``RunLog(dir_or_file)`` opens ``<dir>/events.jsonl`` (creating the
    directory) or the given ``*.jsonl`` path directly; ``event(kind, ...)``
    appends one timestamped record and flushes (the log must survive a
    crash mid-run — that is half its point).  Thread-safe enough for the
    serving stack: a line-buffered append per event, no shared state.
    """

    def __init__(self, path, manifest: Optional[dict] = None):
        p = Path(path)
        if p.suffix != ".jsonl":
            p.mkdir(parents=True, exist_ok=True)
            p = p / "events.jsonl"
        else:
            p.parent.mkdir(parents=True, exist_ok=True)
        self.path = p
        self._f: Optional[IO[str]] = open(p, "a")
        if manifest is not None:
            self.event("manifest", **manifest)

    # positional-only first parameter: event payloads may legitimately
    # carry a "kind" field of their own (e.g. the trace records' request
    # class) and must not collide with the event name
    def event(self, kind: str, /, **fields) -> dict:
        rec = {"t": round(time.time(), 3), "event": kind}
        rec.update(fields)
        if self._f is not None:
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._f.flush()
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_run(out_dir, mode: str, config=None,
              extra: Optional[dict] = None) -> RunLog:
    """Open ``<out_dir>/events.jsonl`` with the manifest as first record —
    the one-liner every CLI mode calls."""
    return RunLog(out_dir, manifest=run_manifest(config=config, mode=mode,
                                                 extra=extra))


# The process's active run log, set by the CLI entry point so library
# subsystems (watchdogs, the training loop) can attach events without
# threading a RunLog through every signature.  None outside a CLI run —
# callers must treat it as optional.
_current: Optional[RunLog] = None


def set_current(log: Optional[RunLog]) -> None:
    global _current
    _current = log


def current() -> Optional[RunLog]:
    return _current


def read_events(path) -> list:
    """Parse a run log (dir or .jsonl file) tolerantly: partial trailing
    lines from a crash mid-append are dropped, not fatal."""
    p = Path(path)
    if p.is_dir():
        p = p / "events.jsonl"
    records = []
    if not p.exists():
        return records
    for ln in p.read_text().splitlines():
        if not ln.strip():
            continue
        try:
            records.append(json.loads(ln))
        except json.JSONDecodeError:
            pass
    return records
