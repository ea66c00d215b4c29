"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``build/raft_tpu_torch/<hash>/`` at
the root of the checkout, keyed by a hash of every source and of the
compiler flags; a file lock keeps concurrent processes from building the
same directory at once.  Nothing is built at import: the first call of a
kernel wrapper on a CUDA tensor builds (or loads) its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "raft_tpu_torch"
SOURCES = ("corr_lookup.cu", "sep_conv_gru.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler on PATH, else under ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor at "
                       "/usr/local/cuda/bin/nvcc): the CUDA kernels of "
                       "raft_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not built yet, all ``nvcc`` processes started
    together; returns ``{source: library path}``.  Raises with the
    compiler's output when a build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {s: out_dir / (Path(s).stem + ".so") for s in sources}
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in sources if not libs[s].exists()]
        if todo:
            nvcc = find_nvcc()
            procs = []
            for s in todo:
                tmp = libs[s].with_suffix(f".so.tmp{os.getpid()}")
                log = open(out_dir / (Path(s).stem + ".log"), "w")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
                procs.append((s, tmp, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            for s, tmp, log, proc in procs:
                rc = proc.wait()
                log.close()
                if rc == 0:
                    os.replace(tmp, libs[s])
                else:
                    failed.append(s)
            if failed:
                logs = "\n".join(
                    (out_dir / (Path(s).stem + ".log")).read_text()
                    for s in failed)
                raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _loaded[source] = lib
    return lib


def build_all() -> float:
    """Build (or find built) and load every kernel; returns the seconds."""
    t0 = time.perf_counter()
    libs = build(SOURCES)
    for s, path in libs.items():
        if s not in _loaded:
            _loaded[s] = ctypes.CDLL(str(path))
    return time.perf_counter() - t0


def compiler_report() -> str:
    """One line per source of the last build from ``ptxas -v``: its kernel
    entries and their register range, then each entry that spills."""
    lines = []
    for s in SOURCES:
        log = build_dir() / (Path(s).stem + ".log")
        if not log.exists():
            continue
        entry, regs, spills = "", [], []
        for ln in log.read_text().splitlines():
            if "Compiling entry" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(f"  spills {m.group(1)} B stores / {m.group(2)} B "
                              f"loads in {entry[:100]}")
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                regs.append(int(m.group(1)))
        if regs:
            lines.append(f"{s}: {len(regs)} entries, {min(regs)}-{max(regs)} "
                         f"registers per thread")
        lines += spills
    return "\n".join(lines)
