"""Build and load the port's CUDA kernels and its host libraries.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The ``csrc/*.cpp`` files are host code (the PNG
and JPEG codecs of ``raft_tpu_torch/imageio.py`` and the DIS optical flow
of ``utils/frame_utils.py``): the host C++
compiler builds them, linked to zlib, with no ``nvcc`` and no GPU (so they
build on the CPU too), at ``-O2`` with floating-point contraction off, so
that every host computes the same floats.  Libraries go to ``build/raft_tpu_torch/<hash>/`` at the root of the
checkout (in a process that attached an AOT engine cache, to the cache's
``kernels/<hash>/``), keyed by a hash of every source and of the compiler
flags; a file lock keeps concurrent processes from building the same
directory at once.  Nothing is built at import: the first call of a kernel
wrapper on a CUDA tensor, or of a host library, builds (or loads) it.
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
CXX_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")
CXX_LIBS = ("-lz",)

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each source's compiler process ran in this process's last build
# that compiled it (the builds of one call run side by side)
BUILD_SECONDS: Dict[str, float] = {}
# compiler processes this process started (nvcc or the host compiler): the
# AOT engine cache calls a warm boot one that ran none
COMPILER_RUNS = 0


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


def find_cxx() -> str:
    """The host C++ compiler on PATH (``g++``, else ``c++``)."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the "
                       "image codec of raft_tpu_torch cannot be built")


def _command(source: str, out: Path) -> list:
    if source.endswith(".cpp"):
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(CSRC / source),
                *CXX_LIBS]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS + CXX_LIBS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh", ".cpp")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def use_root(root) -> None:
    """Build into and load from ``<root>/<hash>/`` from now on in this
    process (the AOT engine cache's ``kernels/`` directory, shared by every
    replica that attaches it; the file lock guards it as it guards
    ``build/``)."""
    global BUILD_ROOT
    BUILD_ROOT = Path(root)


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not built yet, all compiler processes started
    together; returns ``{source: library path}``.  Raises with the
    compiler's output when a build fails."""
    global COMPILER_RUNS
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {s: out_dir / (Path(s).stem + ".so") for s in sources}
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in sources if not libs[s].exists()]
        if todo:
            COMPILER_RUNS += len(todo)
            t0 = time.perf_counter()
            procs = []
            for s in todo:
                tmp = libs[s].with_suffix(f".so.tmp{os.getpid()}")
                cmd = _command(s, tmp)
                log = open(out_dir / (Path(s).stem + ".log"), "w")
                procs.append((s, tmp, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            running = list(procs)
            while running:                 # each compiler's own finish time
                for item in list(running):
                    s, tmp, log, proc = item
                    if proc.poll() is None:
                        continue
                    running.remove(item)
                    log.close()
                    BUILD_SECONDS[s] = time.perf_counter() - t0
                    if proc.returncode == 0:
                        os.replace(tmp, libs[s])
                    else:
                        failed.append(s)
                if running:
                    time.sleep(0.02)
            if failed:
                logs = "\n".join(
                    (out_dir / (Path(s).stem + ".log")).read_text()
                    for s in failed)
                raise RuntimeError(f"the build failed for {failed}:\n{logs}")
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _loaded[source] = lib
    return lib


def build_all(host: Sequence[str] = ()) -> float:
    """Build (or find built) and load every kernel, and the host libraries
    ``host`` names in the same call (their compilers run beside ``nvcc``);
    returns the seconds."""
    t0 = time.perf_counter()
    libs = build(tuple(SOURCES) + tuple(host))
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
