"""AOT engine cache: what a replica's boot can load instead of building.

The port's counterpart of the JAX package's ``serving/aot_cache.py``.  The
JAX cache serializes compiled XLA executables; the port has no such
object.  A "compile" of the port's engine is a CUDA graph capture
(``serving/engine.py``), and neither a CUDA graph nor cuDNN's benchmark
choices (made in the capture's eager warm-up, per process and per thread)
can be written to disk.  What a boot can load is:

* **the kernel objects** (``_build.py``'s libraries: the CUDA kernels for
  ``sm_90a`` and the host PNG codec) in ``<root>/kernels/<digest>/``,
  keyed by the digest of their sources and flags as ``build/`` is.  A
  process that attaches the cache builds into and loads from there
  (``_build.use_root``, under the build directory's file lock), so the
  first replica of a directory builds them and every later one, from any
  checkout of the same sources, loads them and runs no compiler.  Objects
  of another digest sit in another directory and are never loaded.
* **per key, an entry**: the key, a seeded probe input (its seed) and the
  sha256 of the key's captured output on that input, as the replica that
  wrote the entry computed it.  The capture still runs on every boot; the
  entry is what proves that this boot's graph computes the writer's bits.

A **hit**: the directory's identity matches, the key's entry is readable,
this process ran no compiler, and this replica's captured output on the
probe is bitwise the writer's.  Everything else is a **miss**, logged with
a warning and counted; the key is built and captured exactly as without a
cache, so a stale or corrupt cache may cost time and never changes a
result.  Keys with nothing captured (``szero``, ``scommit``, ``spoison``:
eager writes of the slot pool) have no probe; their entry holds a null
digest and hits on identity alone.

Layout (the JAX package's, with a ``kernels/`` directory)::

    <root>/<config_hash>-<device>-<torch_version>/
        manifest.json                    identity + the warmup grid
        pair-432x1024-b4-<policyhash>.bin   one JSON entry per engine key
    <root>/kernels/<digest>/*.so         the kernel objects

Invalidation is whole-directory: every identity field of the manifest
(config hash, GPU name and compute capability, torch, the CUDA runtime,
cuDNN, the kernels' source digest, the weights' digest, the manifest
version) must match the running process, or the directory is cold: every
key misses and its entries are written anew.  The weights are part of
the identity because a probe's output depends on them (the JAX
package's executables do not); a replica that reloads weights in place
keeps the identity it booted with, as its entries do.
Entries and objects are written to a temporary name and renamed, so
replicas sharing a directory never read half a file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_log = logging.getLogger("raft_tpu_torch.serving.aot_cache")

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"
KERNELS_DIR = "kernels"

# The engine's graph-cache key, in order (the JAX package's tuple, which
# lint/budget.enumerate_warmup_grid emits).
KEY_FIELDS = ("kind", "h", "w", "b", "policy")


def _slug(text: str) -> str:
    """Filesystem-safe token (GPU names have spaces)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", str(text)).strip("_") or "unknown"


def weights_digest(model) -> str:
    """sha256 over a model's state: each tensor's name, dtype, shape and
    bytes, in ``state_dict`` order."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(digest_outputs(t).encode())
    return h.hexdigest()


def cache_identity(config, model, cudnn: str = "benchmark") -> dict:
    """The (config, weights, toolchain, device, kernel sources, cuDNN's
    algorithm choice) identity a cache directory is valid for, ``model``
    on the device it serves from, ``cudnn`` the engine's
    ``ServeConfig.cudnn``.  Every field must match exactly at load
    time."""
    from .. import _build
    from ..telemetry.events import config_hash
    device = next(model.parameters()).device
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        capability = list(torch.cuda.get_device_capability(device))
    else:
        name, capability = device.type, None
    return {
        "config_hash": config_hash(config),
        "device_name": name,
        "capability": capability,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cudnn_version": torch.backends.cudnn.version(),
        "kernel_digest": _build._digest(),
        "weights_digest": weights_digest(model),
        "cudnn": cudnn,
    }


def key_filename(key) -> str:
    """Deterministic per-key entry name: ``pair-432x1024-b4-<8hex>.bin``
    (the JAX package's: the policy, free-form text, is hashed)."""
    kind, h, w, b, policy = key
    phash = hashlib.sha256(repr(policy).encode()).hexdigest()[:8]
    return f"{_slug(kind)}-{int(h)}x{int(w)}-b{int(b)}-{phash}.bin"


def probe_seed(key) -> int:
    """The seed of a key's probe input (fixed by the key's entry name)."""
    return int(hashlib.sha256(key_filename(key).encode()).hexdigest()[:8], 16)


def probe_rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed % (2 ** 31))


def digest_outputs(out) -> str:
    """sha256 over a call's outputs (a tensor or array, or a tuple of
    them): each one's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for x in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            dt = str(x.dtype)
            x = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
        else:
            x = np.asarray(x)
            dt = str(x.dtype)
        h.update(f"{dt}{list(x.shape)}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    """Counters mirrored to /metrics and /healthz.

    ``loads``  = entries read (the file existed, we tried);
    ``hits``   = keys whose entry held (see the module docstring);
    ``misses`` = every other key of warmup (absent, corrupt, stale
                 directory, a compiler run, or a probe digest that
                 differs);
    ``saves``  = entries written by this process;
    ``mismatches`` = of the misses, probe digests that differ from the
                 writer's (another process captured other bits);
    ``load_seconds`` = per read entry, the seconds to read it and check
                 its probe.
    """
    hits: int = 0
    misses: int = 0
    loads: int = 0
    saves: int = 0
    mismatches: int = 0
    load_seconds: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "loads": self.loads, "saves": self.saves,
                "mismatches": self.mismatches}


class EngineCache:
    """The engine cache of one configuration and one model (its weights
    and its device) in ``root``.

    Not thread-safe by design: the engine checks and writes entries under
    its own lock, at warmup and at a prestage.  Safe across processes:
    every file is renamed into place whole, and the kernel objects are
    built under their directory's file lock."""

    def __init__(self, root, config, model, cudnn: str = "benchmark"):
        self.root = Path(root)
        self.identity = cache_identity(config, model, cudnn)
        sub = (f"{self.identity['config_hash']}-"
               f"{_slug(self.identity['device_name'])}-"
               f"{_slug(self.identity['torch_version'])}")
        self.dir = self.root / sub
        self.kernel_root = self.root / KERNELS_DIR
        self.stats = CacheStats()
        self.kernels = None     # "found" or "built", set by the engine
        self._valid: Optional[bool] = None   # manifest validation memo
        from .. import _build
        self._runs0 = _build.COMPILER_RUNS

    def compiler_runs(self) -> int:
        """Compiler processes this process started since the cache was
        attached (a replica attaches it before anything is built)."""
        from .. import _build
        return _build.COMPILER_RUNS - self._runs0

    # -- identity / manifest ------------------------------------------------

    def validate(self) -> bool:
        """True when the directory's manifest matches this process's
        identity exactly.  Memoized; a missing manifest (a new directory)
        is invalid for loading and fine for saving."""
        if self._valid is None:
            self._valid = self._validate_once()
        return self._valid

    def _validate_once(self) -> bool:
        path = self.dir / MANIFEST_NAME
        try:
            manifest = json.loads(path.read_text())
        except FileNotFoundError:
            _log.warning(f"engine cache: no manifest in {self.dir}; a cold "
                         f"directory, every key is built and written")
            return False
        except Exception as e:                      # corrupt manifest
            _log.warning(f"engine cache: unreadable manifest {path}: {e}; "
                         f"treating directory as cold")
            return False
        if manifest.get("version") != MANIFEST_VERSION:
            _log.warning(f"engine cache: manifest version "
                         f"{manifest.get('version')!r} != {MANIFEST_VERSION}; "
                         f"treating directory as cold")
            return False
        for field, want in self.identity.items():
            got = manifest.get(field)
            if got != want:
                _log.warning(f"engine cache: stale {field} "
                             f"(cache {got!r} != process {want!r}); "
                             f"treating directory as cold")
                return False
        return True

    def write_manifest(self, grid) -> None:
        """Stamp the directory with the identity and the warmup grid (the
        keys a warm directory is expected to hold)."""
        self.dir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "version": MANIFEST_VERSION,
            **self.identity,
            "key_fields": list(KEY_FIELDS),
            "keys": [list(k) for k in grid],
            "entries": [key_filename(k) for k in grid],
            "created_unix": time.time(),
        }
        _write_atomic(self.dir / MANIFEST_NAME,
                      json.dumps(manifest, indent=2, default=str).encode())
        self._valid = True

    # -- entries --------------------------------------------------------------

    def entry(self, key) -> Optional[dict]:
        """The key's entry for checking, or None (counted as a miss, with a
        warning when the file was there but unreadable).  A read counts as
        a load."""
        if not self.validate():
            return None
        path = self.dir / key_filename(key)
        if not path.exists():
            _log.warning(f"engine cache: no entry {path.name}; building")
            return None
        self.stats.loads += 1
        try:
            entry = json.loads(path.read_text())
            if [str(v) for v in entry["key"]] != [str(v) for v in key]:
                raise ValueError(f"entry holds key {entry['key']}")
            int(entry["seed"])
            digest = entry["digest"]
            if digest is not None and not isinstance(digest, str):
                raise ValueError("digest is not a string")
        except Exception as e:
            _log.warning(f"engine cache: corrupt entry {path.name} "
                         f"({type(e).__name__}: {e}); building")
            return {"corrupt": True}
        return entry

    def judge(self, key, entry: Optional[dict], digest: Optional[str],
              seconds: float) -> bool:
        """Count the key as a hit or a miss; True on a hit.  ``entry`` is
        :meth:`entry`'s answer, ``digest`` this process's probe digest,
        ``seconds`` what reading and probing the entry took."""
        if entry is not None and not entry.get("corrupt"):
            self.stats.load_seconds.append(seconds)
        hit = False
        compiler_runs = self.compiler_runs()
        if entry is None or entry.get("corrupt"):
            pass
        elif compiler_runs:
            _log.warning(f"engine cache: {key_filename(key)}: this process "
                         f"ran the compiler {compiler_runs} time(s); a miss")
        elif entry["digest"] != digest:
            self.stats.mismatches += 1
            _log.warning(f"engine cache: {key_filename(key)}: the probe's "
                         f"output differs from the writer's (sha256 "
                         f"{str(digest)[:12]} != {str(entry['digest'])[:12]});"
                         f" a miss")
        else:
            hit = True
        if hit:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        return hit

    def save(self, key, seed: int, digest: Optional[str],
             overwrite: bool = False) -> bool:
        """Write ``key``'s entry (atomic rename).  An existing entry is
        left alone unless ``overwrite`` (a cold or corrupt one).  Returns
        True when an entry exists on disk afterwards."""
        path = self.dir / key_filename(key)
        if path.exists() and not overwrite:
            return True
        entry = {"key": list(key), "seed": int(seed), "digest": digest,
                 "pid": os.getpid(), "written_unix": time.time()}
        try:
            _write_atomic(path, json.dumps(entry, default=str).encode())
        except Exception as e:
            _log.warning(f"engine cache: could not write {path.name}: "
                         f"{type(e).__name__}: {e}")
            return False
        self.stats.saves += 1
        return True


def _write_atomic(path: Path, data: bytes) -> None:
    """``data`` to ``path`` through a temporary name and a rename."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)
