"""Warm inference engine: one captured CUDA graph per declared shape.

The port's counterpart of the JAX package's ``serving/engine.py``.  The
engine-cache key stays ``(kind, bucket H, bucket W, padded batch, iters
policy)``, and ``warmup()`` builds exactly the keys of
``lint/budget.py::enumerate_warmup_grid``.  Where the JAX engine
AOT-compiles each key into an executable, this one calls the key's
factory (``models/raft.py``) once on zero inputs of the key's shapes: on
CUDA that call captures the key's CUDA graph (``models/capture.py``), and
every later call with the key replays it.  So in this package a
"compile" is a **graph capture**: ``compile_misses`` counts serve-time
captures (on CUDA read from the rise of the factories'
``fn.graphs.captures``; on the CPU, where the factories run eager, the
first use of a key that warmup did not build), ``compile_hits`` the device
calls that replayed.  A healthy server keeps ``compile_misses`` at 0.

``szero`` allocates a bucket's slot-pool buffers, ``scommit`` and
``spoison`` write them in place: eager ops with nothing to capture, which
stay keys of the grid.  The pool's buffers are allocated once and never
move — the stream batch step's graphs read them by address.

One device caller at a time: a CUDA graph is not re-entrant, and warmup,
``reload`` and direct callers run beside the batcher thread, so every
device call of the engine (a capture or a replay, the copy of its output
to the host, a commit, a reload's weight copy and, on CUDA, its probe's
move to the device and forward) holds ``_device_lock``, a watched lock
placed in the serving lock hierarchy.  A reload builds and loads its probe
model on the host with no lock held, and runs the probe's device work on
the engine's one probe thread, whose cuDNN choices warmup makes (see
:meth:`InferenceEngine._on_probe_thread`).

``ServeConfig(dp_devices=N)``: each pair call splits its batch over
``cuda:0..N-1`` (``parallel/data_parallel.py::make_dp_eval_fn``, one
replica of the model and of the captured forward a card; on the CPU, N
replicas of the CPU model), and the engine raises when fewer cards exist.
The streaming calls stay on the first device, as in the JAX package.

On CUDA the engine sets ``torch.backends.cudnn.benchmark`` from
``ServeConfig.cudnn`` before it captures anything: a graph keeps the cuDNN
algorithms it was captured with.  "benchmark" (the default) times the
candidates in each process: with TF32 off the heuristic choice of some
motion-encoder convs at batch 4 on 432x1024 is 18-21x slower than the
benchmarked one.  "heuristic" is the same in every process, so another
process's capture replays the same bits (the engine cache's hit); the
smoke-sized servers run it.

With an AOT engine cache attached (``serving/aot_cache.py``,
``ServeConfig(engine_cache_dir=...)``) warmup first takes the kernel
objects from the cache where the build directory lacks them, then, per
key, captures as always and runs the key once more on its seeded probe
input: a hit when the sha256 of that output is the entry's, a miss (the
entry written) otherwise.  ``warmup_loaded`` counts the hits and
``boot`` holds the seconds of each part (kernels, per key the warm-up
with cuDNN's benchmark, the capture and the probe).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import RAFTConfig, adaptive_iters
from ..lint.budget import enumerate_warmup_grid
from ..lint.concurrency import guarded_by
from ..telemetry import spans as tlm_spans
from ..telemetry.log import get_logger
from ..telemetry.watchdogs import RecompileWatch, watched_lock
from .config import ServeConfig
from .session import (SlotPool, buffer_tensors, make_slot_commit_fn,
                      make_slot_poison_fn, slot_shapes, zero_slot_buffers)

_log = get_logger("serve")


class ReloadMismatch(ValueError):
    """New parameters don't match the serving template (a name, a shape or
    a dtype differs, or the probe produced non-finite flow) — the swap is
    rejected and the engine keeps serving the old weights."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class InferenceEngine:
    """(kind, bucket, batch, iters-policy) -> a warm factory call, with
    hit/miss accounting.  ``kind`` is ``"pair"`` (the /v1/flow two-frame
    call), ``"encode"`` (single-frame fnet+cnet — session open / cold
    restart), ``"stream"`` (one-encoder sessionful step, the cold batch-1
    form), or one of the slot-pool family — ``"sbatch"`` (the
    CONTINUOUS-BATCHED stream step: b different sessions advanced in one
    call, gathering cached maps from their pool slots), ``"scommit"``
    (masked in-place write of updated rows into the pool buffers),
    ``"szero"`` (the pool's zeroed buffers, allocated at warmup) and
    ``"spoison"`` (chaos session arm: NaN one slot's fmap row — in the
    grid only when the injector is armed).  With
    ``iters_policy='converge:...'`` (ServeConfig override or model-config
    default) flow-producing calls return (…, iters_used): the early exit
    runs as three graphs per key (``models/capture.py``), so the keys —
    and the warm grid — never change with the data.

    ``model`` is a :class:`~raft_tpu_torch.models.raft.RAFT` on the device
    the engine serves from (CUDA, or the CPU when asked for), in the
    configuration's compute dtype.

    Thread model (SERVING.md "Threading model"): ``_device_lock`` is held
    across every device call and a reload's in-place copy (a reload's
    probe builds its model on the host unlocked; its move to the device and
    its forward run on the engine's probe thread, under the lock on CUDA);
    ``_lock`` guards the key set and the counters.  The slot pool's
    bookkeeping has its own leaf lock."""

    _exec = guarded_by("_lock")
    compile_hits = guarded_by("_lock")
    compile_misses = guarded_by("_lock")
    pair_calls = guarded_by("_lock")
    encode_calls = guarded_by("_lock")
    stream_calls = guarded_by("_lock")
    weight_version = guarded_by("_lock")
    weight_tag = guarded_by("_lock")

    def __init__(self, config: RAFTConfig, model, sconfig: ServeConfig,
                 iters: Optional[int] = None, stream: bool = False,
                 faults=None, pool=None, cache=None):
        from ..models import raft as rm

        # chaos harness (serving/faults.py): injected engine exceptions,
        # latency spikes, and NaN output rows enter HERE — the boundary
        # the rest of the stack must contain.  None (the default) costs
        # one attribute check per device call.
        self.faults = faults
        if sconfig.iters_policy is not None:
            # the serving tier declares its compute policy up front, like
            # its buckets and batch steps; it overrides the model config so
            # warmup captures exactly what serve time replays
            config = dataclasses.replace(config,
                                         iters_policy=sconfig.iters_policy)
        self.config = config
        self.sconfig = sconfig
        self.iters = iters
        self.iters_policy = config.iters_policy
        self.adaptive = adaptive_iters(config.iters_policy)
        # ragged mixed-resolution serving: every flow-producing call takes
        # per-row [b, 2] int32 sizes and runs at the max box, so ONE
        # (kind, b, policy) graph serves every declared bucket
        self.ragged = bool(sconfig.ragged)
        self.max_box = sconfig.max_box
        # quant='bf16w': the encoder weights are stored bfloat16 (in place,
        # once); reload() applies the same cast to what it stages
        self.model = rm.cast_encoder_weights(model, config)
        self.device = next(model.parameters()).device
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            torch.backends.cudnn.benchmark = sconfig.cudnn == "benchmark"
        dev = self.device
        self._replicas = None
        if sconfig.dp_devices > 1:
            from ..parallel.data_parallel import make_dp_eval_fn, replicate
            n = sconfig.dp_devices
            if self._cuda:
                have = torch.cuda.device_count()
                if have < n:
                    raise ValueError(f"dp_devices={n} but only {have} "
                                     f"device(s) visible")
                devices = [torch.device("cuda", i) for i in range(n)]
            else:
                devices = [dev] * n       # one process, n CPU replicas
            self._replicas = replicate(self.model, devices)
            self._fn = make_dp_eval_fn(config, devices, iters=iters,
                                       with_iters=self.adaptive)
            self._factories = list(self._fn.factories)
        else:
            if self.ragged:
                make = (rm.make_ragged_counted_inference_fn if self.adaptive
                        else rm.make_ragged_inference_fn)
            else:
                make = (rm.make_counted_inference_fn if self.adaptive
                        else rm.make_inference_fn)
            self._fn = make(config, iters=iters, device=dev)
            self._factories = [self._fn]
        self.stream = stream
        self.pool = pool                  # session.SlotPool (stream servers)
        if stream:
            if self.pool is None:
                self.pool = SlotPool(max(1, sconfig.max_sessions),
                                     arena=(self.max_box if self.ragged
                                            else None))
            self._encode_fn = rm.make_encode_fn(config, device=dev)
            mk_stream = (rm.make_ragged_stream_step_fn if self.ragged
                         else rm.make_stream_step_fn)
            mk_sbatch = (rm.make_ragged_stream_batch_step_fn if self.ragged
                         else rm.make_stream_batch_step_fn)
            self._stream_fn = mk_stream(config, iters=iters, device=dev)
            self._sbatch_fn = mk_sbatch(config, iters=iters, device=dev)
            self._factories += [self._encode_fn, self._stream_fn,
                                self._sbatch_fn]
            self._scommit_fn = make_slot_commit_fn(quant=config.quant_slots)
            self._spoison_fn = make_slot_poison_fn(quant=config.quant_slots)
        # budget None: a device call under this lock may be a capture
        # (seconds at warmup), and a reload's probe runs a whole forward
        self._device_lock = watched_lock("InferenceEngine._device_lock",
                                         budget_s=None)
        self._lock = watched_lock("InferenceEngine._lock")
        self._probe_exec = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="raft-reload-probe")
        self._exec: Dict[Tuple[str, int, int, int, str], str] = {}
        self.compile_hits = 0
        self.compile_misses = 0
        self.encode_calls = 0     # fnet-pass accounting: 1 per encode call,
        self.stream_calls = 0     # 1 per stream step (the acceptance
        self.pair_calls = 0       # criterion's counters), 2 per pair row
        self.weight_version = 1   # bumped by reload(); healthz reports it
        self.weight_tag = None
        self.warmup_seconds = 0.0
        # the AOT engine cache (serving/aot_cache.EngineCache) or None;
        # each warm key's (probe seed, probe digest), what an export writes
        self.cache = cache
        self._digests: Dict[Tuple[str, int, int, int, str], tuple] = {}
        self.warmup_loaded = 0
        self.boot: dict = {}

    # -- key bookkeeping ---------------------------------------------------

    def _key(self, h: int, w: int, b: int,
             kind: str = "pair") -> Tuple[str, int, int, int, str]:
        """Engine-cache key: the kind and the iteration policy ride along
        with the shape, so a graph can never be reused under a different
        compute policy than it was warmed with."""
        return (kind, h, w, b, self.iters_policy)

    def _pair_models(self):
        """What the pair function takes: the model, or under
        ``dp_devices > 1`` its replicas, one a device."""
        return self.model if self._replicas is None else self._replicas

    def _models(self):
        """Every distinct model the engine serves from (a reload copies
        into each)."""
        seen, out = set(), []
        for m in [self.model] + list(self._replicas or []):
            if id(m) not in seen:
                seen.add(id(m))
                out.append(m)
        return out

    def captures(self) -> int:
        """CUDA graphs captured so far by the engine's factories (0 on the
        CPU, where they run eager)."""
        return sum(f.graphs.captures for f in self._factories
                   if f.graphs is not None)

    def graph_count(self) -> int:
        """Graphs held now over the engine's factories (a converge key
        counts once)."""
        return sum(f.graphs.graph_count() for f in self._factories
                   if f.graphs is not None)

    def _device_call(self, key, call, warm: bool = False):
        """Run ``call()`` under the device lock and account for it:
        ``warm`` registers the key (warmup: neither a hit nor a miss),
        else a capture on CUDA — or, on the CPU, a key warmup did not
        build — is a miss and anything else a hit.  Returns call()'s
        result."""
        with self._device_lock:
            before = self.captures()
            t0 = time.monotonic()
            out = call()
            captured = self.captures() - before
        if captured:
            RecompileWatch.notify(time.monotonic() - t0, captured)
        with self._lock:
            new = key not in self._exec
            self._exec.setdefault(key, key[0])
            if warm:
                return out
            if captured or (new and not self._cuda):
                self.compile_misses += 1
            else:
                self.compile_hits += 1
        return out

    # -- warmup --------------------------------------------------------------

    def _zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _feature_zeros(self, b: int, h: int, w: int):
        """Zero (fmap, cnet) rows of ``b`` frames at (h, w), as
        ``make_encode_fn`` returns them (NHWC, the compute dtype)."""
        from ..models.raft import compute_dtype
        cdt = compute_dtype(self.config)
        return (self._zeros((b, h // 8, w // 8, self.config.fnet_dim), cdt),
                self._zeros((b, h // 8, w // 8, self.config.cnet_dim), cdt))

    def _warm_call(self, kind: str, h: int, w: int, b: int):
        """The key's device work on zero inputs of its shapes."""
        img = np.zeros((b, h, w, 3), np.float32)
        sz = (self._sizes_arg(b, None),) if self.ragged else ()
        if kind == "pair":
            return lambda: self._fn(self._pair_models(), img, img, *sz)
        if kind == "encode":
            return lambda: self._encode_fn(self.model, img)
        if kind == "stream":
            fmap, cnet = self._feature_zeros(b, h, w)
            flow = np.zeros((b, h // 8, w // 8, 2), np.float32)
            return lambda: self._stream_fn(self.model, img, fmap, cnet, flow,
                                           *sz)
        bucket = (h, w)
        if kind == "szero":
            return lambda: self._install_slot_buffers(bucket, zero=False)
        scratch = [self.pool.scratch] * b
        if kind == "sbatch":
            self._ensure_slot_buffers(bucket)
            fbuf, cbuf, flbuf = self.pool.buffers(bucket)
            slots = np.asarray(scratch, np.int32)
            active = np.zeros((b,), bool)
            return lambda: self._sbatch_fn(self.model, img, fbuf, cbuf,
                                           flbuf, slots, active, *sz)
        if kind == "scommit":
            self._ensure_slot_buffers(bucket)
            fmap, cnet = self._feature_zeros(b, h, w)
            seeds = np.zeros((b, h // 8, w // 8, 2), np.float32)
            # every row masked off: each writes back the scratch row's
            # own value, so the pool is unchanged
            return lambda: self._commit(bucket, scratch, fmap, cnet, seeds,
                                        np.zeros((b,), bool))
        assert kind == "spoison", kind
        return lambda: None       # warming a poison would poison the pool

    def _probe_call(self, kind: str, h: int, w: int, b: int, seed: int):
        """The key's device work on its seeded probe input (a replay of its
        graph on CUDA), or None for a kind with nothing captured."""
        from .aot_cache import probe_rng
        from ..models.raft import compute_dtype
        rng = probe_rng(seed)
        img = rng.rand(b, h, w, 3).astype(np.float32)
        sz = (self._sizes_arg(b, None),) if self.ragged else ()
        if kind == "pair":
            img2 = rng.rand(b, h, w, 3).astype(np.float32)
            return lambda: self._fn(self._pair_models(), img, img2, *sz)
        if kind == "encode":
            return lambda: self._encode_fn(self.model, img)
        if kind == "stream":
            cdt = compute_dtype(self.config)
            fmap, cnet = (torch.as_tensor(
                rng.rand(b, h // 8, w // 8, c).astype(np.float32),
                device=self.device).to(cdt)
                for c in (self.config.fnet_dim, self.config.cnet_dim))
            flow = (rng.randn(b, h // 8, w // 8, 2) * 2).astype(np.float32)
            return lambda: self._stream_fn(self.model, img, fmap, cnet, flow,
                                           *sz)
        if kind == "sbatch":
            fbuf, cbuf, flbuf = self.pool.buffers((h, w))
            slots = np.asarray([self.pool.scratch] * b, np.int32)
            active = np.zeros((b,), bool)
            return lambda: self._sbatch_fn(self.model, img, fbuf, cbuf,
                                           flbuf, slots, active, *sz)
        return None               # szero, scommit, spoison: eager writes

    def _prepare_kernels(self) -> None:
        """Before the first capture: with a cache, the kernel objects are
        built into and loaded from its ``kernels/`` directory; then (on
        CUDA, for a configuration that runs the kernels) every kernel is
        loaded, or built, timed apart from the keys."""
        from .. import _build
        t0 = time.monotonic()
        runs0 = _build.COMPILER_RUNS
        if self.cache is not None:
            _build.use_root(self.cache.kernel_root)
        kernels = None
        if self._cuda and "pallas" in (self.config.corr_impl,
                                       self.config.gru_impl):
            _build.build_all()
            kernels = "built" if _build.COMPILER_RUNS > runs0 else "found"
        if self.cache is not None:
            self.cache.kernels = kernels
        self.boot["kernels"] = kernels
        self.boot["kernels_s"] = time.monotonic() - t0
        self.boot["compiler_runs"] = _build.COMPILER_RUNS - runs0

    def _warm_key(self, key, kind: str, h: int, w: int, b: int) -> bool:
        """Build one key (capture it on CUDA) and, with a cache, check it
        against its entry; True on a cache hit."""
        from ..models import capture as capture_mod
        from .aot_cache import digest_outputs, probe_seed
        before = dict(capture_mod.SECONDS)
        t0 = time.monotonic()
        self._device_call(key, self._warm_call(kind, h, w, b), warm=True)
        times = {"key_s": time.monotonic() - t0}
        times.update({f"{k}_s": capture_mod.SECONDS[k] - before[k]
                      for k in before})
        hit = False
        if self.cache is not None:
            t1 = time.monotonic()
            entry = self.cache.entry(key)
            usable = entry is not None and not entry.get("corrupt")
            seed = int(entry["seed"]) if usable else probe_seed(key)
            call = self._probe_call(kind, h, w, b, seed)
            digest = (None if call is None else digest_outputs(
                self._device_call(key, call, warm=True)))
            with self._lock:
                self._digests[key] = (seed, digest)
            hit = self.cache.judge(key, entry, digest,
                                   time.monotonic() - t1)
            if not hit:
                self.cache.save(key, seed, digest,
                                overwrite=not self.cache.validate()
                                or (entry is not None and not usable))
            times["probe_s"] = time.monotonic() - t1
        self.boot.setdefault("keys", []).append(
            {"key": list(key[:4]), "hit": hit, **times})
        return hit

    def warmup(self, verbose: bool = True) -> int:
        """Build every declared key — on CUDA, capture its graph — and
        return the number built.  Warmup calls are neither hits nor misses:
        ``compile_misses`` measures serve-time surprises.  With a cache,
        each key is also checked against its entry (hit or miss, the entry
        written on a miss), and the manifest is written after the grid
        (the kernel objects are built into the cache, if at all, before
        the first key)."""
        t0 = time.monotonic()
        n = 0
        # the grid is enumerated by lint/budget.py and consumed here, so
        # the reported compile surface and the warm one are one list
        grid = enumerate_warmup_grid(self.config, self.sconfig,
                                     stream=self.stream,
                                     chaos=self.faults is not None)
        self._prepare_kernels()
        for (kind, h, w, b, _policy) in grid:
            key = self._key(h, w, b, kind)
            with self._lock:
                if key in self._exec:
                    continue
            loaded = self._warm_key(key, kind, h, w, b)
            n += 1
            with self._lock:
                self.warmup_loaded += int(loaded)
            if verbose:
                verb = "warmed (cache hit)" if loaded else "warmed"
                _log.info(f"{verb} {kind} bucket {h}x{w} batch {b} "
                          f"({time.monotonic() - t0:.1f}s elapsed)")
        if self.cache is not None:
            self.cache.write_manifest(grid)
        probe_key = self._probe_key()
        if self._cuda and probe_key is not None:
            # the probe thread's cuDNN choices, made now: one eager forward
            # of the live weights at the probe's shape
            def warm():
                with self._device_lock:
                    self._eager_finite(self.model, *probe_key)
            t1 = time.monotonic()
            self._on_probe_thread(warm)
            self.boot["probe_thread_s"] = time.monotonic() - t1
        self.warmup_seconds = time.monotonic() - t0
        self.boot["warmup_s"] = self.warmup_seconds
        return n

    def export_cache(self) -> dict:
        """Write every warm key's entry that the attached cache lacks and
        the manifest (the /admin/cache/prestage hook
        the fleet's rolling updater calls before a weight flip: the
        probes are of the graphs, which a reload leaves in place).
        Idempotent; a no-op without a cache."""
        if self.cache is None:
            return {"exported": 0, "entries": 0, "dir": None}
        with self._lock:
            items = sorted(self._digests.items())
        exported = sum(1 for key, (seed, digest) in items
                       if self.cache.save(key, seed, digest))
        grid = enumerate_warmup_grid(self.config, self.sconfig,
                                     stream=self.stream,
                                     chaos=self.faults is not None)
        self.cache.write_manifest(grid)
        return {"exported": exported, "entries": len(items),
                "dir": str(self.cache.dir)}

    # -- the slot pool's buffers ---------------------------------------------

    def _install_slot_buffers(self, bucket: Tuple[int, int],
                              zero: bool) -> None:
        """Allocate the bucket's zeroed pool buffers, or with ``zero``
        zero the installed ones in place (their addresses unchanged).
        Device lock held by the caller."""
        bufs = self.pool.buffers(bucket)
        if bufs is None:
            h, w = self.pool.arena or bucket
            self.pool.install(bucket, zero_slot_buffers(
                slot_shapes(self.config, self.pool.capacity, h, w),
                self.device))
        elif zero:
            for t in buffer_tensors(bufs):
                t.zero_()

    def _ensure_slot_buffers(self, bucket: Tuple[int, int]) -> None:
        """Allocate this bucket's pool buffers on its first stream call
        when warmup did not (a --no-warmup server)."""
        if self.pool.buffers(bucket) is None:
            self.reset_slots(bucket)

    def reset_slots(self, bucket: Tuple[int, int]) -> None:
        """Zero a bucket's pool buffers in place (allocating them on first
        use) — the recovery path after a failed commit, whose rows may be
        torn: the coordinator demotes every session of the bucket right
        after, so no one ever gathers the zeros."""
        h, w = bucket
        self._device_call(self._key(h, w, 1, "szero"),
                          lambda: self._install_slot_buffers(bucket, True))

    @property
    def executables(self) -> int:
        """Keys built (warmed, or first used at serve time)."""
        with self._lock:
            return len(self._exec)

    def keys(self):
        with self._lock:
            return sorted(self._exec)

    # -- zero-downtime weight reload -----------------------------------------

    def weight_info(self) -> dict:
        with self._lock:
            return {"version": self.weight_version, "tag": self.weight_tag}

    def _staged_state(self, params) -> Dict[str, torch.Tensor]:
        """``params``, a ``state_dict`` (``from_jax_params`` of a
        checkpoint), held against the serving template: the same names,
        shapes, and dtypes (float32, the checkpoint's dtype, is cast to the
        template's, as a model loaded from float32 weights is cast once)."""
        template = self.model.state_dict()
        missing = sorted(set(template) - set(params))
        extra = sorted(set(params) - set(template))
        if missing or extra:
            raise ReloadMismatch(
                f"param names differ: serving has {len(template)} tensors, "
                f"pushed {len(params)}; missing {missing[:4]}, unexpected "
                f"{extra[:4]} (layout/naming mismatch)")
        for name, old in template.items():
            new = params[name]
            if (tuple(new.shape) != tuple(old.shape)
                    or new.dtype not in (old.dtype, torch.float32)):
                raise ReloadMismatch(
                    f"tensor {name} differs: serving {old.dtype}"
                    f"{list(old.shape)} vs pushed {new.dtype}"
                    f"{list(new.shape)}")
        return {k: params[k] for k in template}

    def _probe_key(self) -> Optional[Tuple[int, int, int]]:
        """(b, h, w) of the smallest warm pair key, the probe's shape; None
        when no pair key is warm."""
        pair_keys = [k for k in self.keys() if k[0] == "pair"]
        if not pair_keys:
            return None
        _, h, w, b, _ = min(pair_keys, key=lambda k: k[1] * k[2] * k[3])
        return b, h, w

    def _on_probe_thread(self, fn):
        """``fn()`` run on the engine's one probe thread: its result, or its
        exception raised here.  cuDNN keeps its benchmark-mode choices per
        thread, and a reload arrives on a new HTTP handler thread each
        time: there the probe's forward benchmarked every convolution
        anew under the device lock, and a batch waited about 1.7 s for it
        (432x1024, H100 80GB HBM3).  Warmup makes the probe thread's
        choices once."""
        return self._probe_exec.submit(fn).result()

    def _eager_finite(self, model, b: int, h: int, w: int) -> bool:
        """One eager forward of ``model`` on zero frames [b, h, w, 3]:
        whether its flow is finite everywhere."""
        from ..models.raft import raft_forward
        img = self._zeros((b, h, w, 3))
        sizes = (torch.as_tensor(self._sizes_arg(b, None), device=self.device)
                 if self.ragged else None)
        out = raft_forward(model, img, img, self.config, iters=self.iters,
                           sizes=sizes)
        return bool(torch.isfinite(out.flow).all())

    def _probe(self, staged: Dict[str, torch.Tensor]) -> bool:
        """Run the staged weights once, eager, on a separate model at the
        smallest warm pair key's shape; raise ReloadMismatch on non-finite
        flow.  False when no pair key is warm yet (nothing probed).

        The probe model is built and loaded on the host with no lock held,
        so batches go on being served meanwhile.  Its move to the device,
        its inputs and its forward run on the probe thread and, on CUDA,
        take the device lock: they read no graph and no live weight, but
        each allocates device memory or copies to the device, and
        PyTorch's default capture mode rejects such work from another
        thread while a graph is being captured (a serve-time miss captures
        under that lock)."""
        from ..models.raft import RAFT, cast_encoder_weights, compute_dtype
        key = self._probe_key()
        if key is None:
            return False
        probe = RAFT(self.config).eval()
        probe.load_state_dict({k: v.float() for k, v in staged.items()})

        def on_device():
            with (self._device_lock if self._cuda
                  else contextlib.nullcontext()):
                moved = cast_encoder_weights(
                    probe.to(self.device, compute_dtype(self.config)),
                    self.config)
                return self._eager_finite(moved, *key)

        if not self._on_probe_thread(on_device):
            raise ReloadMismatch("probe produced non-finite flow; "
                                 "rejecting swap")
        return True

    def reload(self, params, tag: Optional[str] = None,
               probe: bool = True) -> dict:
        """Swap the serving weights for ``params`` (a ``state_dict``)
        without a capture.
        The new tensors are held against the live model's (names, shapes,
        dtypes; :class:`ReloadMismatch` otherwise, which /admin/reload maps
        to 409, the old weights serving on), probed once on a separate
        eager model, then ``copy_``'d into the live parameters and
        buffers.  The graphs read the weights by address, so the next
        replay computes with the new ones and no key is captured again
        (``models/capture.py``).  Only the copy runs under the device lock
        (a replay never sees half a copy) and, on CUDA, the probe's device
        work (:meth:`_probe` says why); the staging and the probe's host
        build run off the serving path, as in the JAX package's engine.  A
        rejected probe raises before any copy: the old weights go on
        serving."""
        staged = self._staged_state(params)
        probed = probe and self._probe(staged)
        with self._device_lock:
            with torch.no_grad():
                for model in self._models():
                    live = model.state_dict(keep_vars=True)
                    for name, t in live.items():
                        t.copy_(staged[name])
        with self._lock:
            self.weight_version += 1
            self.weight_tag = tag
            info = {"version": self.weight_version, "tag": tag,
                    "probed": probed}
        _log.info(f"reloaded weights in place -> version {info['version']}"
                  f" tag={tag} probed={info['probed']}")
        return info

    # -- the device call -----------------------------------------------------

    def _sizes_arg(self, n: int, sizes) -> np.ndarray:
        """Per-row [n, 2] int32 live-size metadata for a ragged device
        call.  None = every row live on the full max box (direct engine
        callers and padding rows)."""
        if sizes is None:
            h, w = self.max_box
            return np.tile(np.asarray([[h, w]], np.int32), (n, 1))
        return np.asarray(sizes, np.int32)

    def run(self, bucket: Tuple[int, int], im1: np.ndarray,
            im2: np.ndarray, sizes=None):
        """[n, BH, BW, 3] float32 pair -> [n, BH, BW, 2] float32 flow
        (numpy).  ``n`` must be a declared batch step (the batcher pads to
        one).  Under a converge policy returns (flow, iters_used [n]
        int32).  ``sizes`` ([n, 2] int32) are the per-row live extents
        inside the max-box ``bucket`` in ragged mode (None = all rows full
        box); ignored in dense mode."""
        h, w = bucket
        n = im1.shape[0]
        with self._lock:
            self.pair_calls += 1
        if self.faults is not None:
            self.faults.pre_engine_call()
        args = (im1, im2) + ((self._sizes_arg(n, sizes),) if self.ragged
                             else ())
        times = []

        def call():
            # dispatch vs ready: the replay returns once its work is
            # enqueued; the copy to the host is what waits for the device
            times.append(time.monotonic())
            out = self._fn(self._pair_models(), *args)
            times.append(time.monotonic())
            out = ((_host(out[0]), _host(out[1])) if self.adaptive
                   else _host(out))
            times.append(time.monotonic())
            return out
        out = self._device_call(self._key(h, w, n), call)
        tlm_spans.record_device_call("pair", *times)
        if self.adaptive:
            flow, iters_used = out
            if self.faults is not None:
                flow = self.faults.corrupt_rows(flow)
            return flow, iters_used
        if self.faults is not None:
            out = self.faults.corrupt_rows(out)
        return out

    def run_encode(self, bucket: Tuple[int, int], image: np.ndarray):
        """[1, BH, BW, 3] float32 frame -> DEVICE-resident (fmap, cnet)
        maps — one fnet pass (session open / cold-restart half of the
        streaming path).  The outputs stay on the device: they are the
        session cache."""
        h, w = bucket
        with self._lock:
            self.encode_calls += 1
        if self.faults is not None:
            self.faults.pre_engine_call()
        times = []

        def call():
            times.append(time.monotonic())
            out = self._encode_fn(self.model, image)
            times.append(time.monotonic())
            return out
        out = self._device_call(self._key(h, w, image.shape[0], "encode"),
                                call)
        # dispatch only: nothing is pulled to the host
        tlm_spans.record_device_call("encode", times[0], times[1], times[1])
        return out

    def _stream_out(self, out):
        """A stream step's outputs: flow and flow_lr on the host, the
        current maps on the device, iters_used on the host or None."""
        flow, flow_lr, fmap, cnet = out[:4]
        iters_used = _host(out[4]) if self.adaptive else None
        return _host(flow), _host(flow_lr), fmap, cnet, iters_used

    def run_stream(self, bucket: Tuple[int, int], image: np.ndarray,
                   fmap_prev, cnet_prev, flow_init: np.ndarray,
                   sizes=None):
        """One sessionful step: current frame + cached previous maps +
        warm-start seed -> (flow [1,BH,BW,2] np, flow_lr [1,bh,bw,2] np,
        fmap_cur dev, cnet_cur dev, iters_used np or None).  Exactly one
        fnet pass per call.  ``sizes`` as in :meth:`run`."""
        h, w = bucket
        n = image.shape[0]
        with self._lock:
            self.stream_calls += 1
        if self.faults is not None:
            self.faults.pre_engine_call()
        args = (image, fmap_prev, cnet_prev, flow_init) + (
            (self._sizes_arg(n, sizes),) if self.ragged else ())
        times = []

        def call():
            times.append(time.monotonic())
            out = self._stream_fn(self.model, *args)
            times.append(time.monotonic())
            out = self._stream_out(out)
            times.append(time.monotonic())
            return out
        flow, flow_lr, fmap, cnet, iters_used = self._device_call(
            self._key(h, w, n, "stream"), call)
        tlm_spans.record_device_call("stream", *times)
        if self.faults is not None:
            flow = self.faults.corrupt_rows(flow)
        return flow, flow_lr, fmap, cnet, iters_used

    # -- the continuous-batched stream path (slot pool) ----------------------

    def run_stream_batch(self, bucket: Tuple[int, int], images: np.ndarray,
                         slots: np.ndarray, active: np.ndarray,
                         sizes=None):
        """ONE device call advancing ``active.sum()`` different sessions:
        ``images`` [b, BH, BW, 3] (padded to a declared batch step),
        ``slots`` [b] int32 pool rows (padding rows aim at the scratch
        slot), ``active`` [b] bool.  Returns ``(flow [b] np, flow_lr [b]
        np, fmap_rows dev, cnet_rows dev, iters_used [b] np or None)`` —
        the updated map ROWS stay on the device until
        :meth:`commit_stream` writes the finite ones into the pool.
        ``stream_calls`` counts REAL rows."""
        h, w = bucket
        b = images.shape[0]
        self._ensure_slot_buffers(bucket)
        with self._lock:
            self.stream_calls += int(np.asarray(active).sum())
        if self.faults is not None:
            self.faults.pre_engine_call()
        fbuf, cbuf, flbuf = self.pool.buffers(bucket)
        args = (images, fbuf, cbuf, flbuf, np.asarray(slots, np.int32),
                np.asarray(active, bool)) + (
            (self._sizes_arg(b, sizes),) if self.ragged else ())
        times = []

        def call():
            times.append(time.monotonic())
            out = self._sbatch_fn(self.model, *args)
            times.append(time.monotonic())
            out = self._stream_out(out)
            times.append(time.monotonic())
            return out
        flow, flow_lr, fmap_rows, cnet_rows, iters_used = self._device_call(
            self._key(h, w, b, "sbatch"), call)
        tlm_spans.record_device_call("stream", *times)
        if self.faults is not None:
            # chaos must poison a REAL row: padding rows (the suffix, by
            # the coordinator's construction) are discarded before the
            # sentinel, so a roll landing there would silently test
            # nothing
            n_real = int(np.asarray(active).sum())
            flow = np.concatenate(
                [self.faults.corrupt_rows(flow[:n_real]), flow[n_real:]])
        return flow, flow_lr, fmap_rows, cnet_rows, iters_used

    def _commit(self, bucket, slots, fmap_rows, cnet_rows, seeds, mask):
        """The in-place masked write of rows into the pool's buffers.
        Device lock held by the caller."""
        fbuf, cbuf, flbuf = self.pool.buffers(bucket)
        self._scommit_fn(
            fbuf, cbuf, flbuf,
            torch.as_tensor(np.asarray(slots, np.int64), device=self.device),
            fmap_rows, cnet_rows,
            torch.as_tensor(np.asarray(seeds, np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(mask, bool), device=self.device))

    def commit_stream(self, bucket: Tuple[int, int], slots: np.ndarray,
                      fmap_rows, cnet_rows, seeds: np.ndarray,
                      mask: np.ndarray) -> None:
        """Write updated rows into the pool buffers in place (masked:
        padding rows and sentinel-rejected rows write their old value
        back).  A commit that RAISES may leave rows torn, so the bucket's
        buffers are zeroed (in place) before the exception propagates; the
        caller must then demote the bucket's sessions
        (``store.demote_bucket``) so nothing gathers the zeros."""
        h, w = bucket
        b = int(np.asarray(slots).shape[0])
        self._ensure_slot_buffers(bucket)
        t0 = time.monotonic()
        try:
            self._device_call(
                self._key(h, w, b, "scommit"),
                lambda: self._commit(bucket, slots, fmap_rows, cnet_rows,
                                     seeds, mask))
        except Exception:
            self.reset_slots(bucket)
            raise
        # commit is dispatch-only: the rows stay on the device
        t1 = time.monotonic()
        tlm_spans.record_device_call("commit", t0, t1, t1)

    def commit_row(self, bucket: Tuple[int, int], slot: int, fmap, cnet,
                   seed: np.ndarray) -> None:
        """Width-1 commit: install one session's fresh maps + warm-start
        seed into its slot (session open / cold-restart attach)."""
        self.commit_stream(bucket, np.asarray([slot], np.int32),
                           fmap, cnet, seed, np.asarray([True]))

    def poison_slot(self, bucket: Tuple[int, int], slot: int) -> None:
        """Chaos ``session`` arm: NaN one slot's cached fmap row in place
        (drills only — the key is in the grid only when the injector is
        armed)."""
        h, w = bucket
        self._ensure_slot_buffers(bucket)
        fbuf = self.pool.buffers(bucket)[0]
        slots = torch.as_tensor([slot], dtype=torch.int64,
                                device=self.device)
        self._device_call(self._key(h, w, 1, "spoison"),
                          lambda: self._spoison_fn(fbuf, slots))
