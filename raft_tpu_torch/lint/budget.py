"""The serving engine's compile surface as a value.

The port's copy of ``resolved_policy`` and ``enumerate_warmup_grid`` from
the JAX package's ``lint/budget.py``: the exact ``(kind, h, w, b, policy)``
key list the engine's ``warmup()`` builds, which it consumes, so the grid
the analyzer reports and the grid a server warms are one list.  In the
port a key's "compile" is the capture of its CUDA graph
(``models/capture.py``); ``szero``, ``scommit`` and ``spoison`` are eager
in-place ops with nothing to capture, and stay keys of the grid.

:func:`analyze` is the device-memory half of the JAX package's analyzer:
per-key and aggregate footprints (the parameters, each bucket's slot-pool
buffers, the live buffers of each key's call) and the sessions that fit a
device kind's memory.  Where the JAX package abstract-evaluates with
``jax.eval_shape``, the port runs its own factories on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage, no device), so a change to an entry point's signature flows into
the report.  Like the JAX model, that byte accounting is a lower bound on
what the device holds.

Beyond the JAX package's analyzer, for the port's own device:

* the CUDA graph pools (:func:`serving_pool_prices`,
  :func:`train_pool_price`): each captured call's allocations on fake
  tensors followed through the caching allocator's block policy
  (:class:`_PoolSim`), a factory's keys sharing one pool;
* the kernels' launch envelopes (:func:`kernel_envelopes`) in place of the
  JAX package's TPU VMEM envelopes: per entry of ``csrc/corr_lookup.cu``
  and ``csrc/sep_conv_gru.cu`` the shared bytes a block, the threads, the
  registers and the blocks an SM holds, against :data:`H100_LIMITS`.  The
  sources' constants are mirrored here and nowhere else (rule B4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

#: Per-device-kind capacity budgets the analyzer solves against.  "cpu" is
#: the JAX package's nominal planning budget, so one report works on
#: machines without a card; "h100-80gb" is the H100's 80 GiB of HBM3.
DEVICE_BUDGETS: Dict[str, Dict[str, int]] = {
    "h100-80gb": {"hbm_bytes": 80 * 1024**3},
    "cpu": {"hbm_bytes": 8 * 1024**3},
}

#: Engine-cache key: (kind, bucket H, bucket W, padded batch, iters policy).
Key = Tuple[str, int, int, int, str]


def resolved_policy(config, sconfig) -> str:
    """The iteration policy the engine actually serves under: the serving
    tier's declaration overrides the model config (engine.__init__ applies
    the same ``dataclasses.replace``)."""
    if sconfig.iters_policy is not None:
        return sconfig.iters_policy
    return config.iters_policy


def enumerate_warmup_grid(config, sconfig, stream: Optional[bool] = None,
                          chaos: Optional[bool] = None) -> List[Key]:
    """Every engine-cache key ``warmup()`` will build, in insertion order,
    deduplicated — the engine's compile surface as a value.

    ``stream`` defaults to the server's wiring (``max_sessions > 0``);
    ``chaos`` (the ``spoison`` drill executable) to whether a chaos spec is
    armed.  Pass them explicitly to mirror a hand-constructed engine.

    This IS the warmup grid, not a copy of it: ``InferenceEngine.warmup``
    iterates this list.
    """
    if stream is None:
        stream = sconfig.max_sessions > 0
    if chaos is None:
        chaos = sconfig.chaos is not None
    policy = resolved_policy(config, sconfig)
    # ragged mixed-resolution serving (SERVING.md "Ragged serving"): the
    # bucket axis of the grid COLLAPSES to the single max-box arena —
    # per-row live sizes are a runtime argument, so one executable per
    # (kind, batch-step, policy) serves every declared resolution and the
    # compile surface shrinks from O(buckets x steps) to O(steps).
    buckets = ((tuple(sconfig.max_box),)
               if getattr(sconfig, "ragged", False)
               else tuple(tuple(b) for b in sconfig.buckets))
    grid = [(h, w, b, "pair") for (h, w) in buckets
            for b in sconfig.batch_steps]
    if stream:
        # encode covers session open + cold restart; "stream" is the cold
        # batch-1 step; the continuous-batched step + its commit scatter
        # warm at every declared batch width — PLUS width 1 for "scommit"
        # (commit_row always runs at width 1, and under --serve-dp the
        # declared steps are multiples of N, never 1); "szero" builds the
        # pool buffers; "spoison" only exists for chaos drills.
        grid += [(h, w, 1, kind) for (h, w) in buckets
                 for kind in ("encode", "stream", "szero", "scommit")]
        grid += [(h, w, b, kind) for (h, w) in buckets
                 for b in sconfig.batch_steps
                 for kind in ("sbatch", "scommit")]
        if chaos:
            grid += [(h, w, 1, "spoison") for (h, w) in buckets]
    keys: List[Key] = []
    seen = set()
    for (h, w, b, kind) in grid:
        key = (kind, h, w, b, policy)
        if key not in seen:
            seen.add(key)
            keys.append(key)
    return keys


# ---------------------------------------------------------------------------
# The device-memory model (torch imported lazily from here down).
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    """An abstract tensor: its shape and its torch dtype."""
    shape: tuple
    dtype: object


def bytes_of(spec) -> int:
    """Device bytes of one abstract tensor (anything with .shape/.dtype)."""
    n = 1
    for d in spec.shape:
        n *= int(d)
    return n * spec.dtype.itemsize


def _leaves(tree) -> list:
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [] if tree is None else [tree]


def tree_bytes(tree) -> int:
    return sum(bytes_of(leaf) for leaf in _leaves(tree))


def _resolved_config(config, sconfig):
    if sconfig.iters_policy is not None:
        config = dataclasses.replace(config,
                                     iters_policy=sconfig.iters_policy)
    return config


def _meta_model(config):
    """The serving engine's model on the meta device (shapes and dtypes,
    no storage): in the compute dtype, as ``init_raft_torch`` builds it,
    the encoder weights bfloat16 under ``quant='bf16w'``
    (``cast_encoder_weights``)."""
    import torch
    from ..models.raft import RAFT, cast_encoder_weights, compute_dtype
    with torch.device("meta"):
        model = RAFT(config)
    return cast_encoder_weights(model.to(compute_dtype(config)), config).eval()


def param_specs(config) -> Dict[str, Spec]:
    """Shapes and dtypes of everything the served model holds on the
    device (its ``state_dict``: the parameters and the batch-norm
    statistics, which the JAX package's parameter tree holds too)."""
    return {k: Spec(tuple(v.shape), v.dtype)
                for k, v in _meta_model(config).state_dict().items()}


def _spec(t) -> Spec:
    return Spec(tuple(t.shape), t.dtype)


def _specs(out):
    if isinstance(out, (tuple, list)):
        return tuple(_specs(o) for o in out)
    return _spec(out)


def slot_specs(config, h: int, w: int, capacity: int) -> tuple:
    """One bucket's slot-pool buffers, ``serving/session.py::slot_shapes``
    (``[capacity+1, ...]``, the extra row the scratch slot; under
    ``quant='int8'`` the fmap and cnet entries are (int8 values, float32
    scales) pairs)."""
    from ..serving.session import slot_shapes

    def spec(entry):
        if isinstance(entry[0], tuple) and isinstance(entry[0][0], tuple):
            return tuple(spec(e) for e in entry)
        return Spec(tuple(entry[0]), entry[1])
    return tuple(spec(e) for e in slot_shapes(config, capacity, h, w))


def feature_specs(config, h: int, w: int, b: int = 1) -> tuple:
    """(fmap, cnet) of ``b`` frames at (h, w) as ``make_encode_fn``
    returns them."""
    from ..models.raft import compute_dtype
    cdt = compute_dtype(config)
    return (Spec((b, h // 8, w // 8, config.fnet_dim), cdt),
            Spec((b, h // 8, w // 8, config.cnet_dim), cdt))


class _FakeEngine:
    """The serving engine's entry points, run on fake tensors to read the
    shapes of what each key's call returns.  The recurrence is shape-
    invariant, so it runs one iteration under the fixed policy; a converge
    policy's ``iters_used`` [b] int32 is appended as its entries append
    it."""

    def __init__(self, config, ragged: bool):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from ..config import adaptive_iters
        from ..models import raft as rm
        self.adaptive = adaptive_iters(config.iters_policy)
        self.cfg = dataclasses.replace(config, iters=1, iters_policy="fixed")
        self.ragged = ragged
        meta = _meta_model(self.cfg)
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        with self.mode:
            self.model = meta.to_empty(device="cpu")
        cpu = "cpu"
        if ragged:
            self.pair = rm.make_ragged_inference_fn(self.cfg, device=cpu)
            self.stream = rm.make_ragged_stream_step_fn(self.cfg, device=cpu)
            self.sbatch = rm.make_ragged_stream_batch_step_fn(self.cfg,
                                                              device=cpu)
        else:
            self.pair = rm.make_inference_fn(self.cfg, device=cpu)
            self.stream = rm.make_stream_step_fn(self.cfg, device=cpu)
            self.sbatch = rm.make_stream_batch_step_fn(self.cfg, device=cpu)
        self.encode = rm.make_encode_fn(self.cfg, device=cpu)
        self._memo: Dict[tuple, tuple] = {}

    def _iters_used(self, out: tuple, b: int) -> tuple:
        import torch
        return out + ((Spec((b,), torch.int32),) if self.adaptive else ())

    def outputs(self, kind: str, h: int, w: int, b: int, pool) -> tuple:
        """The specs of what ``kind`` returns at batch ``b`` on (h, w)."""
        import torch
        key = (kind, h, w, b)
        if key in self._memo:
            return self._memo[key]

        def t(spec):
            return torch.zeros(spec.shape, dtype=spec.dtype)

        from ..telemetry.watchdogs import suppress_nan_sentinel
        img = Spec((b, h, w, 3), torch.float32)
        sz = (t(Spec((b, 2), torch.int32)) + 8,) if self.ragged else ()
        # the sentinel reads its counts back: fake tensors hold no values
        with self.mode, torch.no_grad(), suppress_nan_sentinel():
            if kind == "pair":
                out = self._iters_used((_spec(self.pair(
                    self.model, t(img), t(img), *sz)),), b)
            elif kind == "encode":
                out = _specs(self.encode(self.model, t(img)))
            elif kind == "stream":
                fs, cs = feature_specs(self.cfg, h, w, b)
                flow = Spec((b, h // 8, w // 8, 2), torch.float32)
                out = self._iters_used(_specs(self.stream(
                    self.model, t(img), t(fs), t(cs), t(flow), *sz)), b)
            elif kind == "sbatch":
                bufs = tuple(tuple(t(s) for s in e) if isinstance(e[0], Spec)
                             else t(e) for e in pool)
                out = self._iters_used(_specs(self.sbatch(
                    self.model, t(img), *bufs,
                    t(Spec((b,), torch.int32)), t(Spec((b,), torch.bool)),
                    *sz)), b)
            else:
                raise ValueError(f"no call to evaluate for kind {kind!r}")
        self._memo[key] = out
        return out


def kind_footprint(engine: _FakeEngine, key: Key, capacity: int) -> dict:
    """Per-key device-memory footprint, mirroring what the port's engine
    passes and gets back for this key.

    ``transient_bytes`` is what one call holds live beyond the residents
    (the parameters and the pool buffers): its non-resident inputs plus
    its outputs, with the buffers it writes in place aliased away.  The
    port's commit and poison write the pool in place on every device
    (``serving/session.py``), so they are priced as donated.  The slot
    indices of the commit and the poison are int64, as ``index_copy_``
    takes them; the batch step's are int32.
    """
    import torch
    kind, h, w, b, _policy = key
    cfg = engine.cfg
    img = Spec((b, h, w, 3), torch.float32)
    flow = Spec((b, h // 8, w // 8, 2), torch.float32)
    pool = slot_specs(cfg, h, w, capacity)
    pool_b = tree_bytes(pool)
    donated: Sequence = ()
    resident = False
    sizes = (Spec((b, 2), torch.int32),) if engine.ragged else ()
    if kind == "pair":
        out = engine.outputs(kind, h, w, b, pool)
        inputs = (img, img) + sizes
    elif kind == "encode":
        out = engine.outputs(kind, h, w, b, pool)
        inputs = (img,)
    elif kind == "stream":
        out = engine.outputs(kind, h, w, b, pool)
        inputs = (img, *feature_specs(cfg, h, w, b), flow) + sizes
    elif kind == "sbatch":
        out = engine.outputs(kind, h, w, b, pool)
        inputs = (img, Spec((b,), torch.int32),
                  Spec((b,), torch.bool)) + sizes
        resident = True
    elif kind == "scommit":
        out = pool                        # the buffers it wrote, in place
        inputs = (Spec((b,), torch.int64), *feature_specs(cfg, h, w, b),
                  flow, Spec((b,), torch.bool))
        resident = True
        donated = pool
    elif kind == "spoison":
        out = (pool[0],)
        inputs = (Spec((b,), torch.int64),)
        resident = True
        donated = (pool[0],)
    elif kind == "szero":
        # allocates the resident pool buffers themselves: nothing transient
        out = pool
        inputs = ()
    else:
        raise ValueError(f"unknown executable kind {kind!r}")
    in_b = tree_bytes(inputs)
    out_b = tree_bytes(out)
    don_b = tree_bytes(donated)
    transient = 0 if kind == "szero" else in_b + max(0, out_b - don_b)
    return {"key": list(key), "input_bytes": in_b, "output_bytes": out_b,
            "donated_bytes": don_b, "transient_bytes": transient,
            "pool_bytes": pool_b if resident or kind == "szero" else 0}


def config_signature(config, sconfig, stream: bool, chaos: bool) -> dict:
    """Every knob that changes the compile surface or the footprint
    model."""
    return {
        "small": config.small,
        "compute_dtype": config.compute_dtype,
        "quant": config.quant,
        "buckets": [list(b) for b in sconfig.buckets],
        "batch_steps": list(sconfig.batch_steps),
        "max_sessions": sconfig.max_sessions,
        "stream": stream,
        "chaos": chaos,
        "policy": resolved_policy(config, sconfig),
        "ragged": bool(getattr(sconfig, "ragged", False)),
    }


def analyze(config, sconfig, device_kind: str = "h100-80gb",
            stream: Optional[bool] = None, chaos: Optional[bool] = None
            ) -> dict:
    """The static capacity report: the warm grid, each key's footprint,
    the resident and peak bytes, and the sessions that fit
    ``device_kind``'s memory (``DEVICE_BUDGETS``).  The JAX package's
    ``buckets[].pallas`` VMEM envelopes are the kernels' Hopper envelopes
    here (:func:`kernel_envelopes`), and the graph pools ride on top
    (:func:`serving_pool_prices`); ``raftlint --budget`` joins all
    three."""
    if device_kind not in DEVICE_BUDGETS:
        raise ValueError(f"unknown device kind {device_kind!r}; "
                         f"options: {sorted(DEVICE_BUDGETS)}")
    budget = DEVICE_BUDGETS[device_kind]
    if stream is None:
        stream = sconfig.max_sessions > 0
    if chaos is None:
        chaos = sconfig.chaos is not None
    rconfig = _resolved_config(config, sconfig)
    ragged = bool(getattr(sconfig, "ragged", False))
    keys = enumerate_warmup_grid(rconfig, sconfig, stream=stream,
                                 chaos=chaos)
    capacity = max(1, sconfig.max_sessions)
    params_b = tree_bytes(param_specs(rconfig))
    engine = _FakeEngine(rconfig, ragged)

    by_kind: Dict[str, int] = {}
    for k in keys:
        by_kind[k[0]] = by_kind.get(k[0], 0) + 1

    buckets = []
    resident = params_b
    peak_transient = 0
    session_row_b = 0
    violations: List[str] = []
    a_buckets = ([tuple(sconfig.max_box)] if ragged
                 else [tuple(b) for b in sconfig.buckets])
    for (bh, bw) in a_buckets:
        pool = slot_specs(rconfig, bh, bw, capacity)
        pool_b = tree_bytes(pool)
        row_b = sum(bytes_of(s) // (capacity + 1) for s in _leaves(pool))
        kinds = [kind_footprint(engine, k, capacity)
                 for k in keys if (k[1], k[2]) == (bh, bw)]
        bucket_peak = max((f["transient_bytes"] for f in kinds), default=0)
        peak_transient = max(peak_transient, bucket_peak)
        if stream:
            resident += pool_b
            session_row_b += row_b
        buckets.append({
            "bucket": [bh, bw],
            "pool_bytes": pool_b if stream else 0,
            "per_session_bytes": row_b if stream else 0,
            "peak_transient_bytes": bucket_peak,
            "kinds": kinds,
        })

    peak = resident + peak_transient
    headroom = budget["hbm_bytes"] - peak
    max_sessions_fit = None
    if stream and session_row_b > 0:
        # resident(S) = params + sum_b (S+1) * row_b; the largest S with
        # resident(S) + peak_transient <= the budget
        free = (budget["hbm_bytes"] - params_b - peak_transient
                - session_row_b)                       # the scratch rows
        max_sessions_fit = max(0, free // session_row_b)
        if sconfig.max_sessions > max_sessions_fit:
            violations.append(
                f"max_sessions={sconfig.max_sessions} does not fit "
                f"{device_kind}: at most {max_sessions_fit} session(s) "
                f"leave room for params + peak call buffers")
    if headroom < 0:
        violations.append(
            f"estimated peak {peak} B exceeds the {device_kind} memory "
            f"budget {budget['hbm_bytes']} B by {-headroom} B")

    return {
        "version": 1,
        "device_kind": device_kind,
        "config_signature": config_signature(rconfig, sconfig, stream,
                                             chaos),
        "grid": {"size": len(keys), "by_kind": by_kind,
                 "keys": [list(k) for k in keys]},
        "params_bytes": params_b,
        "buckets": buckets,
        "totals": {
            "resident_bytes": resident,
            "peak_transient_bytes": peak_transient,
            "peak_bytes": peak,
            "hbm_budget_bytes": budget["hbm_bytes"],
            "headroom_bytes": headroom,
            "per_session_bytes": session_row_b or None,
            "max_sessions_fit": max_sessions_fit,
        },
        "violations": violations,
    }


# ---------------------------------------------------------------------------
# The kernels' launch envelopes (Hopper shared memory, threads, registers).
# ---------------------------------------------------------------------------

#: The H100's per-block and per-SM limits the envelopes are held to
#: (compute capability 9.0): 227 KB of shared memory a block (dynamic and
#: static), 228 KB an SM of which 1 KB is reserved per resident block,
#: allocated in 128-byte units; 65536 registers an SM, allocated per warp
#: in units of 256; 2048 threads and 32 blocks an SM.
H100_LIMITS: Dict[str, int] = {
    "smem_per_block": 227 * 1024,
    "smem_per_sm": 228 * 1024,
    "smem_reserved_per_block": 1024,
    "smem_unit": 128,
    "regs_per_sm": 65536,
    "reg_unit_per_warp": 256,
    "max_regs_per_thread": 255,
    "threads_per_sm": 2048,
    "blocks_per_sm": 32,
}

#: ``csrc/corr_lookup.cu``'s launch constants, mirrored (the one place
#: outside the sources where these figures live; the tests read them back
#: from the source and ``chip_smoke.py`` holds every figure below to the
#: source's own ``corr_lookup_envelope`` query on the card).
CORR_KERNEL = {"kWarps": 8, "kTileH": 8, "kTileW": 8, "kChunk": 128,
               "kRowWords": 40, "kMaxWin": 32, "kMmaMaxWin": 16,
               "launch_bounds_min_blocks": 2}
#: ``csrc/sep_conv_gru.cu``'s, likewise (``sep_conv_gru_envelope``).
GRU_KERNEL = {"kTaps": 5, "kHalo": 4, "BN": 64, "kWarps": 8, "kStages": 3,
              "launch_bounds_min_blocks": 2}
#: the four launches of one GRU call, in ``run``'s order: (MODE, VERT,
#: PASS2, BM) of ``gru_gemm``'s template
GRU_LAUNCHES = ((0, False, False, 128), (1, False, False, 64),
                (0, True, True, 128), (1, True, True, 64))

#: The entries of each kernel (Queue B), for the report and the card's
#: check: (id, entry stem, source).
KERNEL_ENTRIES = (("B1", "corr_lookup", "corr_lookup.cu"),
                  ("B2", "sep_conv_gru", "sep_conv_gru.cu"),
                  ("B3", "corr_window", "corr_lookup.cu"),
                  ("B4", "corr_ragged", "corr_lookup.cu"),
                  ("B5", "corr_packed", "corr_lookup.cu"))


def corr_envelope(bf16: bool, C: int, radius: int,
                  ragged: bool = False) -> dict:
    """The launch envelope ``corr_lookup.cu``'s ``run``/``launch`` give the
    lookup entries (``corr_lookup``, ``corr_window``, ``corr_packed``;
    ``ragged`` the ``corr_ragged`` entry) at ``C`` channels and radius
    ``radius``, with 16-byte aligned maps: the instantiation it launches,
    its dynamic and static shared bytes, threads per block, the blocks
    per SM its ``__launch_bounds__`` asks for and the dynamic bytes it
    opts in to."""
    k = CORR_KERNEL
    n_vec = 8 if bf16 else 4                       # Vec16<T>::kN
    if not (1 <= C <= 512 and radius >= 0 and 2 * radius + 2 <= k["kMaxWin"]):
        raise ValueError(f"no corr_lookup launch for C={C}, radius={radius}")
    vec = C % n_vec == 0
    nv = 4 if not vec else 1 if C <= 32 * n_vec else 2 if C <= 64 * n_vec \
        else 4
    if vec and nv == 4 and n_vec != 4:
        raise ValueError(f"no bfloat16 corr_lookup launch for C={C}")
    mma = vec and 2 * radius + 2 <= k["kMmaMaxWin"]
    tile = k["kTileH"] * k["kTileW"]
    threads = 32 * k["kWarps"]
    staging = 2 * (tile + k["kChunk"]) * k["kRowWords"] * 4
    nwin = (2 * radius + 2) ** 2
    dynamic = staging + tile * nwin * 4 if mma else k["kWarps"] * nwin * 4
    t = "__nv_bfloat16" if bf16 else "float"
    return {
        "instantiation": (f"corr_lookup_kernel<{t}, {str(vec).lower()}, "
                          f"{nv}, {str(ragged).lower()}>"),
        "dynamic_smem": dynamic,
        # s_ix0, s_iy0, s_state (int) and s_fx, s_fy (float), kTile each,
        # then s_box (5 int), the block padded to 16 bytes
        "static_smem": -(-(5 * tile * 4 + 5 * 4) // 16) * 16,
        "threads": threads,
        "launch_bounds_min_blocks": k["launch_bounds_min_blocks"],
        "opt_in_smem": staging + tile * k["kMmaMaxWin"] ** 2 * 4,
        "vec": int(vec), "nv": nv, "mma": int(mma),
    }


def gru_envelopes(bf16: bool) -> List[dict]:
    """The four launches of one ``sep_conv_gru`` call (``sep_conv_gru.cu``'s
    ``run``): each one's instantiation of ``gru_gemm``, its dynamic shared
    bytes (``Gemm<...>::kSmemBytes``), threads and launch bounds."""
    k = GRU_KERNEL
    tf32 = not bf16
    channels, wb = (8, 4) if tf32 else (16, 2)     # Entry<TF32>
    out = []
    for mode, vert, pass2, bm in GRU_LAUNCHES:
        # Gemm<>: the first source is float32 for the q GEMM (r*h) and for
        # the 5x1 pass (h1); a float32 source under the bfloat16 entry is
        # split into 3 bfloat16 pieces (16-word rows and piece planes)
        s0_f32 = mode == 1 or pass2
        k0 = "tf32" if tf32 else ("bf16x3" if s0_f32 else "bf16")
        k1 = "tf32" if tf32 else "bf16"
        aw = max(16 if k0 == "bf16x3" else 8, 16 if k1 == "bf16x3" else 8)
        a_words = (bm + k["kHalo"]) * aw
        b_words = k["kTaps"] * k["BN"] * 4 * wb
        planes = 3 if "bf16x3" in (k0, k1) else 0
        rows = bm + k["kHalo"]
        smem = (k["kStages"] * (a_words + b_words) + planes * rows * 8) * 4
        tio = "__nv_bfloat16" if bf16 else "float"
        out.append({
            "instantiation": (f"gru_gemm<{mode}, {str(vert).lower()}, {tio}, "
                              f"{str(pass2).lower()}, {str(tf32).lower()}, "
                              f"{bm}>"),
            "dynamic_smem": smem, "static_smem": 0,
            "threads": 32 * k["kWarps"],
            "launch_bounds_min_blocks": k["launch_bounds_min_blocks"],
            "bm": bm, "bn": k["BN"], "channels_per_slab": channels,
        })
    return out


def blocks_per_sm(threads: int, smem_bytes: int,
                  regs: Optional[int] = None,
                  limits: Dict[str, int] = H100_LIMITS) -> Tuple[int, str]:
    """The blocks of one kernel an SM holds at once, and what limits them
    (the CUDA occupancy rules: threads, blocks, shared memory with its
    per-block reservation and 128-byte unit, registers allocated per warp
    in 256-register units).  ``regs`` None leaves registers out (the
    compiler's figure is not known without a build)."""
    lim = {"blocks": limits["blocks_per_sm"],
           "threads": limits["threads_per_sm"] // threads}
    unit = limits["smem_unit"]
    per_block = (-(-smem_bytes // unit) * unit
                 + limits["smem_reserved_per_block"])
    lim["shared memory"] = limits["smem_per_sm"] // per_block
    if regs is not None:
        warps = -(-threads // 32)
        per_warp = -(-regs * 32 // limits["reg_unit_per_warp"]) \
            * limits["reg_unit_per_warp"]
        lim["registers"] = (limits["regs_per_sm"] // per_warp) // warps
    which = min(lim, key=lim.get)
    return lim[which], which


def kernel_envelopes(config, regs: Optional[Dict[str, int]] = None,
                     limits: Dict[str, int] = H100_LIMITS) -> dict:
    """Every kernel entry's envelope at ``config``'s shapes (the lookups at
    ``fnet_dim`` channels and ``corr_radius``; the GRU at the full model's
    widths), float32 and bfloat16, each held to ``limits``: the block's
    shared memory within the per-block limit, and the blocks per SM at
    least what ``__launch_bounds__`` asks for.  ``regs`` maps an
    instantiation to its registers per thread (``ptxas``, or the card's
    ``cudaFuncGetAttributes``); without it, ``__launch_bounds__(256, 2)``
    caps a thread at 128 registers, which the check assumes."""
    regs = regs or {}
    rows, violations = [], []
    cap = limits["regs_per_sm"] // (2 * 256)
    for kid, stem, source in KERNEL_ENTRIES:
        for bf16 in (False, True):
            if stem == "sep_conv_gru":
                envs = gru_envelopes(bf16)
            else:
                envs = [corr_envelope(bf16, config.fnet_dim,
                                      config.corr_radius,
                                      ragged=stem == "corr_ragged")]
            for launch, env in enumerate(envs):
                r = regs.get(env["instantiation"])
                smem = env["dynamic_smem"] + env["static_smem"]
                blocks, limiter = blocks_per_sm(
                    env["threads"], smem, r if r is not None else cap,
                    limits)
                row = {"kernel": kid, "entry": f"{stem}_"
                       f"{'bf16' if bf16 else 'f32'}", "source": source,
                       "launch": launch, **env, "block_smem": smem,
                       "registers": r, "blocks_per_sm": blocks,
                       "limited_by": limiter}
                rows.append(row)
                if smem > limits["smem_per_block"]:
                    violations.append(
                        f"{row['entry']} launch {launch}: {smem} B of shared "
                        f"memory a block > {limits['smem_per_block']}")
                if blocks < env["launch_bounds_min_blocks"]:
                    violations.append(
                        f"{row['entry']} launch {launch}: {blocks} block(s) "
                        f"an SM ({limiter}) < the "
                        f"{env['launch_bounds_min_blocks']} its "
                        f"__launch_bounds__ asks for")
    return {"limits": dict(limits), "entries": rows,
            "violations": violations}


# ---------------------------------------------------------------------------
# CUDA graph pools: the memory a capture's private pool keeps.
# ---------------------------------------------------------------------------

# The CUDA caching allocator's sizes (c10/cuda/CUDACachingAllocator.cpp):
# requests round up to 512 B; a block of at most 1 MiB is small and comes
# from 2 MiB segments; a larger one from a 20 MiB segment below 10 MiB,
# else from a segment of its own rounded up to 2 MiB; a free block is split
# when more than 512 B (small) or 1 MiB (large) would be left.
_ALLOC_UNIT = 512
_SMALL_SIZE = 1 << 20
_SMALL_SEGMENT = 2 << 20
_LARGE_SEGMENT = 20 << 20
_MIN_LARGE_ALLOC = 10 << 20
_ROUND_LARGE = 2 << 20


class _PoolSim:
    """The caching allocator's block policy in one graph's private pool:
    best-fit reuse of freed blocks, splitting, merging on free, and the
    segments it reserves (never returned while the pool lives, as a
    graph's pool keeps them).  ``reserved`` is the pool's size."""

    def __init__(self):
        self.reserved = 0
        self.segments: List[list] = []      # [[offset, size, free], ...]

    def alloc(self, nbytes: int) -> tuple:
        size = max(_ALLOC_UNIT, -(-nbytes // _ALLOC_UNIT) * _ALLOC_UNIT)
        small = size <= _SMALL_SIZE
        best = None
        for si, seg in enumerate(self.segments):
            if seg[0] != small:
                continue
            for bi, (_, bsize, free) in enumerate(seg[1]):
                if free and bsize >= size and (best is None
                                               or bsize < best[2]):
                    best = (si, bi, bsize)
        if best is None:
            seg_size = (_SMALL_SEGMENT if small else _LARGE_SEGMENT
                        if size < _MIN_LARGE_ALLOC
                        else -(-size // _ROUND_LARGE) * _ROUND_LARGE)
            self.segments.append([small, [[0, seg_size, True]]])
            self.reserved += seg_size
            best = (len(self.segments) - 1, 0, seg_size)
        si, bi, bsize = best
        blocks = self.segments[si][1]
        offset = blocks[bi][0]
        rest = bsize - size
        if rest >= (_ALLOC_UNIT if small else _SMALL_SIZE + 1):
            blocks[bi] = [offset, size, False]
            blocks.insert(bi + 1, [offset + size, rest, True])
        else:
            blocks[bi][2] = False
        return si, offset

    def free(self, handle: tuple) -> None:
        si, offset = handle
        blocks = self.segments[si][1]
        bi = next(i for i, b in enumerate(blocks) if b[0] == offset)
        blocks[bi][2] = True
        if bi + 1 < len(blocks) and blocks[bi + 1][2]:
            blocks[bi][1] += blocks.pop(bi + 1)[1]
        if bi > 0 and blocks[bi - 1][2]:
            blocks[bi - 1][1] += blocks.pop(bi)[1]


class _PeakBytes:
    """A dispatch mode that follows each storage an op allocates into a
    :class:`_PoolSim` (freed when the storage dies) and keeps the live
    bytes' peak: what a captured call draws from its graph's pool.
    Tensors made before it is entered (the parameters, the residents) are
    not counted; :meth:`keep` leaves what is live at the end allocated in
    the pool, as a graph keeps its static outputs."""

    def __init__(self, pool: Optional[_PoolSim] = None):
        import weakref

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.weak import WeakIdKeyDictionary
        tracker = self
        self.pool = pool if pool is not None else _PoolSim()
        self.live = self.peak = 0
        self._kept = False
        self._seen = WeakIdKeyDictionary()
        self._finalize = weakref.finalize

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                tracker._track(out)
                return out
        self.mode = Mode()

    def _track(self, out) -> None:
        import torch
        from torch.utils._pytree import tree_leaves
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = -(-st.nbytes() // _ALLOC_UNIT) * _ALLOC_UNIT
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalize(st, self._free, n, self.pool.alloc(n))

    def _free(self, n: int, handle: tuple) -> None:
        if self._kept:
            return
        self.live -= n
        self.pool.free(handle)

    def keep(self) -> None:
        self._kept = True


def _priced(fn, pool: Optional[_PoolSim] = None) -> Tuple[int, int]:
    """(peak live bytes, bytes left live) of ``fn()``'s allocations, run
    under the caller's fake-tensor mode, followed in ``pool`` (what is
    left live stays allocated there); the result is dropped after."""
    import gc
    tracker = _PeakBytes(pool)
    with tracker.mode:
        out = fn()
    gc.collect()
    kept = tracker.live
    tracker.keep()
    del out
    gc.collect()
    return tracker.peak, kept


def serving_pool_prices(config, sconfig, stream: Optional[bool] = None
                        ) -> dict:
    """Each captured key's draw on its factory's graph pool, and each
    pool's price, from the engine's factories run on fake tensors: a key's
    ``peak`` (the live bytes its call reaches), ``kept`` (its static
    outputs, which stay in the pool) and ``growth`` (the segments the pool
    reserves for it).  A factory's keys share one pool, captured in the
    grid's order; its ``price`` is the segments the caching allocator's
    block policy (:class:`_PoolSim`) reserves over those captures, its
    ``live_price`` the live bytes' bound without the allocator's rounding
    and fragmentation.  cuDNN's workspaces come out of the pool too and are
    not priced (a fake tensor has no algorithm)."""
    import torch
    if stream is None:
        stream = sconfig.max_sessions > 0
    rconfig = _resolved_config(config, sconfig)
    ragged = bool(getattr(sconfig, "ragged", False))
    keys = enumerate_warmup_grid(rconfig, sconfig, stream=stream,
                                 chaos=False)
    engine = _FakeEngine(rconfig, ragged)      # one fixed iteration
    capacity = max(1, sconfig.max_sessions)
    pools: Dict[str, dict] = {}
    sims: Dict[str, _PoolSim] = {}
    rows = []
    from ..telemetry.watchdogs import suppress_nan_sentinel
    for key in keys:
        kind, h, w, b, _ = key
        if kind not in ("pair", "encode", "stream", "sbatch"):
            continue                      # eager slot-pool writes
        slot = slot_specs(engine.cfg, h, w, capacity)
        with engine.mode, torch.no_grad(), suppress_nan_sentinel():
            if kind not in pools:
                pools[kind] = {"kept": 0, "price": 0, "live_price": 0,
                               "keys": 0}
                sims[kind] = _PoolSim()
            before = sims[kind].reserved
            peak, kept = _priced(_fake_call(engine, kind, h, w, b, slot),
                                 sims[kind])
        pool = pools[kind]
        pool["live_price"] = max(pool["live_price"], pool["kept"] + peak)
        pool["kept"] += kept
        pool["keys"] += 1
        pool["price"] = sims[kind].reserved
        rows.append({"key": list(key), "peak_bytes": peak,
                     "kept_bytes": kept, "pool": kind,
                     "growth_bytes": sims[kind].reserved - before})
    return {"keys": rows, "pools": pools,
            "total_bytes": sum(p["price"] for p in pools.values())}


def _fake_call(engine: "_FakeEngine", kind: str, h: int, w: int, b: int,
               slot):
    """The key's call on fake inputs of its shapes (``_FakeEngine``'s
    calls, without its memo), as a thunk: the inputs (and a batch step's
    slot-pool buffers, which are residents) are made here, before the
    pricing starts."""
    import torch

    def t(spec):
        return torch.zeros(spec.shape, dtype=spec.dtype)
    img = Spec((b, h, w, 3), torch.float32)
    sz = (t(Spec((b, 2), torch.int32)) + 8,) if engine.ragged else ()
    m = engine.model
    if kind == "pair":
        i1, i2 = t(img), t(img)
        return lambda: engine.pair(m, i1, i2, *sz)
    if kind == "encode":
        i1 = t(img)
        return lambda: engine.encode(m, i1)
    if kind == "stream":
        fs, cs = feature_specs(engine.cfg, h, w, b)
        i1, f, c = t(img), t(fs), t(cs)
        flow = t(Spec((b, h // 8, w // 8, 2), torch.float32))
        return lambda: engine.stream(m, i1, f, c, flow, *sz)
    bufs = tuple(tuple(t(s) for s in e) if isinstance(e[0], Spec) else t(e)
                 for e in slot)
    i1, slots = t(img), t(Spec((b,), torch.int32))
    active = t(Spec((b,), torch.bool))
    return lambda: engine.sbatch(m, i1, *bufs, slots, active, *sz)


def train_pool_price(config, tconfig, batch: int, h: int, w: int) -> dict:
    """The captured train step's pool (``training/capture.py``): one
    step's forward (``remat_iters`` as configured), loss, backward and
    optimizer on fake tensors, beyond the model and the optimizer's state
    (which live outside the pool): ``peak_bytes`` its live bytes' peak,
    ``price_bytes`` the segments the allocator's block policy reserves
    for it (:class:`_PoolSim`)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models.raft import RAFT
    from ..training.optim import make_optimizer
    from ..training.state import TrainState
    from ..training.step import Batch, make_train_step
    from ..telemetry.watchdogs import suppress_nan_sentinel
    with torch.device("meta"):
        meta = RAFT(config)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    tx = make_optimizer(tconfig)
    with mode, suppress_nan_sentinel():
        model = meta.to_empty(device="cpu").train()
        state = TrainState.create(model, tx)
        step = make_train_step(config, tconfig, tx)
        data = Batch(torch.zeros(batch, h, w, 3), torch.zeros(batch, h, w, 3),
                     torch.zeros(batch, h, w, 2), torch.ones(batch, h, w))
        masks = [None] * tconfig.accum_steps
        sim = _PoolSim()
        peak, kept = _priced(lambda: step.compute(state, data, masks), sim)
    return {"batch": batch, "image_hw": [h, w], "peak_bytes": peak,
            "kept_bytes": kept, "price_bytes": sim.reserved}
