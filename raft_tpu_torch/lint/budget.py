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
the report.  The kernels' shared-memory and register envelopes, the CUDA
graph pools and the rules stay queued (ROADMAP item 13); the report leaves
the JAX package's TPU VMEM envelopes out.  Like the JAX model, the byte
accounting is a lower bound on what the device holds: cuDNN's workspaces
and the graphs' private pools ride on top.
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
    ``buckets[].pallas`` VMEM envelopes have no counterpart here (ROADMAP
    item 13)."""
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
