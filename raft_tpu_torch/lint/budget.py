"""The serving engine's compile surface as a value.

The port's copy of ``resolved_policy`` and ``enumerate_warmup_grid`` from
the JAX package's ``lint/budget.py``: the exact ``(kind, h, w, b, policy)``
key list the engine's ``warmup()`` builds, which it consumes, so the grid
the analyzer reports and the grid a server warms are one list.  In the
port a key's "compile" is the capture of its CUDA graph
(``models/capture.py``); ``szero``, ``scommit`` and ``spoison`` are eager
in-place ops with nothing to capture, and stay keys of the grid.  The
device-memory pricing and the kernels' block planning stay queued
(ROADMAP item 13).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
