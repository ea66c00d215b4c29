"""The fixed-policy inference functions as captured CUDA graphs.

The port's counterpart of the compiled executable the JAX package runs
(``jax.jit(make_inference_fn(cfg))``, or one loaded by its engine cache):
on a CUDA device, :class:`GraphedForward` captures the eager forward once
per key into a ``torch.cuda.CUDAGraph`` and replays it on every later call
with that key, so one request costs one graph launch on the host instead
of a Python issue of every kernel.

Rules:

* **Key.** The model, batch, H and W (one compute dtype per
  :class:`GraphedForward`, the config's); a ragged entry's box is its
  (H, W).  ``sizes`` is an input of the graph, like the
  images: one graph serves every mix of crops in one box.
* **Inputs.** Static device buffers hold image1, image2 (and sizes); each
  call copies the caller's arrays in, outside the graph, so no pageable
  host-to-device copy happens inside a capture.
* **Warm-up.** Before a capture one eager forward with the same key runs on
  a side stream: cuDNN's benchmark mode picks its algorithms, every kernel
  entry the path launches is built and loaded, and lazy module loading
  happens there, not inside the capture.
* **Switches.** The forward sets TF32 off for a float32 config
  (``models/raft.py::tf32_off``) around the warm-up and the capture; a
  graph keeps the math it was captured with, so the switches a caller
  sets later change nothing in a replay.
* **Outputs.** Each call returns fresh tensors (clones of the graph's
  static outputs), as JAX returns fresh arrays: a result the caller holds
  is never overwritten by the next replay.
* **Weights.** A graph reads the parameters and buffers where they lay at
  capture.  An in-place load (``model.load_state_dict(...)`` copies into
  the same storage) is seen by the next replay; when any parameter's or
  buffer's storage has moved (``model.to(...)``, a parameter replaced),
  the next call captures anew, so no graph reads freed memory.  The check
  compares the tuple of ``data_ptr``s kept with the key.  A model that is
  garbage-collected takes its graphs with it.
* **No fallback.** A host sync in the path, a capture error, a kernel that
  does not build or launch: the call raises; it never runs eager on CUDA.
* **Memory.** Every graph of one :class:`GraphedForward` draws on one
  memory pool, which is safe because the outputs are cloned out and the
  graphs are replayed one at a time.
* **Concurrency.** A graph is not re-entrant: replay one at a time per
  :class:`GraphedForward` (serving's locks are not this module's job).
* **Counters.** The kernel wrappers count launches issued from Python, so
  a capture adds two forwards' launches (the warm-up's and the captured
  one's) and a replay adds none.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch


def weight_pointers(model: torch.nn.Module) -> Tuple[int, ...]:
    """The storage address of every parameter and buffer of ``model``."""
    return tuple(t.data_ptr() for t in model.parameters()) + tuple(
        t.data_ptr() for t in model.buffers())


def capture(fn: Callable[[], object], pool=None):
    """Run ``fn()`` once eagerly on a side stream, then capture one call
    into a new ``torch.cuda.CUDAGraph`` drawing on ``pool`` (None: a pool of
    its own).  Returns ``(graph, out)``, ``out`` the static outputs a
    replay writes.  The capture raises on a host sync or any other call
    not allowed in a capture."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    pointers: Tuple[int, ...]
    inputs: Tuple[Optional[torch.Tensor], ...]     # image1, image2, sizes
    outputs: tuple                                  # the forward's result


class GraphedForward:
    """``forward(model, image1, image2, sizes=None)`` as graph replays.

    ``eager(model, image1, image2, sizes)`` is the eager forward on device
    tensors (``sizes`` None for a pairwise entry), returning a
    ``RAFTOutput`` (one config, so one compute dtype); ``check(model)``
    validates the model (device, dtype) before every call.
    Images are [B, H, W, 3] float arrays or tensors, ``sizes`` an integer
    [B, 2] array or tensor, as the eager forward takes them."""

    def __init__(self, eager: Callable, check: Callable, ragged: bool):
        self._eager = eager
        self._check = check
        self._ragged = ragged
        self._graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._pool = None
        self.captures = 0          # graphs captured so far

    def graph_count(self) -> int:
        """Graphs held now, over every live model."""
        return sum(len(v) for v in self._graphs.values())

    def __call__(self, model: torch.nn.Module, image1, image2, sizes=None):
        from .raft import RAFTOutput, check_images, check_sizes
        self._check(model)
        if (sizes is not None) != self._ragged:
            raise ValueError("a ragged entry takes sizes, a pairwise one none")
        B, H, W = check_images(image1, image2)
        if sizes is not None:
            sizes = check_sizes(torch.as_tensor(sizes), B)
        key = (B, H, W)
        per_model = self._graphs.setdefault(model, {})
        entry = per_model.get(key)
        pointers = weight_pointers(model)
        if entry is None or entry.pointers != pointers:
            per_model.pop(key, None)     # a stale graph goes before capturing
            entry = self._capture(model, pointers, image1, image2, sizes)
            per_model[key] = entry
        else:
            self._load(entry.inputs, image1, image2, sizes)
        entry.graph.replay()
        return RAFTOutput(*[None if t is None else t.clone()
                            for t in entry.outputs])

    @staticmethod
    def _load(inputs, image1, image2, sizes) -> None:
        im1, im2, sz = inputs
        im1.copy_(torch.as_tensor(image1, dtype=torch.float32))
        im2.copy_(torch.as_tensor(image2, dtype=torch.float32))
        if sz is not None:
            sz.copy_(sizes)

    def _capture(self, model, pointers, image1, image2, sizes) -> _Entry:
        dev = next(model.parameters()).device
        shape = tuple(torch.as_tensor(image1).shape)
        inputs = (torch.empty(shape, dtype=torch.float32, device=dev),
                  torch.empty(shape, dtype=torch.float32, device=dev),
                  None if sizes is None else
                  torch.empty((shape[0], 2), dtype=torch.int32, device=dev))
        self._load(inputs, image1, image2, sizes)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            graph, out = capture(lambda: self._eager(model, *inputs), self._pool)
        self.captures += 1
        return _Entry(graph, pointers, inputs, tuple(out))
