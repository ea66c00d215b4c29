"""The inference and streaming functions as captured CUDA graphs.

The port's counterpart of the compiled executable the JAX package runs
(``jax.jit(make_inference_fn(cfg))``, or one loaded by its engine cache):
on a CUDA device, :class:`GraphedForward` captures the eager forward once
per key into a ``torch.cuda.CUDAGraph`` and replays it on every later call
with that key, so one request costs one graph launch on the host instead
of a Python issue of every kernel.

Rules:

* **Key.** The model and the shapes and dtypes of the arguments (one
  compute dtype per :class:`GraphedForward`, the config's): for a pairwise
  entry (model, batch, H, W), a ragged entry's box being its (H, W).
  ``sizes`` is an input of the graph, like the images: one graph serves
  every mix of crops in one box.  An argument read ``BY_ADDRESS`` (a slot
  pool's buffers) joins the key with its ``data_ptr``s: each pool has a
  graph of its own, so pools used in turns replay without capturing
  again.
* **Inputs.** Static device buffers hold the arguments the entry copies
  (images, sizes, slots, active; the solo stream step's maps and seed);
  each call copies the caller's arrays in, outside the graph, so no
  pageable host-to-device copy happens inside a capture.  A by-address
  argument is not copied: the graph reads it where it lies (a buffer that
  moved is another key, captured anew) and holds a reference to it, so it
  is never freed under the graph; a pool's graph lives as long as the
  model.
* **The converge policy.** Its loop exits on data, which a graph cannot.
  It is captured as three graphs per key from the one pool: the prologue
  (the entry's encoders and gathers, the loop's set-up, the initial state
  in static buffers), one masked iteration (updates the state in place and
  writes the device flag all(converged)) and the epilogue (the upsampling
  and the outputs).  A call replays the prologue, then the iteration until
  the flag, read on the host (``raft.converge_iterations``: before the
  first and after each from ``min_iters`` on), is set or ``iters`` ran,
  then the epilogue: the iteration replays number max(iters_used)
  (``step_replays``).  Frozen rows are masked on the device, so the number
  of replays changes the time, never the values.  At capture the
  prologue's graph is replayed once before the iteration's warm-up, which
  so reads a real state.
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
  memory pool, which is safe because the outputs are cloned out, the
  graphs are replayed one at a time, and a converge key's three graphs
  in the order they were captured.
* **Concurrency.** A graph is not re-entrant: replay one at a time per
  :class:`GraphedForward` (serving's locks are not this module's job).
* **The NaN/Inf sentinel.** Each capture runs inside a
  ``telemetry.watchdogs.nan_tally``: with the sentinel on, its guards'
  counts are static outputs of the graph, reported after every replay
  (after each iteration's replay for a converge key); a graph captured
  with it off holds no guard and reports nothing.
* **Counters.** The kernel wrappers count launches issued from Python, so
  a capture adds two forwards' launches (the warm-up's and the captured
  one's; for a converge key two iterations') and a replay adds none.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, NamedTuple, Tuple

import torch

from ..telemetry.watchdogs import nan_tally


class _ByAddress:
    def __repr__(self) -> str:
        return "BY_ADDRESS"


BY_ADDRESS = _ByAddress()     # an argument the graph reads in place


def weight_pointers(model: torch.nn.Module) -> Tuple[int, ...]:
    """The storage address of every parameter and buffer of ``model``."""
    return tuple(t.data_ptr() for t in model.parameters()) + tuple(
        t.data_ptr() for t in model.buffers())


def _tensors(arg) -> tuple:
    """A by-address argument's tensors: a tensor, or a pair of them."""
    return tuple(arg) if isinstance(arg, (tuple, list)) else (arg,)


def as_inputs(args, spec, device) -> tuple:
    """The arguments as device tensors, as the eager forward takes them:
    each copied one as a tensor of its ``spec`` dtype (None: its own) on
    ``device``; a by-address one as it is (it must lie on ``device``)."""
    out = []
    for arg, dtype in zip(args, spec):
        if dtype is BY_ADDRESS:
            for t in _tensors(arg):
                if t.device != device:
                    raise ValueError(f"a buffer is on {t.device}, the model "
                                     f"on {device}")
            out.append(arg)
        else:
            out.append(torch.as_tensor(arg, dtype=dtype, device=device))
    return tuple(out)


def _key(args, spec) -> tuple:
    """The shapes and dtypes of the arguments, and the addresses of the
    by-address ones."""
    key = []
    for arg, dtype in zip(args, spec):
        if dtype is BY_ADDRESS:
            key.append(tuple((tuple(t.shape), t.dtype, t.data_ptr())
                             for t in _tensors(arg)))
        else:
            key.append((tuple(arg.shape),
                        dtype or torch.as_tensor(arg[:0]).dtype))
    return tuple(key)


# Host seconds spent in :func:`capture` by this process: ``warmup`` is the
# eager run's issue on the side stream (on a new shape it holds cuDNN's
# benchmark of every conv's algorithms, which synchronizes), ``capture``
# the recording and instantiation of the graph.  The serving engine reads
# their rise per warmup key.
SECONDS = {"warmup": 0.0, "capture": 0.0}


def capture(fn: Callable[[], object], pool=None, after_warmup=None):
    """Run ``fn()`` once eagerly on a side stream, then capture one call
    into a new ``torch.cuda.CUDAGraph`` drawing on ``pool`` (None: a pool of
    its own).  Returns ``(graph, out)``, ``out`` the static outputs a
    replay writes.  ``after_warmup()``, if given, runs on the side stream
    right after the warm-up (a train step puts back the state its warm-up
    updated).  The capture raises on a host sync or any other call not
    allowed in a capture.  Adds its two parts' seconds to
    :data:`SECONDS`."""
    t0 = time.perf_counter()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
        if after_warmup is not None:
            after_warmup()
    t1 = time.perf_counter()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    SECONDS["warmup"] += t1 - t0
    SECONDS["capture"] += time.perf_counter() - t1
    return graph, out


def capture_tallied(fn: Callable[[], object], pool, **kwargs):
    """:func:`capture` (``kwargs`` passed on) with each run of ``fn``
    inside a ``nan_tally``; returns ``(graph, out, tally)``, the tally the
    captured run filled."""
    tallies = []

    def run():
        with nan_tally() as tally:
            out = fn()
        tallies.append(tally)
        return out

    graph, out = capture(run, pool, **kwargs)
    return graph, out, tallies[-1]


class _Entry(NamedTuple):
    graphs: tuple                  # one graph, or a converge key's three
    pointers: Tuple[int, ...]
    inputs: tuple                  # static buffers, or by-address arguments
    outputs: tuple                 # the forward's result (or a dict)
    carry: object = None           # a converge key's loop state
    tallies: tuple = ()            # each graph's NaN tally


class GraphedForward:
    """``forward(model, *args)`` as graph replays.

    ``eager(model, *args)`` is the eager forward on device tensors,
    returning a tuple of tensors (a ``RAFTOutput``, or a stream step's) or
    a dict of them; ``check(model)`` validates the model (device, dtype)
    before every call; ``validate(*args)`` checks the caller's arguments
    (arrays or tensors) and returns them normalized, raising before any
    copy; ``spec`` gives per argument its dtype on the device (None: its
    own) or ``BY_ADDRESS``.  ``staged``, for a converge policy, is the
    forward's three parts (``raft.Forward``: ``new_carry``, ``begin``,
    ``step``, ``end``, ``iterate``), captured as three graphs.

    ``model`` may be any object that holds a module (a train state):
    ``module_of(model)`` gives the module the graphs are keyed on and whose
    device they run on, ``pointers(model)`` the addresses a graph reads in
    place (default: the module's weights, :func:`weight_pointers`), and
    ``put_back(model)``, if given, is called before each capture and
    returns a function run right after the warm-up (a train step puts
    back the state its warm-up updated).  ``pool`` is the graphs' memory
    pool (None before the first capture); ``recaptures`` counts the
    captures that replaced a held key's graph (its storage had moved)."""

    def __init__(self, eager: Callable, check: Callable, spec: tuple,
                 validate: Callable, staged=None,
                 module_of: Callable = lambda model: model,
                 pointers: Callable = None, put_back: Callable = None):
        self._eager = eager
        self._check = check
        self._spec = spec
        self._validate = validate
        self._staged = staged
        self._module_of = module_of
        self._pointers = pointers or (lambda m: weight_pointers(module_of(m)))
        self._put_back = put_back
        self._graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.pool = None
        self.captures = 0          # keys captured so far
        self.recaptures = 0        # of them, captures of a key whose storage moved
        self.step_replays = 0      # a converge key: iteration replays, last call

    def graph_count(self) -> int:
        """Keys held now, over every live model."""
        return sum(len(v) for v in self._graphs.values())

    def nan_guards(self) -> int:
        """NaN guards captured in the graphs held now (0 when every one
        was captured with the sentinel off)."""
        return sum(len(t.entries) for per_model in self._graphs.values()
                   for entry in per_model.values() for t in entry.tallies)

    def entries(self, model) -> list:
        """The entries held for ``model``'s module, one per key."""
        return list(self._graphs.get(self._module_of(model), {}).values())

    def __call__(self, model, *args):
        self._check(model)
        args = self._validate(*args)
        key = _key(args, self._spec)
        per_model = self._graphs.setdefault(self._module_of(model), {})
        entry = per_model.get(key)
        pointers = self._pointers(model)
        if entry is None or entry.pointers != pointers:
            if entry is not None:
                self.recaptures += 1
                del per_model[key]       # a stale graph goes before capturing
            entry = self._capture(model, pointers, args)
            per_model[key] = entry
        else:
            self._load(entry.inputs, args)
        if self._staged is None:
            entry.graphs[0].replay()
            entry.tallies[0].report()
        else:
            begin, step, end = entry.graphs
            t_begin, t_step, t_end = entry.tallies

            def one_step():
                step.replay()
                t_step.report()
            begin.replay()
            t_begin.report()
            self.step_replays = self._staged.iterate(entry.carry, one_step)
            end.replay()
            t_end.report()
        out = entry.outputs
        if isinstance(out, dict):
            return {k: v.clone() for k, v in out.items()}
        clones = [None if t is None else t.clone() for t in out]
        return type(out)(*clones) if hasattr(out, "_fields") else tuple(clones)

    def _load(self, inputs, args) -> None:
        for buf, arg, dtype in zip(inputs, args, self._spec):
            if dtype is not BY_ADDRESS:
                buf.copy_(torch.as_tensor(arg, dtype=buf.dtype))

    def _capture(self, model, pointers, args) -> _Entry:
        dev = next(self._module_of(model).parameters()).device
        inputs = []
        for arg, dtype in zip(args, self._spec):
            if dtype is BY_ADDRESS:
                inputs.append(arg)
            else:
                t = torch.as_tensor(arg[:0], dtype=dtype)
                inputs.append(torch.empty(tuple(arg.shape), dtype=t.dtype,
                                          device=dev))
        self._load(inputs, args)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        pool, staged = self.pool, self._staged
        with torch.cuda.device(dev):
            if staged is None:
                kwargs = ({} if self._put_back is None else
                          {"after_warmup": self._put_back(model)})
                graph, out, tally = capture_tallied(
                    lambda: self._eager(model, *inputs), pool, **kwargs)
                graphs, carry, tallies = (graph,), None, (tally,)
            else:
                carry = staged.new_carry()
                begin, _, t_begin = capture_tallied(
                    lambda: staged.begin(carry, model, *inputs), pool)
                begin.replay()           # the state the iteration's warm-up reads
                step, _, t_step = capture_tallied(
                    lambda: staged.step(carry, model), pool)
                end, out, t_end = capture_tallied(lambda: staged.end(carry),
                                                   pool)
                graphs, tallies = (begin, step, end), (t_begin, t_step, t_end)
        self.captures += 1
        return _Entry(graphs, pointers, tuple(inputs), out if isinstance(
            out, dict) or hasattr(out, "_fields") else tuple(out), carry,
            tallies)
