"""The train step as a captured CUDA graph.

The port's counterpart of the JAX package's compiled step
(``jax.jit(make_train_step(...), donate_argnums=0)``,
``raft_tpu/training/loop.py``): on a CUDA device :class:`GraphedTrainStep`
captures the eager step's device work (``training/step.py``, its
``compute``: forward, loss, backward and optimizer) once per key into one
``torch.cuda.CUDAGraph`` and replays it on every later call with that key,
so a step costs the host one graph launch instead of a Python issue of
every kernel.  It follows ``models/capture.py``'s rules, for a step:

* **Key.** The model and the batch's field shapes and dtypes; the
  configuration, the recipe (``accum_steps``, ``freeze_bn``,
  ``skip_nonfinite_updates``, the converge policy) and the optimizer are
  the step's own, fixed when it is made.
* **Inputs.** Static device buffers hold ``image1``, ``image2``, ``flow``
  and ``valid``; each call checks the batch's shapes (raising before any
  copy) and copies it in on the current stream, outside the graph.  A
  ``data/pipeline.py::PrefetchLoader`` batch is handed over on that stream
  after its prefetch event (the loader makes the stream wait on it and
  marks the staged tensors used there), so the copy is ordered after the
  prefetch, and the staged buffer, freed by the caller after the call,
  goes back to the allocator only once the stream has passed the copy and
  the replay.
* **Dropout masks.** At ``dropout > 0`` the masks are drawn on the host
  per call from the eager step's seeds (``step.step_masks``) and copied
  into static buffers, so a replay draws what the eager step draws; at
  ``dropout = 0``, the chairs default, nothing is drawn.
* **State in place.** The graph reads and writes the parameters, the
  batch-norm statistics and the optimizer's state where they lie, as
  JAX's donation does; ``state.step`` counts on the host.  An in-place
  load (``restore_checkpoint``, the loop's rollback and resume,
  ``convert.weights.from_jax_train_state``) is read by the next replay.
  When any of those tensors has moved (a leaf replaced, ``model.to``), the
  next call captures anew, so no graph reads freed memory: the check
  compares the ``data_ptr``s kept with the key.
* **Warm-up.** Before a capture one eager step runs on a side stream (so
  cuDNN's benchmark mode picks its forward and backward algorithms and
  every kernel entry is built and loaded outside the capture) on the real
  state, which is copied before it and put back after it: a capture
  changes nothing, and the first call's replay is the call's only step.
* **Switches.** The step holds TF32 off (``step.precision``) at the
  warm-up and the capture; a graph keeps the math it was captured with.
* **Outputs.** The metrics are cloned out of the graph's static outputs.
* **No fallback.** A capture that fails raises; a CUDA step never runs
  eager.  On a CPU model a call raises: the eager step is the CPU's.
* **Memory.** One graph pool per :class:`GraphedTrainStep`.

The bookkeeping (keys, static buffers, the pointer check, the pool, the
fresh outputs) is ``models/capture.py::GraphedForward``'s: the step is one
with the train state as its model, the batch's fields and the flattened
dropout masks as its static arguments, the state's tensors as the
addresses it checks and the put-back after the warm-up.
* **Counters.** The kernel wrappers count launches issued from Python: a
  capture adds two steps' launches (the warm-up's and the captured
  step's), a replay none.
"""

from __future__ import annotations

import torch

from ..config import RAFTConfig, TrainConfig
from ..models.capture import GraphedForward
from .optim import Optimizer
from .state import TrainState
from .step import Batch, checked_batch, make_train_step, step_masks


def state_tensors(state: TrainState) -> list:
    """Every tensor a step reads and updates in place: the parameters, the
    buffers (the batch-norm statistics) and the optimizer's leaves."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    for _, leaf in state.opt_state.leaves():
        out += leaf if isinstance(leaf, list) else [leaf]
    return out


def _flat(masks) -> tuple:
    """One step's masks (:func:`step_masks`) as one tuple of tensors."""
    return tuple(t for m in masks if m is not None for t in m)


class GraphedTrainStep(GraphedForward):
    """``step(state, batch, seed) -> (state, metrics)``, the eager step's
    signature and semantics, as graph replays on CUDA (the module
    docstring).  ``axis`` and ``spatial``: the eager step's
    (``step.make_train_step``), a data-parallel or row-sharded step whose
    collectives (NCCL's) are recorded in the graph: the warm-up's eager
    step issues each communicator's first collective, and each peer
    pair's first point-to-point exchange, before the capture (NCCL sets
    them up lazily).  ``eager`` is the eager step it captures; ``captures``
    counts the captures so far, ``recaptures`` those of them that replaced
    a held key's graph (its storage had moved)."""

    def __init__(self, config: RAFTConfig, tconfig: TrainConfig,
                 tx: Optimizer, axis=None, spatial=None):
        self.config = config
        self.accum = accum = tconfig.accum_steps
        self.eager = make_train_step(config, tconfig, tx, axis=axis,
                                     spatial=spatial)
        per = len(_flat(step_masks(config, accum, accum, 0))) // accum
        compute = self.eager.compute

        def run(state: TrainState, *inputs) -> dict:
            masks = [tuple(inputs[4 + k * per:4 + (k + 1) * per]) or None
                     for k in range(accum)]
            return compute(state, Batch(*inputs[:4]), masks)

        super().__init__(run, _check, (None,) * (4 + accum * per),
                         lambda *args: args, module_of=lambda s: s.model,
                         pointers=lambda s: tuple(
                             t.data_ptr() for t in state_tensors(s)),
                         put_back=_put_back)

    def __call__(self, state: TrainState, batch, seed: int = 0):
        batch = checked_batch(Batch(*batch), self.accum)
        masks = self.eager.masks(batch.image1.shape[0], seed)
        metrics = super().__call__(state, *batch, *_flat(masks))
        state.step += 1
        return state, metrics


def _check(state: TrainState) -> None:
    _check_device(state.params[0].device)


def _check_device(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"a captured train step runs on CUDA, the model is "
                         f"on {dev}: use make_train_step on the CPU")


def _put_back(state: TrainState):
    """Copy the state before a capture's warm-up; returns the function
    that puts the copy back after it, so a capture changes nothing."""
    tensors = state_tensors(state)
    with torch.no_grad():
        snapshot = [t.detach().clone() for t in tensors]

    def put_back():
        with torch.no_grad():
            for t, s in zip(tensors, snapshot):
                t.copy_(s)
    return put_back
