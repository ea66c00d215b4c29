"""Weights carried across from the JAX package.

The JAX parameter tree mirrors the PyTorch module paths, so conversion is a
leaf-name and layout map (the port's own copy of the JAX package's
``to_state_dict(torch_layout=True)``):

  ['fnet']['layer1']['0']['conv1']['w'] [kH,kW,I,O] -> 'fnet.layer1.0.conv1.weight' [O,I,kH,kW]
  'b' -> 'bias'; 'gamma' -> 'weight'; 'beta' -> 'bias';
  'mean' -> 'running_mean'; 'var' -> 'running_var'

:func:`load_params_npz` reads the JAX package's native checkpoint (the flat
npz that its ``save_params_npz`` writes: '/'-joined keys, HWIO kernels), so
one checkpoint file loads into both packages; :func:`to_jax_params` and
:func:`save_params_npz` write a ``state_dict`` back in that format (what
the serving stack's ``POST /admin/reload`` takes).

:func:`to_jax_train_state` and :func:`from_jax_train_state` do the same
for a whole training state: the named leaves of the JAX package's
``TrainState`` (``step``, ``params/...``, ``bn_state/...`` and the optax
optimizer state ``opt_state/...``, as its ``training/checkpoint.py``
names them) to and from the port's model, optimizer state and step.
Adam's moments and sgd's trace go through the layout map of the weight
they belong to, so a training checkpoint of either package resumes in
the other.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_LEAVES = {"w": "weight", "b": "bias", "gamma": "weight", "beta": "bias",
           "mean": "running_mean", "var": "running_var"}


def _set_path(tree: dict, parts, leaf_name: str, value: np.ndarray) -> None:
    node = tree
    for p in parts:
        node = node.setdefault(p, {})
    node[leaf_name] = value


def from_jax_params(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A JAX parameter tree (nested dicts of arrays) -> a ``state_dict``
    for :class:`raft_tpu_torch.models.raft.RAFT` (float32 CPU tensors)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + [k])
                continue
            if k not in _LEAVES:
                raise ValueError(f"unknown leaf {k!r} at {'.'.join(prefix)}")
            arr = np.asarray(v, dtype=np.float32)
            if k == "w":
                arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            out[".".join(prefix + [_LEAVES[k]])] = torch.tensor(arr)

    walk(params, [])
    return out


def load_params_npz(path) -> Dict[str, dict]:
    """Read a JAX-package params npz into a nested tree of numpy arrays
    (pass it to :func:`from_jax_params`)."""
    params: Dict[str, dict] = {}
    with np.load(path) as data:
        for name in data.files:
            parts = name.split("/")
            _set_path(params, parts[:-1], parts[-1], data[name])
    return params


_BN_LEAVES = {"weight": "gamma", "bias": "beta", "running_mean": "mean",
              "running_var": "var"}


def to_jax_params(state: Mapping) -> Dict[str, dict]:
    """A :class:`raft_tpu_torch.models.raft.RAFT` ``state_dict`` -> the JAX
    parameter tree (nested dicts of float32 numpy arrays), the inverse of
    :func:`from_jax_params`: a module with running statistics is a batch
    norm (gamma, beta, mean, var), any other a conv (w in HWIO, b)."""
    params: Dict[str, dict] = {}
    for name, t in state.items():
        *parts, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if ".".join(parts + ["running_mean"]) in state:
            key = _BN_LEAVES[leaf]
        elif leaf == "weight":
            key, arr = "w", arr.transpose(2, 3, 1, 0)      # OIHW -> HWIO
        elif leaf == "bias":
            key = "b"
        else:
            raise ValueError(f"unknown tensor {name!r}")
        _set_path(params, parts, key, np.ascontiguousarray(arr))
    return params


def save_params_npz(state: Mapping, path) -> None:
    """Write a ``state_dict`` as the native checkpoint npz ('/'-joined
    keys, HWIO kernels) that :func:`load_params_npz` and the JAX package
    read; ``path`` may be a file object."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + [k])
            else:
                flat["/".join(prefix + [k])] = v
    walk(to_jax_params(state), [])
    np.savez(path, **flat)


def _jax_leaves(state_names) -> Dict[str, Tuple[str, bool]]:
    """Each ``state_dict`` name -> (its JAX path, '/'-joined; True for a
    conv kernel, whose layout is OIHW here and HWIO there)."""
    names = set(state_names)
    out = {}
    for name in state_names:
        *parts, leaf = name.split(".")
        if ".".join(parts + ["running_mean"]) in names:
            key, kernel = _BN_LEAVES[leaf], False
        elif leaf == "weight":
            key, kernel = "w", True
        elif leaf == "bias":
            key, kernel = "b", False
        else:
            raise ValueError(f"unknown tensor {name!r}")
        out[name] = ("/".join(parts + [key]), kernel)
    return out


def _to_jax(t: torch.Tensor, kernel: bool) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    return np.array(arr.transpose(2, 3, 1, 0) if kernel else arr, order="C")


def _train_state_leaves(state) -> List[Tuple[str, torch.Tensor, bool]]:
    """(JAX name, the port's tensor, is a conv kernel) for every leaf of a
    :class:`raft_tpu_torch.training.state.TrainState` but ``step``."""
    model = state.model
    layout = _jax_leaves(model.state_dict().keys())
    params = list(model.named_parameters())
    out = [(f"params/{layout[n][0]}", p, layout[n][1]) for n, p in params]
    out += [(f"bn_state/{layout[n][0]}", b, False)
            for n, b in state.bn_state.items()]
    for suffix, leaf in state.opt_state.leaves():
        if isinstance(leaf, list):
            out += [(f"opt_state/{suffix}/{layout[n][0]}", t, layout[n][1])
                    for (n, _), t in zip(params, leaf)]
        else:
            out.append((f"opt_state/{suffix}", leaf, False))
    return out


def to_jax_train_state(state) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` -> the JAX ``TrainState``'s named leaves
    (numpy, on the host): ``step`` int32, float32 weights in JAX's layout
    (HWIO kernels), the optimizer's counts int32 and ``last_finite``
    bool, as the JAX package's ``save_checkpoint`` writes them."""
    named = {"step": np.asarray(state.step, dtype=np.int32)}
    for name, t, kernel in _train_state_leaves(state):
        named[name] = _to_jax(t, kernel)
    return named


def from_jax_train_state(named: Mapping[str, np.ndarray], state):
    """Load a JAX ``TrainState``'s named leaves (a dict of arrays, e.g. a
    training checkpoint's npz) into the port ``TrainState`` ``state`` in
    place, and return it.  The names must be exactly the template's
    (the same model, optimizer and ``skip_nonfinite_updates`` as the run
    that saved them) and each shape its leaf's, else ValueError names the
    leaves that differ."""
    leaves = _train_state_leaves(state)
    want = {"step"} | {name for name, _, _ in leaves}
    have = set(named)
    if have != want:
        raise ValueError(
            f"the state does not match the template: "
            f"missing={sorted(want - have)[:8]} "
            f"extra={sorted(have - want)[:8]} — configs differ from the "
            f"saved run")
    with torch.no_grad():
        for name, t, kernel in leaves:
            arr = np.asarray(named[name])
            if kernel:
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"leaf {name} shape {tuple(arr.shape)} != "
                                 f"template {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))
    state.step = int(np.asarray(named["step"]))
    return state
