"""Weights carried across from the JAX package.

The JAX parameter tree mirrors the PyTorch module paths, so conversion is a
leaf-name and layout map (the port's own copy of the JAX package's
``to_state_dict(torch_layout=True)``):

  ['fnet']['layer1']['0']['conv1']['w'] [kH,kW,I,O] -> 'fnet.layer1.0.conv1.weight' [O,I,kH,kW]
  'b' -> 'bias'; 'gamma' -> 'weight'; 'beta' -> 'bias';
  'mean' -> 'running_mean'; 'var' -> 'running_var'

:func:`load_params_npz` reads the JAX package's native checkpoint (the flat
npz that its ``save_params_npz`` writes: '/'-joined keys, HWIO kernels), so
one checkpoint file loads into both packages.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

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
