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

Every other checkpoint format the JAX package reads loads here too, into
the same JAX-style tree of numpy arrays (the port's copy of the JAX
package's ``convert/weights.py``): :func:`from_torch_state_dict` (the
official PyTorch ``state_dict``, OIHW kernels, with or without the
``module.`` prefix), :func:`from_reference_npz` (the reference's
tensorpack names, HWIO kernels), :func:`from_train_checkpoint` (a training
checkpoint's ``params/`` and ``bn_state/`` leaves) and the native npz;
:func:`detect_format` tells them apart and :func:`load_checkpoint_auto`
dispatches.  :func:`to_reference_npz` and :func:`to_state_dict` write the
reference's and the official naming back.

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

_TORCH_NORM_LEAVES = {
    "weight": "gamma", "bias": "beta",
    "running_mean": "mean", "running_var": "var",
}
_TP_LEAVES = {
    "W": "w", "b": "b", "gamma": "gamma", "beta": "beta",
    "mean/EMA": "mean", "variance/EMA": "var",
}
# the inverse, derived so that import and export cannot diverge
_TP_LEAVES_INV = {v: k for k, v in _TP_LEAVES.items()}
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


# -- the other checkpoint formats (the JAX package's convert/weights.py) ----

def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def from_torch_state_dict(state_dict: Mapping, swap_input_channels: bool = False,
                          strict: bool = True) -> Dict[str, dict]:
    """An official-naming torch ``state_dict`` (tensors or arrays) -> a
    JAX-style params tree: with or without the DataParallel ``module.``
    prefix, ``num_batches_tracked`` dropped, conv kernels OIHW -> HWIO, the
    official checkpoint's shortcut-norm aliases folded
    (:func:`_drop_aliased_norms`).  ``strict`` rejects a name it cannot
    place."""
    params: Dict[str, dict] = {}
    skipped = []
    for name, value in state_dict.items():
        arr = _numpy(value)
        if name.startswith("module."):
            name = name[len("module."):]
        parts = name.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        if arr.ndim == 4 and leaf == "weight":            # conv kernel
            _set_path(params, parts[:-1], "w", arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 1:          # norm gamma
            _set_path(params, parts[:-1], "gamma", arr)
        elif leaf == "bias" and arr.ndim == 1:
            # a conv bias or a norm beta: _fix_biases decides by the sibling
            _set_path(params, parts[:-1], "b", arr)
        elif leaf in _TORCH_NORM_LEAVES:
            _set_path(params, parts[:-1], _TORCH_NORM_LEAVES[leaf], arr)
        else:
            skipped.append(name)
    if skipped and strict:
        raise ValueError(f"unrecognized state_dict entries: {skipped}")
    _fix_biases(params)
    _drop_aliased_norms(params)
    if swap_input_channels:
        swap_rgb_bgr(params)
    return params


def _fix_biases(node: dict) -> None:
    """A module with 'gamma' is a norm: its 'b' is its 'beta'."""
    if "gamma" in node and "b" in node and "w" not in node:
        node["beta"] = node.pop("b")
    for v in node.values():
        if isinstance(v, dict):
            _fix_biases(v)


def _drop_aliased_norms(node: dict) -> None:
    """Official checkpoints hold a strided block's shortcut norm twice: as
    an attribute (``norm3`` of a ResidualBlock, ``norm4`` of a
    BottleneckBlock) and as ``downsample.1``.  Keep ``downsample.1`` and
    drop the alias, after checking that the two agree."""
    ds = node.get("downsample")
    if isinstance(ds, dict) and isinstance(ds.get("1"), dict):
        alias = "norm4" if "conv3" in node else "norm3"
        dup = node.get(alias)
        if isinstance(dup, dict):
            canon = ds["1"]
            for k, v in dup.items():
                if k not in canon or not np.array_equal(np.asarray(v),
                                                        np.asarray(canon[k])):
                    raise ValueError(
                        f"shortcut-norm alias '{alias}' disagrees with "
                        f"downsample.1 on leaf {k!r}")
            del node[alias]
    for v in node.values():
        if isinstance(v, dict):
            _drop_aliased_norms(v)


def swap_rgb_bgr(params: Dict[str, dict]) -> None:
    """In place: reverse the input channels of the stem convs (fnet and
    cnet ``conv1``), so a model trained on RGB takes BGR, or back."""
    for enc in ("fnet", "cnet"):
        w = params[enc]["conv1"]["w"]                     # [kH, kW, 3, C]
        params[enc]["conv1"]["w"] = np.ascontiguousarray(w[:, :, ::-1, :])


def from_reference_npz(path_or_dict, strict: bool = True) -> Dict[str, dict]:
    """A reference-style npz (tensorpack names, ``:0`` suffixes allowed,
    HWIO kernels; a path or a dict) -> a params tree."""
    if isinstance(path_or_dict, (str, bytes)) or hasattr(path_or_dict,
                                                         "__fspath__"):
        with np.load(path_or_dict) as data:
            data = {n: data[n] for n in data.files}
    else:
        data = dict(path_or_dict)
    params: Dict[str, dict] = {}
    skipped = []
    for name, arr in data.items():
        name = name.removesuffix(":0")
        parts = name.split("/")
        if len(parts) >= 2 and parts[-1] == "EMA":       # mean/EMA, variance/EMA
            leaf_key, parts = "/".join(parts[-2:]), parts[:-2]
        else:
            leaf_key, parts = parts[-1], parts[:-1]
        if leaf_key not in _TP_LEAVES:
            skipped.append(name)
            continue
        _set_path(params, parts, _TP_LEAVES[leaf_key], np.asarray(arr))
    if skipped and strict:
        raise ValueError(f"unrecognized npz entries: {skipped}")
    return params


def _flatten_tree(node: Mapping, prefix=()):
    """(path parts, leaf key, value) for every leaf of a params tree."""
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _flatten_tree(v, prefix + (k,))
        else:
            yield prefix, k, v


def to_reference_npz(params: Dict[str, dict], path=None) -> Dict[str, np.ndarray]:
    """A params tree in the reference's tensorpack naming ('/'-joined
    module path, leaves ``W``/``b``/``gamma``/``beta``/``mean/EMA``/
    ``variance/EMA``, HWIO kernels), the inverse of
    :func:`from_reference_npz`.  Returns the flat dict; also writes it to
    ``path`` when given."""
    flat: Dict[str, np.ndarray] = {}
    for parts, k, v in _flatten_tree(params):
        if k not in _TP_LEAVES_INV:
            raise ValueError(f"unknown leaf {k!r} at {'/'.join(parts)}")
        flat["/".join(parts + (_TP_LEAVES_INV[k],))] = np.asarray(v)
    if path is not None:
        np.savez(path, **flat)
    return flat


def to_state_dict(params: Dict[str, dict], torch_layout: bool = True
                  ) -> Dict[str, np.ndarray]:
    """A params tree as a flat state dict in the official torch naming
    (kernels OIHW unless ``torch_layout=False``), numpy arrays."""
    names = {"b": "bias", "gamma": "weight", "beta": "bias",
             "mean": "running_mean", "var": "running_var"}
    out: Dict[str, np.ndarray] = {}
    for parts, k, v in _flatten_tree(params):
        arr = np.asarray(v)
        if k == "w":
            name, arr = "weight", (arr.transpose(3, 2, 0, 1) if torch_layout
                                   else arr)
        elif k in names:
            name = names[k]
        else:
            raise ValueError(f"unknown leaf {k}")
        out[".".join(parts + (name,))] = arr
    return out


def detect_format(path) -> str:
    """'torch' (.pth/.pt, or an npz of dotted torch names), 'tensorpack'
    (the reference's npz), 'trainstate' (a training checkpoint: ``step``
    and ``params/`` leaves) or 'native' (the params npz).  A positional
    ``leaf_*`` training checkpoint raises: only a training run resumes
    it."""
    spath = str(path)
    if spath.endswith((".pth", ".pt")):
        return "torch"
    with np.load(spath) as data:
        names = list(data.files)
    if "step" in names and any(n.startswith("params/") for n in names):
        return "trainstate"
    if names and all(n.startswith("leaf_") for n in names):
        raise ValueError(
            f"{path} is a positional (pre-path-naming) TrainState "
            f"checkpoint; it can only be restored by the training loop "
            f"(resume), or re-saved by it in the current format")
    if any("." in n and "/" not in n for n in names):
        return "torch"
    leaves = {n.split("/")[-1] for n in names}
    if "W" in leaves or "EMA" in leaves:
        return "tensorpack"
    return "native"


def from_train_checkpoint(path) -> Dict[str, dict]:
    """The inference weights of a training checkpoint (either package's
    path-named TrainState npz): its ``params/`` leaves merged with its
    ``bn_state/`` running statistics."""
    from ..training.state import merge_bn_state
    params: Dict[str, dict] = {}
    bn: Dict[str, dict] = {}
    with np.load(str(path)) as data:
        for name in data.files:
            parts = name.split("/")
            if parts[0] == "params" and len(parts) > 1:
                _set_path(params, parts[1:-1], parts[-1], data[name])
            elif parts[0] == "bn_state" and len(parts) > 1:
                _set_path(bn, parts[1:-1], parts[-1], data[name])
    if not params:
        raise ValueError(f"{path} contains no params/ leaves")
    return merge_bn_state(params, bn)


def load_checkpoint_auto(path) -> Dict[str, dict]:
    """Any supported checkpoint as a params tree: a torch ``.pth``/``.pt``
    (``torch.load(weights_only=True)``, a ``{"model": state_dict}``
    wrapper unwrapped), an npz of torch names, the reference's npz, a
    training checkpoint or the native npz (:func:`detect_format`)."""
    spath = str(path)
    fmt = detect_format(spath)
    if fmt == "trainstate":
        return from_train_checkpoint(spath)
    if fmt == "torch":
        if spath.endswith((".pth", ".pt")):
            sd = torch.load(spath, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
                sd = sd["model"]
            return from_torch_state_dict(sd)
        with np.load(spath) as data:
            return from_torch_state_dict({n: data[n] for n in data.files})
    if fmt == "tensorpack":
        return from_reference_npz(spath)
    return load_params_npz(spath)


def assert_tree_shapes_match(converted: Mapping, expected: Mapping,
                             path: str = "") -> None:
    """Raise naming the first path where the trees' keys or shapes
    differ."""
    ek, ck = set(expected.keys()), set(converted.keys())
    if ek != ck:
        raise ValueError(f"at {path or '<root>'}: keys differ; "
                         f"missing={sorted(ek - ck)} extra={sorted(ck - ek)}")
    for k in expected:
        e, c = expected[k], converted[k]
        if isinstance(e, Mapping):
            assert_tree_shapes_match(c, e, f"{path}{k}.")
        elif tuple(np.shape(c)) != tuple(np.shape(e)):
            raise ValueError(f"at {path}{k}: shape {np.shape(c)} != "
                             f"{np.shape(e)}")
