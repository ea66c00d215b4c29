"""Checkpoint save / resume for the whole training state.

The JAX package's ``training/checkpoint.py``, in its format: one npz whose
leaves are the JAX ``TrainState``'s tree paths (``step``,
``params/fnet/conv1/w`` in HWIO, ``bn_state/...``, and the optax state,
e.g. ``opt_state/inner_state/1/0/mu/...``; see ``convert/weights.py::
to_jax_train_state``), so a checkpoint either package writes restores in
the other.  Writes are atomic: a temporary file in the same directory,
fsync'd, ``os.replace``'d onto the name, then the directory fsync'd.

``restore_checkpoint`` takes a template state (built fresh from the same
configs) and loads into it in place.  The JAX package's compat restore of
checkpoints saved before the optimizer was wrapped in ``apply_if_finite``
(positional ``leaf_00042`` keys, or no wrapper counters) is not ported:
it stays in the JAX package.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ..convert.weights import from_jax_train_state, to_jax_train_state


class DeviceSnapshot:
    """A train state's leaves copied where they live (on the card: device
    copies, enqueued on the step's stream, no host sync) and its step:
    what the step loop hands the checkpoint writer, whose thread turns it
    into host arrays (:func:`host_state`), so the copy to the host and the
    layout conversion stay off the step path."""

    def __init__(self, state):
        from ..convert.weights import _train_state_leaves
        self.step = int(state.step)
        with torch.no_grad():
            self.leaves = [(name, t.detach().clone(), kernel)
                           for name, t, kernel in _train_state_leaves(state)]


def host_state(state) -> dict:
    """A :class:`~raft_tpu_torch.training.state.TrainState` (or its
    :class:`DeviceSnapshot`) as its named numpy leaves (copied to the
    host); a dict of arrays passes through."""
    if isinstance(state, Mapping):
        return dict(state)
    if isinstance(state, DeviceSnapshot):
        from ..convert.weights import _to_jax
        named = {"step": np.asarray(state.step, dtype=np.int32)}
        for name, t, kernel in state.leaves:
            named[name] = _to_jax(t, kernel)
        return named
    return to_jax_train_state(state)


def save_checkpoint(path, state, overwrite: bool = True) -> None:
    """Write ``state`` (a TrainState, or its :func:`host_state`) to one npz,
    atomically and durably: the temporary file is fsync'd before the
    rename and the directory after it."""
    path = Path(path)
    if path.exists() and not overwrite:
        raise FileExistsError(path)
    arrays = host_state(state)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _fsync_dir(dirpath) -> None:
    """Flush a directory entry (the rename) to stable storage; best effort
    where a directory cannot be opened."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def restore_checkpoint(path, template):
    """Load the checkpoint at ``path`` into ``template`` (a TrainState of
    the same configs) in place and return it; ValueError names the leaves
    that differ when the configs do."""
    with np.load(path) as data:
        named = {n: data[n] for n in data.files}
    try:
        return from_jax_train_state(named, template)
    except ValueError as e:
        raise ValueError(f"checkpoint {path}: {e}") from None


def list_checkpoints(ckpt_dir) -> list:
    """Step-numbered checkpoints (ckpt_<step>.npz) in a directory, oldest
    first, as [(step, Path), ...]."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    out = []
    for p in ckpt_dir.glob("ckpt_*.npz"):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The newest step-numbered checkpoint in a directory, or None."""
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def prune_checkpoints(ckpt_dir, keep: int, log_fn=None) -> list:
    """Retention: delete the oldest step-numbered checkpoints beyond the
    newest ``keep`` (call it only after a successful save).  Only
    ``ckpt_<step>.npz`` names are touched.  Returns the deleted paths."""
    if keep < 1:
        raise ValueError(f"keep_checkpoints must be >= 1, got {keep}")
    removed = []
    for _, p in list_checkpoints(ckpt_dir)[:-keep]:
        try:
            p.unlink()
        except OSError:
            continue
        removed.append(p)
        if log_fn is not None:
            log_fn(f"[train] pruned {p} (keeping newest {keep})")
    return removed


def checkpoint_readable(path) -> bool:
    """True when every array in the npz decompresses cleanly (a torn copy,
    a bad disk or a truncated transfer reads False)."""
    try:
        with np.load(path) as data:
            for name in data.files:
                data[name]
        return True
    except Exception:  # noqa: BLE001 — any load failure means unreadable
        return False


def restore_latest_with_fallback(ckpt_dir, template, log_fn=print):
    """Restore the newest *readable* checkpoint into ``template``, skipping
    corrupt or truncated files with a warning.  Returns (state, path), or
    (None, None) when none is readable.  A readable checkpoint that does
    not match the template raises: that is a config divergence, not
    corruption."""
    for _, p in reversed(list_checkpoints(ckpt_dir)):
        if not checkpoint_readable(p):
            log_fn(f"[train] WARNING: checkpoint {p} is corrupt or "
                   f"truncated; skipping it and falling back to the "
                   f"previous one")
            continue
        return restore_checkpoint(p, template), p
    return None, None
