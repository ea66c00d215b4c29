"""Profiling: the parameter table and count, and FLOP counting.

The port's counterpart of the JAX package's ``utils/profiling.py`` (the
CLI's ``-m flops``).  The census reads a parameter tree the way the JAX
package flattens one (dict keys sorted, ``'/'``-joined paths): a JAX-style
tree of arrays, or a ``RAFT`` module, read through its ``state_dict`` in
the JAX package's names and layouts (``convert.to_jax_params``: every
parameter and every batch-norm statistic), so the table reads row for row
like JAX's.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
call: the products of the convolutions and matrix products, and of the
port's kernel operators through their formulas (``ops/corr_cuda.py``,
``ops/gru_cuda.py``), a multiply-add counted as 2 FLOPs, as XLA counts
it.  The count is the same on the CPU and on the card.  XLA's
``cost_analysis``, which the JAX package reports, also counts elementwise
work, so the two counts are not held to each other.
"""

from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch

FLOPS_NOTE = ("FlopCounterMode: convolutions, matrix products and the "
              "kernels' products, a multiply-add counted as 2 FLOPs; XLA's "
              "count adds elementwise work, so the two are not comparable")


def _leaves(tree, prefix=()):
    """(path, leaf) of every leaf, as ``jax.tree_util`` flattens: dict
    keys sorted, sequence items by ``[i]``, None empty."""
    if tree is None:
        return
    if isinstance(tree, torch.nn.Module):
        from ..convert.weights import to_jax_params
        tree = to_jax_params(tree.state_dict())
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def param_table(params, prefix: str = "") -> str:
    """Every leaf's path, shape and count, then the total.  An empty tree
    ({}, [] or None) gives a TOTAL-0 table; a scalar leaf (a 0-d array or
    a Python number) counts as one parameter."""
    rows = []
    total = 0
    for path, leaf in _leaves(params):
        shape = tuple(np.shape(leaf))
        n = int(np.prod(shape)) if shape else 1
        total += n
        rows.append((prefix + "/".join(path), str(shape), n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'name':<{width}}{'shape':<20}{'#':>12}"]
    lines += [f"{n:<{width}}{s:<20}{c:>12,}" for n, s, c in rows]
    lines.append(f"{'TOTAL':<{width}}{'':<20}{total:>12,}")
    return "\n".join(lines)


def count_params(params) -> int:
    return sum(int(np.prod(np.shape(x))) for _, x in _leaves(params))


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """The FLOPs ``fn(*args, **kwargs)`` runs, by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def flops_report(fn: Callable, *args, **kwargs) -> Tuple[int, str]:
    flops = count_flops(fn, *args, **kwargs)
    return flops, f"total flops: {flops:,}  ({FLOPS_NOTE})"
