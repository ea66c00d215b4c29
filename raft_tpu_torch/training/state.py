"""Train state: the step, the model and the optimizer's state.

The model's parameters are the JAX package's ``params`` (every conv weight
and bias and every batch-norm affine); its batch-norm running statistics
(``running_mean``, ``running_var``) are ``bn_state``: they get no gradient,
no weight decay and no Adam update, and the training forward refreshes
them (``split_bn_state``, the JAX package's ``training/state.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .optim import Optimizer, OptState

_STATE_LEAVES = ("running_mean", "running_var")


def split_bn_state(model: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                              Dict[str, torch.Tensor]]:
    """``model`` -> (trainable, bn_state): the parameters by
    ``state_dict`` name, and the batch-norm running statistics by name."""
    trainable = dict(model.named_parameters())
    bn = {k: v for k, v in model.named_buffers()
          if k.rsplit(".", 1)[-1] in _STATE_LEAVES}
    return trainable, bn


def merge_bn_state(trainable: dict, bn_state: dict) -> dict:
    """Nested trees (the JAX package's layout: a training checkpoint's
    ``params/`` and ``bn_state/`` leaves) -> one tree of both, the inverse
    of the JAX package's ``split_bn_state`` (its ``merge_bn_state``)."""
    merged: dict = {}

    def walk(t, s, out):
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = {}
                walk(v, s.get(k, {}) if s else {}, out[k])
            else:
                out[k] = v
        if s:
            for k, v in s.items():
                if not isinstance(v, dict):
                    out[k] = v

    walk(trainable, bn_state, merged)
    return merged


@dataclasses.dataclass
class TrainState:
    """``step`` (a Python int, the optimizer steps taken), ``model`` (its
    parameters the ``params``, its running statistics the ``bn_state``,
    updated in place by the train step) and ``opt_state``
    (:class:`~raft_tpu_torch.training.optim.OptState`)."""

    step: int
    model: nn.Module
    opt_state: OptState

    @staticmethod
    def create(model: nn.Module, tx: Optimizer) -> "TrainState":
        return TrainState(step=0, model=model,
                          opt_state=tx.init(list(model.parameters())))

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def bn_state(self) -> Dict[str, torch.Tensor]:
        return split_bn_state(self.model)[1]
