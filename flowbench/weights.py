"""Seeded weights of a configuration, made by the benchmark.

One ``torch.randn`` call on the target device draws every value of the
state dict from ``torch.Generator(device).manual_seed(seed)``; each tensor
is then a slice of it, scaled by the configuration's ``init`` recipe:

* convolution kernels: Kaiming normal, fan-out, ReLU gain (the official
  RAFT initialisation, ``nn.init.kaiming_normal_(mode='fan_out')``), times
  the recipe's per-layer ``gain`` where it names one;
* convolution biases: normal with ``bias_std``;
* batch norm: weight ``1 + N(0, affine_std)``, bias ``N(0, affine_std)``,
  running mean ``N(0, stat_std)``, running variance ``exp(N(0, stat_std))``.

The same state dict is handed to the program (``load_state_dict``) and to
the plain reference, which reads the tensors and nothing the program made.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.raft import param_shapes


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of a configuration file's ``model`` by its
    ``init`` recipe."""
    init = cfg["init"]
    gains = init.get("gain", {})
    shapes = param_shapes(cfg["model"])
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    by_name = dict(shapes)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        x = z[at:at + n].reshape(shape)
        at += n
        layer, leaf = name.rsplit(".", 1)
        if len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            x = x * (std * gains.get(layer, 1.0))
        elif leaf == "bias" and len(by_name.get(layer + ".weight", ())) == 4:
            x = x * init["bias_std"]
        elif leaf == "weight":
            x = 1.0 + x * init["affine_std"]
        elif leaf == "bias":
            x = x * init["affine_std"]
        elif leaf == "running_mean":
            x = x * init["stat_std"]
        else:
            x = torch.exp(x * init["stat_std"])
        out[name] = x.contiguous()
    return out
