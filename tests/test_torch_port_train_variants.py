"""One train step of the port against ``jax.jit(make_train_step)`` for the
other configurations and recipes, at full widths, 48x64, 2 iterations,
float32, on seeded inputs and the same converted weights (biases and
batch-norm affines drawn away from 0 and 1), with the bounds of
tests/torch_train_parity.py: the default ``RAFTConfig()`` (dense
correlation, the plain GRU) with ``accum_steps=2`` over a batch of 4
(stride-major micro-batches, the batch-norm statistics updated through
them in turn), and the same under ``freeze_bn`` (running statistics used
and left bit for bit, affines trained).  raft-small is in
tests/test_torch_port_train_small.py."""

import pytest

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig

from torch_train_parity import JaxStep, check_variant, stage_kwargs

import torch

torch.set_num_threads(2)   # several test workers share the host's cores

CASES = {
    "default_accum2": (dict(accum_steps=2, batch_size=4), 4),
    "default_freeze_bn": (dict(freeze_bn=True), 2),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(JAX step compiled once per case, port config, recipe, batch)."""
    train_kw, B = CASES[request.param]
    kw = stage_kwargs(**train_kw)
    return (JaxStep(JaxConfig(iters=2), JaxTrainConfig(**kw)),
            rt.RAFTConfig(iters=2), TrainConfig(**kw), B)


def test_variant_step_matches_jax(case):
    check_variant(*case)
