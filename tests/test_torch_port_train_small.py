"""One train step of raft-small (``RAFTConfig.small_model``: the small
encoders, no batch norm, the 3x3 ConvGRU, ``upflow8``) in the port
against ``jax.jit(make_train_step)``, at 48x64, 2 iterations, batch 2,
float32, on seeded inputs and the same converted weights (biases drawn
away from 0), with the bounds of tests/torch_train_parity.py."""

import pytest

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig

from torch_train_parity import JaxStep, check_variant, stage_kwargs

import torch

torch.set_num_threads(2)   # several test workers share the host's cores


@pytest.fixture(scope="module")
def jax_step():
    return JaxStep(JaxConfig.small_model(iters=2),
                   JaxTrainConfig(**stage_kwargs()))


def test_small_step_matches_jax(jax_step):
    check_variant(jax_step, rt.RAFTConfig.small_model(iters=2),
                  TrainConfig(**stage_kwargs()), 2)
