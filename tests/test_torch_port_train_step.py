"""One train step of raft-things through the port's CUDA-kernel
configuration (``corr_impl='pallas', gru_impl='pallas'``; on the CPU the
wrappers run their plain versions forward and the JAX-defined twins'
vjp backward) against ``jax.jit(make_train_step)`` of the JAX package, at
full widths, 48x64, 2 iterations, batch 2, float32, on seeded inputs and
the same converted weights (zero conv biases, and biases and batch-norm
affines drawn away from 0 and 1): the loss, the gradients, the batch-norm
statistics and the parameters after the update (bounds in
tests/torch_train_parity.py).  Then the training checkpoints: a JAX
checkpoint resumes in the port and a port checkpoint restores in the JAX
package, each bit for bit, and the next step matches."""

import numpy as np
import pytest

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.convert import load_checkpoint_auto
from raft_tpu.training.checkpoint import restore_checkpoint as jax_restore
from raft_tpu.training.checkpoint import save_checkpoint as jax_save

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.convert.weights import to_jax_train_state
from raft_tpu_torch.training import restore_checkpoint, save_checkpoint
from raft_tpu_torch.training import TrainState, make_optimizer

from test_torch_port_model import BIASED
from torch_train_parity import (JaxStep, check_bn, check_first_update,
                                check_grads, check_loss, jax_first_grads,
                                make_batch, make_params, named, port_step,
                                stage_kwargs)

import torch

torch.set_num_threads(2)   # several test workers share the host's cores

KERNELS = dict(corr_impl="pallas", gru_impl="pallas", iters=2)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step, compiled once for the module (about 15 s)."""
    return JaxStep(JaxConfig.full(**KERNELS), JaxTrainConfig(**stage_kwargs()))


@BIASED
def test_train_step_matches_jax(jax_step, biased):
    params = make_params(rt.RAFTConfig.full(), biased=biased)
    batch = make_batch(0)
    jstate, jm = jax_step(jax_step.create(params), batch)
    cfg, tc = rt.RAFTConfig.full(**KERNELS), TrainConfig(**stage_kwargs())
    state, m, gp = port_step(cfg, tc, params, batch)
    check_loss(m, jm)
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-3 * float(jm["grad_norm"])
    gj = jax_first_grads(jstate, jm, tc.clip_norm)
    check_grads(gp, gj, small=False)
    pn, jn = to_jax_train_state(state), named(jstate)
    check_bn(pn, jn)
    p0 = {k[len("params/"):]: v for k, v in
          named(jax_step.create(params)).items() if k.startswith("params/")}
    check_first_update(pn, jn, p0, gp, gj, tc, m, jm)
    assert state.step == int(jstate.step) == 1
    for k in ("opt_state/notfinite_count", "opt_state/total_notfinite",
              "opt_state/last_finite", "opt_state/inner_state/1/0/count",
              "opt_state/inner_state/1/2/count"):
        assert pn[k] == jn[k] and pn[k].dtype == jn[k].dtype, k


def test_checkpoints_cross_restore_and_resume(jax_step, tmp_path):
    """JAX step 1 -> JAX checkpoint -> the port restores it bit for bit
    and takes step 2, as JAX does from the same state; the port's
    checkpoint of step 2 restores in the JAX package bit for bit, and its
    weights load there for inference (``load_checkpoint_auto``)."""
    params = make_params(rt.RAFTConfig.full(), biased=True)
    j1, _ = jax_step(jax_step.create(params), make_batch(0))
    jax_save(tmp_path / "ckpt_1.npz", j1)

    cfg, tc = rt.RAFTConfig.full(**KERNELS), TrainConfig(**stage_kwargs())
    template = TrainState.create(rt.init_raft_torch(cfg, device="cpu"),
                                 make_optimizer(tc))
    state = restore_checkpoint(tmp_path / "ckpt_1.npz", template)
    want = named(j1)
    got = to_jax_train_state(state)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    batch = make_batch(1)
    j2, jm = jax_step(j1, batch)
    state, m, _ = port_step(cfg, tc, None, batch, state=state)
    check_loss(m, jm)
    check_bn(to_jax_train_state(state), named(j2))

    save_checkpoint(tmp_path / "ckpt_2.npz", state)
    back = jax_restore(tmp_path / "ckpt_2.npz", jax_step.create(params))
    mine = to_jax_train_state(state)
    for k, v in named(back).items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    assert int(back.step) == 2
    full = load_checkpoint_auto(tmp_path / "ckpt_2.npz")
    sd = rt.from_jax_params(full)
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
