"""The kernel wrappers' backward on the CPU, and the training forward's
structure, in the port alone.

Each wrapper's gradient is the vjp of its plain twin recomputed from the
saved inputs (the JAX package's definition): the four lookups ('all',
'window', packed, ragged) against autograd through
``lookup_blockwise_onehot`` (float32 and bfloat16 operands), the GRU
against autograd through ``sep_conv_gru_plain``, bit for bit.  On the CPU
the kernel configuration and the plain one compute the same training
step, bit for bit, with ``remat_iters`` on and off; the converge policy
trains masked over all iterations; dropout follows its masks; the
batch-norm modes are restored; bfloat16 training runs on float32 masters
(item 7b) and refuses a bfloat16 model."""

import dataclasses

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.models.raft import bn_training, draw_dropout_masks
from raft_tpu_torch.ops import corr_cuda, gru_cuda
from raft_tpu_torch.ops.coords import coords_grid
from raft_tpu_torch.ops.corr import (fmap2_pyramid, lookup_blockwise_onehot,
                                     mask_ragged_rows, ragged_pyramid)
from raft_tpu_torch.training import TrainState, make_optimizer, make_train_step

from torch_train_parity import make_batch, stage_kwargs

torch.set_num_threads(2)   # several test workers share the host's cores


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype).requires_grad_(True)


def _grads(out, inputs, w):
    return torch.autograd.grad((out * w).sum(), inputs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("entry", ["all", "window", "packed", "ragged"])
def test_lookup_backward_is_the_twins_vjp(entry, dtype):
    rng = np.random.RandomState(0)
    B, H, W, C, L, r = 2, 6, 16, 32, 3, 2
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    coords = (coords_grid(B, H, W)
              + torch.from_numpy(rng.uniform(-3, 3, (B, H, W, 2))
                                 .astype(np.float32)))
    sizes8 = torch.tensor([[6, 16], [4, 9]], dtype=torch.int32)
    if entry == "ragged":
        t1 = mask_ragged_rows(torch.from_numpy(f1), sizes8)
        lv = ragged_pyramid(torch.from_numpy(f2), sizes8, L)
    else:
        t1, lv = torch.from_numpy(f1), fmap2_pyramid(torch.from_numpy(f2), L)
    w = torch.from_numpy(rng.randn(B, H, W, L * (2 * r + 1) ** 2)
                         .astype(np.float32))

    def leaves():
        return ([t1.detach().to(dtype).contiguous().requires_grad_(True)]
                + [x.detach().to(dtype).contiguous().requires_grad_(True)
                   for x in lv] + [coords.clone().requires_grad_(True)])
    a = leaves()
    fn = {"all": lambda: corr_cuda.fused_lookup(a[0], a[1:-1], a[-1], r),
          "window": lambda: corr_cuda.window_lookup(a[0], a[1:-1], a[-1], r),
          "packed": lambda: corr_cuda.packed_lookup(a[0], a[1:-1], a[-1], r),
          "ragged": lambda: corr_cuda.ragged_lookup(a[0], a[1:-1], a[-1],
                                                    sizes8, r)}[entry]
    got = _grads(fn(), a, w)
    b = leaves()
    want = _grads(lookup_blockwise_onehot(b[0], b[1:-1], b[-1], r), b, w)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype
        torch.testing.assert_close(g, e, rtol=0, atol=0)


def test_gru_backward_is_the_plain_vjp():
    rng = np.random.RandomState(1)
    B, H, W, hid = 2, 5, 7, 16
    gru = rt.RAFT(rt.RAFTConfig.full(hidden_dim=hid, context_dim=hid)) \
        .update_block.gru
    for p in gru.parameters():
        torch.nn.init.normal_(p, std=0.1)
    motion_dim = gru.convz1.weight.shape[1] - 2 * hid

    def inputs():
        return [_leaf(np.tanh(rng_h)), _leaf(rng_m),
                _leaf(rng_c1), _leaf(rng_c2)]
    rng_h = rng.randn(B, H, W, hid).astype(np.float32)
    rng_m = rng.randn(B, H, W, motion_dim).astype(np.float32)
    rng_c1 = rng.randn(B, H, W, 3 * hid).astype(np.float32)
    rng_c2 = rng.randn(B, H, W, 3 * hid).astype(np.float32)
    w = torch.from_numpy(rng.randn(B, H, W, hid).astype(np.float32))
    a = inputs()
    fw = gru_cuda.fuse_gru_weights(gru, hid, hid)
    weights = [p for n, p in gru.named_parameters() if n.endswith("weight")]
    got = _grads(gru_cuda.sep_conv_gru(fw, a[0], a[1], (a[2], a[3])),
                 a + weights, w)
    b = inputs()
    fw = gru_cuda.fuse_gru_weights(gru, hid, hid)
    want = _grads(gru_cuda.sep_conv_gru_plain(fw, b[0], b[1], (b[2], b[3])),
                  b + weights, w)
    assert len(got) == 4 + 6
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)


def _step_grads(cfg, tc, batch, params_from=None):
    model = rt.init_raft_torch(cfg, torch.Generator().manual_seed(7),
                               device="cpu")
    tx = make_optimizer(tc)
    got = {}

    class Capture:
        def update(self, grads, opt_state, ps):
            got["g"] = [g.clone() for g in grads]
            return tx.update(grads, opt_state, ps)
    state = TrainState.create(model, tx)
    state, m = make_train_step(cfg, tc, Capture())(state, batch, 0)
    return got["g"], m, state


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_kernel_and_plain_configs_train_alike_on_cpu(remat):
    """On CPU tensors 'pallas' runs the plain versions forward and the
    twins backward: the same gradients as the plain configuration; remat
    changes nothing."""
    batch = make_batch(2, H=32, W=48)
    tc = TrainConfig(**stage_kwargs())
    k = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2,
                           remat_iters=remat)
    p = dataclasses.replace(k, corr_impl="blockwise", gru_impl="xla",
                            remat_iters=True)
    gk, mk, _ = _step_grads(k, tc, batch)
    gp, mp, _ = _step_grads(p, tc, batch)
    assert float(mk["loss"]) == float(mp["loss"])
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_converge_policy_trains_masked_over_all_iterations():
    """converge:* in training runs every iteration masked (iters_used per
    sample) and emits every iteration's flow; converge:0 trains exactly
    as 'fixed'."""
    batch = make_batch(3, H=32, W=48)
    tc = TrainConfig(**stage_kwargs())
    base = rt.RAFTConfig.small_model(iters=3)
    g0, m0, _ = _step_grads(base, tc, batch)
    g1, m1, _ = _step_grads(dataclasses.replace(
        base, iters_policy="converge:0"), tc, batch)
    assert float(m1["mean_iters"]) == 3.0
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g2, m2, _ = _step_grads(dataclasses.replace(
        base, iters_policy="converge:1e9:2"), tc, batch)
    assert float(m2["mean_iters"]) == 2.0 and np.isfinite(float(m2["loss"]))


def test_training_forward_modes_and_dropout():
    cfg = rt.RAFTConfig.full(iters=1, dropout=0.25)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = [torch.from_numpy(x) for x in make_batch(4, H=32, W=48)[:2]]

    def run(seed):
        masks = draw_dropout_masks(cfg, im[0].shape[0],
                                   torch.Generator().manual_seed(seed))
        out = rt.raft_forward(model, im[0], im[1], cfg, train=True,
                              dropout_masks=masks)
        return out.flow_iters.detach()
    assert not model.cnet.norm1.batch_stats
    before = model.cnet.norm1.running_mean.clone()
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(before, model.cnet.norm1.running_mean)
    assert not model.cnet.norm1.batch_stats       # restored
    frozen = model.cnet.norm1.running_mean.clone()
    rt.raft_forward(model, im[0], im[1], cfg, train=True, freeze_bn=True)
    assert torch.equal(frozen, model.cnet.norm1.running_mean)
    with bn_training(model, True):
        assert model.cnet.norm1.batch_stats
    assert not model.cnet.norm1.batch_stats
    out = rt.raft_forward(model, im[0], im[1], cfg)
    assert out.flow_iters is None and not out.flow.requires_grad
    model.train()                 # the module's mode is not the JAX train flag
    torch.testing.assert_close(rt.raft_forward(model, im[0], im[1], cfg).flow,
                               out.flow, rtol=0, atol=0)


def test_bf16_training_raises_item_7b():
    """Item 7b (bfloat16 training) is done: the train step builds under
    bfloat16 and the training forward runs on float32 masters; what
    still raises is a bfloat16 model there (it cannot be a master) and a
    configuration the JAX package refuses."""
    cfg = rt.RAFTConfig.full(compute_dtype="bfloat16", iters=1)
    make_train_step(cfg, TrainConfig(), make_optimizer(TrainConfig()))
    model = rt.init_raft_torch(cfg, device="cpu")
    assert next(model.parameters()).dtype == torch.bfloat16
    im = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="float32 master weights"):
        rt.raft_forward(model, im, im, cfg, train=True)
    masters = rt.init_raft_torch(cfg, device="cpu", dtype=torch.float32)
    out = rt.raft_forward(masters, im, im, cfg, train=True)
    assert out.flow_iters.dtype == torch.float32 and out.flow.requires_grad
    with pytest.raises(ValueError, match="gru_impl='pallas'"):
        rt.raft_forward(masters, im, im, rt.RAFTConfig.small_model(
            gru_impl="pallas"), train=True)
