"""The port's SepConvGRU pieces (raft_tpu_torch.ops.gru_cuda and the ctx
hoist of models/update.py) against the JAX package, the Pallas kernel run
in interpret mode, at the JAX kernel suite's 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.models.update import init_sep_conv_gru
from raft_tpu.models.update import precompute_gru_ctx as jax_precompute
from raft_tpu.ops.gru_pallas import fuse_gru_weights as jax_fuse
from raft_tpu.ops.gru_pallas import sep_conv_gru_pallas
from raft_tpu_torch.convert import weights
from raft_tpu_torch.models.update import SepConvGRU, precompute_gru_ctx
from raft_tpu_torch.ops import gru_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B, H, W, hid, mdim, ctxd):
    p = init_sep_conv_gru(jax.random.PRNGKey(seed), hid, ctxd + mdim)
    rng = np.random.RandomState(seed)
    h = np.tanh(rng.randn(B, H, W, hid)).astype(np.float32)
    motion = rng.randn(B, H, W, mdim).astype(np.float32)
    inp = np.maximum(rng.randn(B, H, W, ctxd), 0).astype(np.float32)
    gru = SepConvGRU(hid, ctxd + mdim)
    gru.load_state_dict(weights.from_jax_params(p), strict=True)
    return p, gru, h, motion, inp


def _jax_ctx_cat(ctx):
    return tuple(np.concatenate([np.asarray(ctx[g + s]) for g in
                                 ("convz", "convr", "convq")], -1)
                 for s in ("1", "2"))


def test_fuse_gru_weights_matches_jax():
    p, gru, *_ = _case(0, 1, 2, 2, 16, 12, 8)
    want = jax_fuse(p, 16, 8)
    got = gru_cuda.fuse_gru_weights(gru, 16, 8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prepare_gru_weights_lays_out_the_kernels_operands():
    """The kernel's weights (prepare_gru_weights) read back to the fused
    ones: float32 as tf32 hi + lo (within 2^-22), bfloat16 exactly, each in
    its slab / fragment order; anything else raises."""
    p, gru, *_ = _case(4, 1, 2, 2, 64, 16, 8)
    fw = gru_cuda.fuse_gru_weights(gru, 64, 8)
    kw = gru_cuda.prepare_gru_weights(fw, torch.float32)
    for k, w in fw.items():
        taps, cin, n = w.shape
        x = kw[k]
        assert x.shape == (5, cin // 8, n, 4, 4) and x.dtype == torch.float32

        def read(part):                  # [5, slab, N, t, 2] -> [5, Cin, N]
            return part.permute(0, 1, 3, 4, 2).reshape(taps, cin, n)
        hi, lo = read(x[..., :2]), read(x[..., 2:])
        for t in (hi, lo):
            assert bool(((t.contiguous().view(torch.int32) & 0x1FFF) == 0).all())
        err = ((hi.double() + lo.double()) - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
    fw_bf = {k: v.bfloat16().float() for k, v in fw.items()}
    kw_bf = gru_cuda.prepare_gru_weights(fw_bf, torch.bfloat16)
    for k, w in fw_bf.items():
        taps, cin, n = w.shape
        x = kw_bf[k]
        assert x.shape == (5, cin // 16, n, 4, 4) and x.dtype == torch.bfloat16
        assert torch.equal(x.permute(0, 1, 3, 4, 2).reshape(taps, cin, n).float(), w)
    with pytest.raises(ValueError, match="bfloat16-exact"):
        gru_cuda.prepare_gru_weights(fw, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gru_cuda.prepare_gru_weights(fw, torch.float16)


# (B, H, W, hidden, motion, ctx, block_rows of the JAX kernel)
@pytest.mark.parametrize("B,H,W,hid,mdim,ctxd,T", [
    (1, 12, 16, 128, 128, 128, 8),   # full-model channel plan, 2 row blocks
    (2, 13, 17, 32, 16, 24, 4),      # H not a multiple of block_rows
    (1, 6, 20, 32, 16, 24, 8),       # H < block_rows
], ids=["full_plan", "ragged_rows", "one_block"])
def test_plain_gru_matches_jax_kernel(B, H, W, hid, mdim, ctxd, T):
    p, gru, h, motion, inp = _case(1, B, H, W, hid, mdim, ctxd)
    jctx = jax_precompute(p, jnp.asarray(inp), hid)
    want = np.asarray(sep_conv_gru_pallas(p, jnp.asarray(h), jnp.asarray(motion),
                                          jctx, block_rows=T, interpret=True,
                                          impl="kernel"))
    ctx = tuple(torch.from_numpy(c) for c in _jax_ctx_cat(jctx))
    fw = gru_cuda.fuse_gru_weights(gru, hid, ctxd)
    got = gru_cuda.sep_conv_gru_plain(fw, torch.from_numpy(h),
                                      torch.from_numpy(motion), ctx)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("biased", [False, True], ids=["zero_bias", "biased"])
def test_precompute_gru_ctx_matches_jax(biased):
    """The hoisted context terms carry the gate biases (the init's zeros,
    or drawn from U(-0.25, 0.25))."""
    p, gru, _, _, inp = _case(2, 1, 7, 9, 32, 16, 24)
    if biased:
        rng = np.random.RandomState(20)
        for name, conv in p.items():
            conv["b"] = jnp.asarray(rng.uniform(-0.25, 0.25, conv["b"].shape)
                                    .astype(np.float32))
        gru.load_state_dict(weights.from_jax_params(p), strict=True)
    want = _jax_ctx_cat(jax_precompute(p, jnp.asarray(inp), 32))
    got = precompute_gru_ctx(gru, torch.from_numpy(inp).permute(0, 3, 1, 2), 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)


def test_cpu_dispatch_is_plain_and_counter_stays():
    p, gru, h, motion, inp = _case(3, 1, 5, 6, 64, 16, 8)
    with torch.no_grad():
        ctx = precompute_gru_ctx(gru, torch.from_numpy(inp).permute(0, 3, 1, 2), 64)
        fw = gru_cuda.fuse_gru_weights(gru, 64, 8)
        before = gru_cuda.sep_conv_gru_cuda.launches
        got = gru_cuda.sep_conv_gru(fw, torch.from_numpy(h),
                                    torch.from_numpy(motion), ctx)
        want = gru_cuda.sep_conv_gru_plain(fw, torch.from_numpy(h),
                                           torch.from_numpy(motion), ctx)
    assert gru_cuda.sep_conv_gru_cuda.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        gru_cuda.sep_conv_gru_cuda(fw, torch.from_numpy(h),
                                   torch.from_numpy(motion), ctx)
    hg = torch.from_numpy(h).requires_grad_(True)
    out = gru_cuda.sep_conv_gru(fw, hg, torch.from_numpy(motion), ctx)
    with pytest.raises(NotImplementedError, match="item 7"):
        out.sum().backward()
