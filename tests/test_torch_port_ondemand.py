"""The port's last lookups and the un-hoisted GRU against the JAX package:
``ops/grid_sample.py``, the gather lookup of ``corr_impl='blockwise'``
with ``corr_lookup='gather'`` (``lookup_ondemand``) and the point-by-point
oracle ``naive_corr_lookup`` at the JAX kernel suite's 1e-5; the gather
lookup also against the port's one-hot blockwise lookup; the whole model
under 'blockwise' + 'gather', and under ``gru_ctx_hoist=False`` for both
variants, at every iteration within the full-model bound ``1e-3 + 1e-3 *
max|flow|`` of JAX's (numpy-seeded weights through ``from_jax_params``,
zero biases and the biased ones of ``test_torch_port_model.with_biases``).
``F.grid_sample`` with the same ``align_corners`` computes what
``grid_sample_normalized`` does (shown here at 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.models.update import apply_conv_gru, apply_sep_conv_gru
from raft_tpu.ops import corr as jax_corr
from raft_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from raft_tpu.ops.grid_sample import (
    grid_sample_normalized as jax_grid_sample_normalized)
import raft_tpu_torch as rt
from raft_tpu_torch.models.update import (ConvGRU, SepConvGRU, conv_gru_full,
                                          sep_conv_gru_full)
from raft_tpu_torch.ops import corr as port_corr
from raft_tpu_torch.ops.conv import to_nchw, to_nhwc
from raft_tpu_torch.ops.grid_sample import grid_sample, grid_sample_normalized
from test_torch_port_model import BIASED
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)
t = torch.from_numpy


def _image_and_coords(seed=0, B=2, H=7, W=9, C=3):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, H, W, C).astype(np.float32)
    # inside, on the border, and well outside (both sides) the image
    coords = np.stack([rng.uniform(-3, W + 2, (B, 5, 6)),
                       rng.uniform(-3, H + 2, (B, 5, 6))], -1).astype(np.float32)
    coords[:, 0, 0] = (0, 0)
    coords[:, 0, 1] = (W - 1, H - 1)
    return img, coords


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(padding_mode):
    img, coords = _image_and_coords()
    want = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords),
                           padding_mode=padding_mode)
    got = grid_sample(t(img), t(coords), padding_mode=padding_mode)
    assert tuple(got.shape) == (2, 5, 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample(t(img), t(coords), padding_mode="reflection")


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (3, 1), (0, 0)])
def test_grid_sample_narrow_axes_match_jax(shape):
    """A one-pixel axis (a coarse pyramid level) and an empty image: every
    coordinate off the pixel samples 0 under zero padding, as in JAX."""
    H, W = shape
    rng = np.random.RandomState(3)
    img = rng.randn(2, H, W, 3).astype(np.float32)
    coords = np.stack([rng.uniform(-2, W + 1, (2, 7)),
                       rng.uniform(-2, H + 1, (2, 7))], -1).astype(np.float32)
    coords[:, 0] = 0
    modes = ("zeros",) if H == 0 else ("zeros", "border")
    for padding_mode in modes:
        want = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords),
                               padding_mode=padding_mode)
        got = grid_sample(t(img), t(coords), padding_mode=padding_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_normalized_is_torch_grid_sample(align_corners,
                                                      padding_mode):
    """JAX's and the port's normalized sampler agree at 1e-5, and both are
    ``F.grid_sample(bilinear)`` with the same ``align_corners``."""
    img, _ = _image_and_coords(1)
    grid = np.random.RandomState(2).uniform(-1.3, 1.3, (2, 4, 5, 2)).astype(
        np.float32)
    got = grid_sample_normalized(t(img), t(grid), padding_mode, align_corners)
    want = jax_grid_sample_normalized(
        jnp.asarray(img), jnp.asarray(grid), padding_mode, align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = F.grid_sample(t(img).permute(0, 3, 1, 2), t(grid), mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               **TOL)


def _corr_case(seed=3, B=2, H=6, W=8, C=16, L=3):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].astype(np.float32)
    coords = (grid + 2.5 * rng.randn(B, H, W, 2)).astype(np.float32)
    coords[0, 0, :3] += (40.0, -30.0)          # windows wholly off the map
    return f1, f2, coords, L


@pytest.mark.parametrize("chunk", [None, 7], ids=["default_chunk", "chunk7"])
@pytest.mark.parametrize("radius", [2, 4])
def test_lookup_ondemand_matches_jax_and_blockwise(chunk, radius):
    f1, f2, coords, L = _corr_case()
    jlevels = jax_corr.fmap2_pyramid(jnp.asarray(f2), L)
    want = jax_corr.lookup_ondemand(jnp.asarray(f1), jlevels,
                                    jnp.asarray(coords), radius, chunk=chunk)
    levels = port_corr.fmap2_pyramid(t(f2), L)
    got = port_corr.lookup_ondemand(t(f1), levels, t(coords), radius,
                                    chunk=chunk)
    assert tuple(got.shape) == (2, 6, 8, L * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    onehot = port_corr.lookup_blockwise_onehot(t(f1), levels, t(coords), radius)
    np.testing.assert_allclose(got.numpy(), onehot.numpy(), **TOL)


def test_ondemand_chunk_is_jax_budget():
    """The default chunk: the ~8 MB window buffer, a power of 2 in
    [32, 1024], as the JAX package sizes it (B=1, C=256, r=4: 64)."""
    assert port_corr.ondemand_chunk(1, 256, 4) == 64
    assert port_corr.ondemand_chunk(8, 256, 4) == 32
    assert port_corr.ondemand_chunk(1, 16, 2) == 1024


def test_naive_corr_lookup_matches_jax():
    f1, f2, coords, L = _corr_case(4)
    want = jax_corr.naive_corr_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                      jnp.asarray(coords), L, 3)
    got = port_corr.naive_corr_lookup(t(f1), t(f2), t(coords), L, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), port_corr.lookup_ondemand(
            t(f1), port_corr.fmap2_pyramid(t(f2), L), t(coords), 3).numpy(),
        **TOL)


def test_unhoisted_grus_match_jax():
    """One iteration of the un-hoisted SepConvGRU and 3x3 ConvGRU (biases
    in the gate convs) against JAX's apply_sep_conv_gru / apply_conv_gru,
    on weights from the JAX trees."""
    rng = np.random.RandomState(5)
    for small, gru_cls, jax_fn, hid, xdim in (
            (False, SepConvGRU, apply_sep_conv_gru, 128, 256),
            (True, ConvGRU, apply_conv_gru, 96, 146)):
        cfg = JaxConfig.small_model() if small else JaxConfig.full()
        params = seeded_jax_params(cfg, biased=True)["update_block"]["gru"]
        gru = gru_cls(hid, xdim)
        sd = rt.from_jax_params({"update_block": {"gru": params}})
        gru.load_state_dict({k.split("gru.", 1)[1]: v for k, v in sd.items()})
        h = np.tanh(rng.randn(2, 5, 7, hid)).astype(np.float32)
        x = rng.randn(2, 5, 7, xdim).astype(np.float32)
        want = jax_fn(params, jnp.asarray(h), jnp.asarray(x))
        full = conv_gru_full if small else sep_conv_gru_full
        with torch.no_grad():
            got = to_nhwc(full(gru, to_nchw(t(h)), to_nchw(t(x))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@BIASED
@pytest.mark.parametrize("overrides", [
    dict(corr_impl="blockwise", corr_lookup="gather"),
    dict(corr_impl="blockwise", gru_impl="xla", gru_ctx_hoist=False),
    dict(small=True, corr_impl="blockwise", gru_ctx_hoist=False),
], ids=["blockwise_gather", "unhoisted", "small_unhoisted"])
def test_whole_model_matches_jax_every_iteration(overrides, biased):
    small = overrides.get("small", False)
    base = dict(overrides, iters=2)
    jcfg = (JaxConfig.small_model if small else JaxConfig.full)(**base)
    params = seeded_jax_params(jcfg, biased=biased)
    im = np.random.RandomState(6).rand(2, 1, 32, 48, 3).astype(np.float32)
    out, _ = jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]), jcfg,
                         all_flows=True)
    cfg = (rt.RAFTConfig.small_model if small else rt.RAFTConfig.full)(**base)
    model = rt.RAFT(cfg)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    got = rt.raft_forward(model.eval(), t(im[0]), t(im[1]), cfg,
                          all_flows=True).flow_iters.numpy()
    want = np.asarray(out.flow_iters)
    assert got.shape == want.shape == (2, 1, 32, 48, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-3 + 1e-3 * scale, (
            f"iter {i}: max|Δflow|={err:.2e} vs scale {scale:.2e}")
