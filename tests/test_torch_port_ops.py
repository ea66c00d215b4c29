"""Stock ops of the PyTorch port (raft_tpu_torch.ops) against the JAX
package on the same seeded numpy inputs, at 1e-5 (float32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import conv as jconv
from raft_tpu.ops import coords as jcoords
from raft_tpu.ops import corr as jcorr
from raft_tpu.ops import norm as jnorm
from raft_tpu.ops import upsample as jup
from raft_tpu_torch.ops import conv, coords, corr, norm, upsample

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.mark.parametrize("kh,kw,cin,cout,stride", [
    (7, 7, 3, 16, 2),      # the encoder stem
    (3, 3, 8, 12, 2),      # strided residual conv
    (1, 5, 12, 8, 1),      # SepConvGRU horizontal gate
    (5, 1, 12, 8, 1),      # SepConvGRU vertical gate
    (1, 1, 6, 4, 2),       # strided shortcut
], ids=["7x7s2", "3x3s2", "1x5", "5x1", "1x1s2"])
def test_conv2d_matches_jax(kh, kw, cin, cout, stride):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 13, 18, cin).astype(np.float32)
    w = rng.randn(kh, kw, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), stride=stride))
    got = conv.conv2d(_t(x), _t(w), _t(b), stride=stride).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_apply_conv_fused_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 9, 11, 10).astype(np.float32)
    ps = [{"w": rng.randn(3, 3, 10, c).astype(np.float32),
           "b": rng.randn(c).astype(np.float32)} for c in (4, 7)]
    want = jconv.apply_conv_fused(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in ps], jnp.asarray(x))
    got = conv.apply_conv_fused([_t(p["w"]).permute(3, 2, 0, 1) for p in ps],
                                [_t(p["b"]) for p in ps],
                                _t(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **TOL)


def test_instance_norm_matches_jax():
    x = np.random.RandomState(2).randn(2, 7, 9, 5).astype(np.float32) * 3 + 1
    want = np.asarray(jnorm.instance_norm(jnp.asarray(x)))
    got = norm.instance_norm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_batch_norm_eval_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    p = {"gamma": rng.rand(4) + 0.5, "beta": rng.randn(4),
         "mean": rng.uniform(-0.1, 0.1, 4), "var": rng.uniform(0.8, 1.2, 4)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want, _ = jnorm.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), train=False)
    bn = norm.BatchNorm(4)
    bn.load_state_dict({"weight": _t(p["gamma"]), "bias": _t(p["beta"]),
                        "running_mean": _t(p["mean"]),
                        "running_var": _t(p["var"])})
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_coords_grid_matches_jax():
    np.testing.assert_array_equal(coords.coords_grid(2, 3, 5).numpy(),
                                  np.asarray(jcoords.coords_grid(2, 3, 5)))


@pytest.mark.parametrize("h,w", [(13, 17), (6, 8), (3, 2)])
def test_fmap2_pyramid_odd_sizes_match_jax(h, w):
    """Odd sizes floor (13 -> 6 -> 3 -> 1) and sizes below 2 pool to 0."""
    f2 = np.random.RandomState(4).randn(1, h, w, 3).astype(np.float32)
    want = jcorr.fmap2_pyramid(jnp.asarray(f2), 4)
    got = corr.fmap2_pyramid(_t(f2), 4)
    for g, wl in zip(got, want):
        assert tuple(g.shape) == wl.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), **TOL)


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(5)
    flow = rng.randn(2, 4, 5, 2).astype(np.float32) * 3
    mask = rng.randn(2, 4, 5, 576).astype(np.float32)
    want = np.asarray(jup.convex_upsample_flow(jnp.asarray(flow),
                                               jnp.asarray(mask)))
    got = upsample.convex_upsample_flow(_t(flow), _t(mask)).numpy()
    assert got.shape == (2, 32, 40, 2)
    np.testing.assert_allclose(got, want, **TOL)
