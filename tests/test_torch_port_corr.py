"""The port's plain correlation lookup (the CUDA kernel's plain version,
raft_tpu_torch.ops.corr) against the JAX package's Pallas ``fused_lookup``
run in interpret mode, at the JAX kernel suite's 1e-5; and the dispatch of
``raft_tpu_torch.ops.corr_cuda`` on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.corr import fmap2_pyramid as jax_pyramid
from raft_tpu.ops.corr_pallas import fused_lookup as jax_fused_lookup
from raft_tpu_torch.ops import corr_cuda
from raft_tpu_torch.ops.corr import fmap2_pyramid, lookup_blockwise_onehot

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, H, W, C, L, spread, far_share=0.0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(1, H, W, C).astype(np.float32)
    f2 = rng.randn(1, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = np.stack([xs, ys], -1)[None].astype(np.float32)
    coords = base + rng.uniform(-spread, spread, base.shape).astype(np.float32)
    far = rng.rand(1, H, W) < far_share
    coords[far] += np.float32([-60.0, 90.0])          # wholly outside the map
    return f1, f2, coords.astype(np.float32)


def _both(f1, f2, coords, L, radius):
    want = np.asarray(jax_fused_lookup(
        jnp.asarray(f1), tuple(jax_pyramid(jnp.asarray(f2), L)),
        jnp.asarray(coords), radius))
    got = lookup_blockwise_onehot(
        torch.from_numpy(f1), fmap2_pyramid(torch.from_numpy(f2), L),
        torch.from_numpy(coords), radius, chunk=32).numpy()
    return got, want


@pytest.mark.parametrize("H,W,L,radius,spread,far", [
    (6, 8, 3, 4, 7.0, 0.25),     # windows straddle edges, some far outside
    (6, 8, 4, 4, 3.0, 0.0),      # level 3 is 0x1: a degenerate level
    (7, 9, 2, 3, 5.0, 0.1),      # radius 3, odd sizes
], ids=["straddle_far", "zero_level", "radius3"])
def test_plain_lookup_matches_jax_kernel(H, W, L, radius, spread, far):
    f1, f2, coords = _case(0, H, W, 32, L, spread, far)
    got, want = _both(f1, f2, coords, L, radius)
    assert got.shape == want.shape == (1, H, W, L * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_is_x_offset_major():
    """At integer coordinates the window holds raw correlations; channel
    ``ix * n + iy`` must hold the one at (x + ix - r, y + iy - r)."""
    H, W, C, r = 5, 6, 8, 1
    f1, f2, _ = _case(1, H, W, C, 1, 0.0)
    coords = np.zeros((1, H, W, 2), np.float32)
    coords[..., 0], coords[..., 1] = 2.0, 3.0           # every query at (2, 3)
    got = lookup_blockwise_onehot(torch.from_numpy(f1),
                                  [torch.from_numpy(f2)],
                                  torch.from_numpy(coords), r).numpy()
    n = 2 * r + 1
    for ix in range(n):
        for iy in range(n):
            want = f1[0, 0, 0] @ f2[0, 3 + iy - r, 2 + ix - r] / np.sqrt(C)
            np.testing.assert_allclose(got[0, 0, 0, ix * n + iy], want, **TOL)


def test_cpu_tensor_takes_plain_path_and_counter_stays():
    f1, f2, coords = _case(2, 6, 8, 16, 2, 4.0, 0.2)
    before = corr_cuda.corr_lookup_cuda.launches
    lookup = corr_cuda.make_fused_lookup(torch.from_numpy(f1),
                                         torch.from_numpy(f2), 2, 4)
    got = lookup(torch.from_numpy(coords))
    want = lookup_blockwise_onehot(torch.from_numpy(f1),
                                   fmap2_pyramid(torch.from_numpy(f2), 2),
                                   torch.from_numpy(coords), 4)
    assert corr_cuda.corr_lookup_cuda.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_entry_refuses_cpu_tensors_and_backward_raises():
    f1, f2, coords = _case(3, 4, 4, 8, 1, 1.0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_lookup_cuda(t(f1), [t(f2)], t(coords), 4)
    f1g = t(f1).requires_grad_(True)
    out = corr_cuda.fused_lookup(f1g, [t(f2)], t(coords), 1)
    with pytest.raises(NotImplementedError, match="item 7"):
        out.sum().backward()


@pytest.mark.parametrize("wrapper", ["corr_lookup_cuda", "corr_window_cuda",
                                     "corr_ragged_cuda", "corr_packed_cuda"])
def test_empty_query_grid_launches_nothing_and_counts_nothing(monkeypatch,
                                                             wrapper):
    """A wrapper adds to its count only where it launches: a query grid with
    no query launches nothing.  The device check is bypassed so that the
    CPU can drive the wrapper past it; loading a kernel fails the test."""
    def no_device_check(entry, fmap1, f2_levels, coords, radius):
        return [d for f2 in f2_levels for d in f2.shape[1:3]]

    def no_kernel(*args):
        raise AssertionError("a kernel was loaded for an empty query grid")

    monkeypatch.setattr(corr_cuda, "_check_lookup", no_device_check)
    monkeypatch.setattr(corr_cuda, "_fn", no_kernel)
    fn = getattr(corr_cuda, wrapper)
    f1 = torch.zeros(2, 0, 8, 16)
    levels = [torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 4, 16)]
    coords = torch.zeros(2, 0, 8, 2)
    extra = ((torch.tensor([[0, 8], [0, 4]], dtype=torch.int32),)
             if wrapper == "corr_ragged_cuda" else ())
    before = fn.launches
    out = fn(f1, levels, coords, *extra, 3)
    assert fn.launches == before
    assert tuple(out.shape) == (2, 0, 8, 2 * 49)
