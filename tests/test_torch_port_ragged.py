"""The port's ragged mixed-resolution path and window-scheduled lookup
against the JAX package: the plain versions of the two CUDA lookups
(``lookup_ragged_plain``, ``lookup_window_plain``) against the Pallas
kernels in interpret mode at the JAX kernel suite's 1e-5, the full model
with ``sizes=`` and with ``pallas_p_select='window'`` against JAX at the
full-model bound ``1e-3 + 1e-3 * max|flow|``, the dead-region contract,
``embed_to_shape`` and the ragged entry points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.data.pipeline import embed_to_shape as jax_embed_to_shape
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.ops.corr_pallas import make_fused_lookup as jax_make_fused_lookup
from raft_tpu.ops.corr_pallas import (
    make_ragged_fused_lookup as jax_make_ragged_lookup)
import raft_tpu_torch as rt
from raft_tpu_torch.ops import corr_cuda
from raft_tpu_torch.ops.corr import (fmap2_pyramid, lookup_blockwise_onehot,
                                     lookup_ragged_plain,
                                     lookup_window_plain, mask_ragged_rows,
                                     ragged_pyramid)
from test_torch_port_model import BIASED, _jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _ragged_case(sizes, Hm, Wm, C, seed=0):
    """Crops zero-embedded in the max box, coords = grid + 3 px noise (the
    JAX suite's ``tests/test_ragged.py`` case)."""
    rng = np.random.RandomState(seed)
    B = len(sizes)
    f1 = np.zeros((B, Hm, Wm, C), np.float32)
    f2 = np.zeros((B, Hm, Wm, C), np.float32)
    for b, (h, w) in enumerate(sizes):
        f1[b, :h, :w] = rng.randn(h, w, C)
        f2[b, :h, :w] = rng.randn(h, w, C)
    ys, xs = np.meshgrid(np.arange(Hm), np.arange(Wm), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].astype(np.float32)
    coords = grid + 3.0 * rng.randn(B, Hm, Wm, 2).astype(np.float32)
    return f1, f2, coords


@pytest.mark.parametrize("sizes,Hm,Wm,C,levels,radius", [
    ([(16, 24), (8, 8), (13, 19)], 16, 24, 32, 3, 4),   # odd extent included
    ([(12, 16), (12, 16)], 12, 16, 16, 3, 3),           # all items at the box
    ([(8, 8)], 10, 14, 8, 2, 2),                        # solo, odd max box
    ([(16, 24), (3, 5)], 16, 24, 16, 3, 4),             # item 1: no live row
                                                        # at level 2
], ids=["odd_extent", "full_box", "solo_odd_box", "empty_coarse_levels"])
def test_ragged_plain_matches_jax_ragged_kernel(sizes, Hm, Wm, C, levels,
                                                radius):
    f1, f2, coords = _ragged_case(sizes, Hm, Wm, C)
    sz = np.asarray(sizes, np.int32)
    want = np.asarray(jax_make_ragged_lookup(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(sz), levels,
        radius)(jnp.asarray(coords)))
    t = torch.from_numpy
    s8 = t(sz)
    plain = lookup_ragged_plain(mask_ragged_rows(t(f1), s8),
                                ragged_pyramid(t(f2), s8, levels), t(coords),
                                s8, radius, chunk=40).numpy()
    before = corr_cuda.corr_ragged_cuda.launches
    wrapped = corr_cuda.make_ragged_fused_lookup(
        t(f1), t(f2), s8, levels, radius)(t(coords)).numpy()
    assert corr_cuda.corr_ragged_cuda.launches == before   # CPU: plain
    np.testing.assert_array_equal(wrapped, plain)
    nn = (2 * radius + 1) ** 2
    for b, (h, w) in enumerate(sizes):
        np.testing.assert_allclose(plain[b, :h, :w], want[b, :h, :w], **TOL)
        dead = plain[b].copy()
        dead[:h, :w] = 0
        assert np.abs(dead).max() == 0.0, f"item {b}: dead query nonzero"
        for lvl in range(levels):       # a level with no live row or column
            if (h >> lvl) == 0 or (w >> lvl) == 0:
                block = (slice(None), slice(None), slice(lvl * nn, (lvl + 1) * nn))
                assert np.abs(want[b][block]).max() == 0.0
                assert np.abs(plain[b][block]).max() == 0.0


def test_ragged_pyramid_equals_each_crops_own_pyramid():
    """Masking before each pool reproduces the crop's own pyramid at odd
    extents (29 -> 14 -> 7 rows, 19 -> 9 -> 4 columns)."""
    rng = np.random.RandomState(7)
    f2 = torch.from_numpy(rng.randn(1, 32, 24, 4).astype(np.float32))
    levels = ragged_pyramid(f2, torch.tensor([[29, 19]]), 3)
    own = fmap2_pyramid(f2[:, :29, :19], 3)
    for lv, o in zip(levels, own):
        h, w = o.shape[1:3]
        torch.testing.assert_close(lv[:, :h, :w], o, rtol=0, atol=0)
        assert float(lv[:, h:].abs().max()) == 0.0
        assert float(lv[:, :, w:].abs().max()) == 0.0


@pytest.mark.parametrize("H,W,L,radius,spread,far", [
    (32, 12, 2, 4, 2.0, 0.0),     # local windows: the schedule skips blocks
    (40, 10, 3, 3, 5.0, 0.15),    # radius 3, some queries far outside
], ids=["local", "radius3_far"])
def test_window_lookup_matches_jax_window_kernel(H, W, L, radius, spread, far):
    """p_blk_target=1024 gives 8-row blocks at level 0 (W padded to 128
    lanes), so local windows visit a few of the blocks only."""
    rng = np.random.RandomState(11)
    C = 16
    f1 = rng.randn(1, H, W, C).astype(np.float32)
    f2 = rng.randn(1, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None]
              + rng.uniform(-spread, spread, (1, H, W, 2))).astype(np.float32)
    coords[rng.rand(1, H, W) < far] += np.float32([-50.0, 120.0])
    want = np.asarray(jax_make_fused_lookup(
        jnp.asarray(f1), jnp.asarray(f2), L, radius, p_select="window",
        p_blk_target=1024)(jnp.asarray(coords)))
    t = torch.from_numpy
    plain = lookup_window_plain(t(f1), fmap2_pyramid(t(f2), L), t(coords),
                                radius, chunk=64).numpy()
    before = corr_cuda.corr_window_cuda.launches
    wrapped = corr_cuda.make_window_lookup(t(f1), t(f2), L, radius)(
        t(coords)).numpy()
    assert corr_cuda.corr_window_cuda.launches == before
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(wrapped, want, **TOL)


def _assert_every_iteration(got, want, crops):
    assert got.shape == want.shape
    for i, (g, w) in enumerate(zip(got, want)):
        for b, (h, wd) in enumerate(crops):
            gb, wb = g[b, :h, :wd], w[b, :h, :wd]
            err, scale = np.abs(gb - wb).max(), np.abs(wb).max()
            assert err <= 1e-3 + 1e-3 * scale, (
                f"iter {i} item {b}: max|dflow|={err:.2e} vs scale {scale:.2e}")


def _both_models(jcfg, cfg, im, sizes=None, biased=False):
    params = _jax_params(jcfg, biased=biased)
    out, _ = jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]), jcfg,
                         all_flows=True,
                         sizes=None if sizes is None else jnp.asarray(sizes))
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    got = rt.raft_forward(model.eval(), torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]), cfg, all_flows=True,
                          sizes=None if sizes is None else torch.from_numpy(sizes))
    return got.flow_iters.numpy(), np.asarray(out.flow_iters)


@BIASED
def test_full_model_ragged_every_iteration_matches_jax(biased):
    """Full widths, a 48x64 box holding a 48x64 and a 29x40 item (odd live
    extent, not a multiple of 8), two iterations; JAX runs the ragged
    Pallas kernel (interpret mode) and the Pallas GRU."""
    sizes = np.array([[48, 64], [29, 40]], np.int32)
    im = np.random.RandomState(5).rand(2, 2, 48, 64, 3).astype(np.float32)
    got, want = _both_models(
        JaxConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2),
        rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2),
        im, sizes, biased)
    assert got.shape == (2, 2, 48, 64, 2)
    _assert_every_iteration(got, want, sizes)


@BIASED
def test_full_model_window_every_iteration_matches_jax(biased):
    """The main path with pallas_p_select='window' at 48x64, both packages."""
    kw = dict(corr_impl="pallas", gru_impl="pallas", iters=2,
              pallas_p_select="window")
    im = np.random.RandomState(6).rand(2, 1, 48, 64, 3).astype(np.float32)
    got, want = _both_models(JaxConfig.full(**kw), rt.RAFTConfig.full(**kw),
                             im, biased=biased)
    assert got.shape == (2, 1, 48, 64, 2)
    _assert_every_iteration(got, want, [(48, 64)])


def _ragged_batch(rng, box, crops):
    ims = np.zeros((2, len(crops)) + box + (3,), np.float32)
    for b, (h, w) in enumerate(crops):
        for f in range(2):
            ims[f, b, :h, :w] = rng.rand(h, w, 3)
    return ims


def test_dead_region_garbage_changes_nothing_and_solo_matches_mixed():
    """Random pixels in the dead region leave every live crop bitwise
    equal; each item run alone in the same box matches its row of the
    mixed batch."""
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    model = rt.init_raft_torch(cfg, device="cpu")
    fn = rt.make_ragged_inference_fn(cfg, device="cpu")
    rng = np.random.RandomState(8)
    crops = [(40, 48), (21, 30)]
    sizes = np.array(crops, np.int32)
    ims = _ragged_batch(rng, (40, 48), crops)
    base = fn(model, ims[0], ims[1], sizes).numpy()
    noisy = ims.copy()
    for b, (h, w) in enumerate(crops):
        junk = rng.rand(*noisy[:, b].shape).astype(np.float32)
        junk[:, :h, :w] = noisy[:, b, :h, :w]
        noisy[:, b] = junk
    again = fn(model, noisy[0], noisy[1], sizes).numpy()
    for b, (h, w) in enumerate(crops):
        np.testing.assert_array_equal(again[b, :h, :w], base[b, :h, :w])
        solo = fn(model, ims[0, b:b + 1], ims[1, b:b + 1],
                  sizes[b:b + 1]).numpy()
        scale = np.abs(base[b, :h, :w]).max()
        assert np.abs(solo[0, :h, :w] - base[b, :h, :w]).max() <= (
            1e-3 + 1e-3 * scale)


def test_embed_to_shape_round_trip_matches_jax():
    rng = np.random.RandomState(9)
    im = rng.rand(2, 29, 40, 3).astype(np.float32)
    out = rt.embed_to_shape(im, (32, 48))
    assert out.shape == (2, 32, 48, 3)
    np.testing.assert_array_equal(out[:, :29, :40], im)
    assert np.abs(out[:, 29:]).max() == 0 and np.abs(out[:, :, 40:]).max() == 0
    np.testing.assert_array_equal(out, jax_embed_to_shape(im, (32, 48)))
    with pytest.raises(ValueError, match="exceeds"):
        rt.embed_to_shape(im, (24, 48))


def test_ragged_entry_points_need_cuda_unless_cpu_is_asked_for():
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1)
    makers = (rt.make_ragged_inference_fn, rt.make_ragged_counted_inference_fn)
    if not torch.cuda.is_available():
        for make in makers:
            with pytest.raises(RuntimeError, match="CUDA"):
                make(cfg)
    model = rt.init_raft_torch(cfg, device="cpu")
    ims = _ragged_batch(np.random.RandomState(10), (16, 24), [(16, 24), (11, 13)])
    sizes = np.array([[16, 24], [11, 13]], np.int32)
    flow = makers[0](cfg, device="cpu")(model, ims[0], ims[1], sizes)
    flow2, used = makers[1](cfg, device="cpu")(model, ims[0], ims[1], sizes)
    assert flow.device.type == "cpu" and tuple(flow.shape) == (2, 16, 24, 2)
    assert bool(torch.isfinite(flow).all())
    torch.testing.assert_close(flow2, flow, rtol=0, atol=0)
    assert used.tolist() == [1, 1]


def test_ragged_kernel_entries_refuse_cpu_tensors_and_backward_raises():
    """The kernel entries refuse CPU tensors; the wrappers' backward (which
    raised before training was ported, hence the name) is the vjp of
    ``lookup_blockwise_onehot``, as the JAX package defines it."""
    f1, f2, coords = _ragged_case([(8, 8)], 8, 8, 8)
    t = torch.from_numpy
    s8 = torch.tensor([[8, 8]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_window_cuda(t(f1), [t(f2)], t(coords), 4)
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_ragged_cuda(t(f1), [t(f2)], t(coords), s8, 4)
    f1w = t(f1).requires_grad_(True)
    lookup_blockwise_onehot(f1w, [t(f2)], t(coords), 1).sum().backward()
    for lookup in (lambda a: corr_cuda.window_lookup(a, [t(f2)], t(coords), 1),
                   lambda a: corr_cuda.ragged_lookup(a, [t(f2)], t(coords),
                                                     s8, 1)):
        f1g = t(f1).requires_grad_(True)
        lookup(f1g).sum().backward()
        torch.testing.assert_close(f1g.grad, f1w.grad, rtol=0, atol=0)
