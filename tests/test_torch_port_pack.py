"""The port's row-packed lookup (``pallas_pack=True``, the Pallas body
``_packed_body``) against the JAX package: the plain version of the CUDA
kernel (``lookup_packed_plain``) against ``_fused_lookup_impl(pack_rows=
True)`` run in interpret mode at the JAX kernel suite's 1e-5, on the
geometries of ``tests/test_corr_pallas.py`` with windows on sub-row
boundaries and outside the map; the pack predicate against the JAX plan;
the CPU dispatch; and the full model under ``pallas_pack=True`` against JAX
at the full-model bound ``1e-3 + 1e-3 * max|flow|``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.lint.budget import corr_level_plan
from raft_tpu.models import init_raft
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.ops.corr import fmap2_pyramid as jax_pyramid
from raft_tpu.ops.corr_pallas import _fused_lookup_impl
import raft_tpu_torch as rt
from raft_tpu_torch.ops import corr_cuda
from test_torch_port_model import BIASED, with_biases
from raft_tpu_torch.ops.corr import (fmap2_pyramid, lookup_blockwise_onehot,
                                     lookup_packed_plain, pack_factor,
                                     packed_levels_from)

torch.set_num_threads(2)   # several test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)


def seeded_jax_params(cfg, seed=0, biased=False):
    """A JAX parameter tree of ``init_raft``'s structure, drawn with numpy
    (no JAX random ops to run): convs Kaiming fan-out normal with zero
    biases (the JAX init scheme), batch-norm affine identity with
    non-trivial running statistics, so eval-mode normalization is
    exercised; ``biased``: the biases and affines of
    ``test_torch_port_model.with_biases`` instead."""
    shapes = jax.eval_shape(lambda k: init_raft(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "w":
            kh, kw, _, cout = leaf.shape
            a = rng.randn(*leaf.shape) * np.sqrt(2.0 / (kh * kw * cout))
        elif name == "mean":
            a = rng.uniform(-0.05, 0.05, leaf.shape)
        elif name == "var":
            a = rng.uniform(0.9, 1.1, leaf.shape)
        else:                                   # b, beta: 0; gamma: 1
            a = np.full(leaf.shape, 1.0 if name == "gamma" else 0.0)
        return jnp.asarray(a.astype(np.float32))

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return with_biases(params, seed) if biased else params


def _packed_case(seed, B, H, W, C, L):
    """Seeded maps and coords: grid + 3 px noise; an eighth of the queries
    wholly outside the map; and, per level, queries whose window starts
    exactly on the first and last column of a (packed) row and a half
    pixel inside them — the sub-row boundaries where a packed window could
    wrap into its neighbour row."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-3, 3, coords.shape).astype(np.float32)
    far = rng.rand(B, H, W) < 0.125
    coords[far] += np.float32([-70.0, 90.0])
    picks = rng.permutation(H * W)
    k = 0
    for lvl in range(L):
        w_l, s = W >> lvl, float(2 ** lvl)
        if w_l == 0:
            continue
        for x in (0.0, w_l - 1.0, 0.5, w_l - 1.5):
            q = picks[k % (H * W)]
            k += 1
            coords[:, q // W, q % W, 0] = x * s
    return f1, f2, coords


def _jax_packed(f1, f2, coords, L, radius, p_select):
    """JAX's row-packed Pallas lookup in interpret mode, jitted (one XLA
    program instead of eager grid steps: the same values, half the time)."""
    fn = jax.jit(_fused_lookup_impl, static_argnames=(
        "radius", "q_blk", "p_blk_target", "p_select", "pack_rows"))
    return np.asarray(fn(
        jnp.asarray(f1), tuple(jax_pyramid(jnp.asarray(f2), L)),
        jnp.asarray(coords), radius=radius, q_blk=64, p_blk_target=1024,
        p_select=p_select, pack_rows=True))


@pytest.mark.parametrize("B,H,W,C,L,radius", [
    (1, 24, 40, 32, 4, 4),    # pack 4/8 at coarse levels
    (2, 46, 62, 16, 4, 4),    # training fmap width: pack 2 at level 0
    (1, 12, 100, 8, 3, 3),    # W2=100: unpacked level 0, packed level 1+
], ids=["pack4_8", "level0_packed", "level0_wide"])
@pytest.mark.parametrize("p_select", ["all", "window"])
def test_packed_plain_matches_jax_packed_kernel(B, H, W, C, L, radius,
                                               p_select):
    f1, f2, coords = _packed_case(7, B, H, W, C, L)
    want = _jax_packed(f1, f2, coords, L, radius, p_select)
    t = torch.from_numpy
    got = lookup_packed_plain(t(f1), fmap2_pyramid(t(f2), L), t(coords),
                              radius, p_select, chunk=64).numpy()
    assert got.shape == want.shape == (B, H, W, L * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("w", [1, 2, 5, 16, 31, 32, 33, 63, 64, 65, 100, 128,
                               129, 256])
def test_pack_predicate_is_the_jax_plan(w):
    plan = corr_level_plan(64, 8, w, q_blk=128, p_blk_target=4096,
                           pack_rows=True)
    assert pack_factor(w) == plan.pack
    assert packed_levels_from([w]) == (0 if plan.pack > 1 else 1)


def test_packed_levels_are_the_pyramid_suffix():
    assert packed_levels_from([128, 64, 32, 16]) == 1    # 432x1024
    assert packed_levels_from([64, 32, 16, 8]) == 0      # FlyingChairs 384x512
    assert packed_levels_from([160, 80, 40, 20]) == 2
    assert packed_levels_from([256, 128]) == 2           # nothing packed
    assert packed_levels_from([8, 4, 2, 1, 0]) == 0      # a 0-wide level
    with pytest.raises(ValueError, match="suffix"):
        packed_levels_from([32, 128])


def test_cpu_dispatch_is_plain_and_counters_stay():
    f1, f2, coords = _packed_case(3, 1, 10, 16, 8, 3)
    t = torch.from_numpy
    counters = (corr_cuda.corr_packed_cuda, corr_cuda.corr_lookup_cuda,
                corr_cuda.corr_window_cuda)
    before = [k.launches for k in counters]
    for p_select, make in (("all", corr_cuda.make_fused_lookup),
                           ("window", corr_cuda.make_window_lookup)):
        got = make(t(f1), t(f2), 3, 4, pack=True)(t(coords))
        want = lookup_packed_plain(t(f1), fmap2_pyramid(t(f2), 3), t(coords),
                                   4, p_select)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        # the values are those of the unpacked lookup
        torch.testing.assert_close(got, lookup_blockwise_onehot(
            t(f1), fmap2_pyramid(t(f2), 3), t(coords), 4), **TOL)
    assert [k.launches for k in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_packed_cuda(t(f1), fmap2_pyramid(t(f2), 3), t(coords), 4)


@BIASED
@pytest.mark.parametrize("p_select", ["all", "window"])
def test_full_model_packed_matches_jax(p_select, biased):
    """P32 at 48x64 (a 6x8 grid: every level packs, level 3 is 0x1), two
    iterations, each within the full-model bound of JAX's same
    configuration (interpret-mode Pallas kernels)."""
    kw = dict(corr_impl="pallas", gru_impl="pallas", pallas_pack=True,
              pallas_p_select=p_select, pallas_p_blk=1024, iters=2)
    jcfg = JaxConfig.full(**kw)
    params = seeded_jax_params(jcfg, biased=biased)
    im = np.random.RandomState(3).rand(2, 1, 48, 64, 3).astype(np.float32)
    out, _ = jax.jit(jax_forward, static_argnames=("config", "all_flows"))(
        params, jnp.asarray(im[0]), jnp.asarray(im[1]), config=jcfg,
        all_flows=True)
    want = np.asarray(out.flow_iters)

    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    got = rt.raft_forward(model.eval(), torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]), rt.RAFTConfig.full(**kw),
                          all_flows=True).flow_iters.numpy()
    assert got.shape == want.shape == (2, 1, 48, 64, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-3 + 1e-3 * scale, (
            f"iter {i}: max|Δflow|={err:.2e} vs scale {scale:.2e}")
