"""The port's dense correlation path (``corr_impl='dense'``, the JAX
package's default) against the JAX package: ``dense_corr``,
``build_pyramid``, ``lookup_dense_onehot`` and ``lookup_dense`` at
rtol = atol = 1e-5 (the JAX suite's tolerance for the lookups; float32
sums in other orders, ~1e-6 apart); the full model under 'dense' with
both lookups, and a ragged batch under 'dense' (the masked blockwise twin,
as in JAX), at every iteration at the full-model bound ``1e-3 + 1e-3 *
max|flow|`` of tests/test_torch_golden.py; and 'dense' equal to
'blockwise' within 1e-5 lookup for lookup."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.ops import corr as jcorr
import raft_tpu_torch as rt
from raft_tpu_torch.ops import corr
from test_torch_port_model import BIASED
from test_torch_port_pack import seeded_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)

_jax_forward = jax.jit(jax_forward, static_argnames=("config", "all_flows"))


def _case(seed=0, B=2, H=7, W=9, C=24, L=3, spread=4.0):
    """Seeded maps, and coords = grid + noise of +-``spread`` px with an
    eighth of the queries wholly outside the map."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-spread, spread, coords.shape).astype(np.float32)
    coords[rng.rand(B, H, W) < 0.125] += np.float32([-40.0, 30.0])
    return f1, f2, coords


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32 if a.dtype.kind == "f"
                                     else a.dtype))


def test_dense_corr_and_build_pyramid_match_jax():
    """C = 24 (sqrt(C) not exact: the division rounds as JAX's) over 3
    levels of a 7x9 map (levels 7x9, 3x4, 1x2)."""
    f1, f2, _ = _case()
    want = jcorr.build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    got = corr.build_pyramid(_t(f1), corr.fmap2_pyramid(_t(f2), 3))
    assert [tuple(g.shape) for g in got] == [(2, 63, 7, 9), (2, 63, 3, 4),
                                              (2, 63, 1, 2)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        corr.dense_corr(_t(f1), _t(f2)).numpy(),
        np.asarray(jcorr.dense_corr(jnp.asarray(f1), jnp.asarray(f2))), **TOL)


@pytest.mark.parametrize("lookup", ["onehot", "gather"])
@pytest.mark.parametrize("radius,spread", [(3, 4.0), (4, 12.0)],
                         ids=["r3", "r4_far"])
def test_dense_lookups_match_jax(lookup, radius, spread):
    """Both lookups on JAX's own pyramid, windows inside, across and wholly
    outside the map, at radius 3 (raft-small) and 4 (raft-things)."""
    f1, f2, coords = _case(1, spread=spread)
    jp = jcorr.build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    jfn = jcorr.lookup_dense_onehot if lookup == "onehot" else jcorr.lookup_dense
    want = np.asarray(jax.jit(jfn, static_argnames=("radius",))(
        jp, jnp.asarray(coords), radius=radius))
    pyramid = [_t(np.asarray(p)) for p in jp]
    fn = corr.lookup_dense_onehot if lookup == "onehot" else corr.lookup_dense
    got = fn(pyramid, _t(coords), radius).numpy()
    assert got.shape == want.shape == (2, 7, 9, 3 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("lookup", ["onehot", "gather"])
def test_dense_equals_blockwise(lookup):
    """The dense pyramid sampled by either lookup gives the blockwise
    lookup's values (no volume) within 1e-5, a level pooled away to 0x0
    included (zeros)."""
    f1, f2, coords = _case(2, H=6, W=8, L=4)
    f1t, levels = corr.lookup_operands(_t(f1), _t(f2), 4)
    assert tuple(levels[3].shape[1:3]) == (0, 1)
    fn = corr.lookup_dense_onehot if lookup == "onehot" else corr.lookup_dense
    got = fn(corr.build_pyramid(f1t, levels), _t(coords), 3)
    want = corr.lookup_blockwise_onehot(f1t, levels, _t(coords), 3)
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[..., 3 * 49:].abs().max()) == 0.0


def _model(cfg, params):
    model = rt.RAFT(cfg)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return model.eval()


def _every_iteration(got, want, crops):
    for i in range(want.shape[0]):
        for b, (h, w) in enumerate(crops):
            g, x = got[i, b, :h, :w], want[i, b, :h, :w]
            err, scale = np.abs(g - x).max(), np.abs(x).max()
            assert err <= 1e-3 + 1e-3 * scale, (i, b, err, scale)


@BIASED
@pytest.mark.parametrize("lookup", ["onehot", "gather"])
def test_full_model_dense_every_iteration_matches_jax(lookup, biased):
    """``RAFTConfig.full()`` as it stands (dense, xla GRU), each lookup, at
    48x64 (levels 6x8 .. 0x1), two iterations."""
    kw = dict(corr_lookup=lookup, iters=2)
    params = seeded_jax_params(JaxConfig.full(), biased=biased)
    im = np.random.RandomState(3).rand(2, 1, 48, 64, 3).astype(np.float32)
    out, _ = _jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]),
                          config=JaxConfig.full(**kw), all_flows=True)
    got = rt.raft_forward(_model(rt.RAFTConfig.full(), params), _t(im[0]),
                          _t(im[1]), rt.RAFTConfig.full(**kw),
                          all_flows=True).flow_iters.numpy()
    assert got.shape == (2, 1, 48, 64, 2)
    _every_iteration(got, np.asarray(out.flow_iters), [(48, 64)])


@BIASED
def test_ragged_dense_runs_the_masked_twin_and_matches_jax(biased,
                                                          monkeypatch):
    """A ragged batch (a 48x64 box holding a 48x64 and a 29x40 item) under
    'dense' builds no volume: it runs the masked blockwise twin, as JAX
    does, so its flow is bitwise the ragged 'blockwise' flow, and matches
    JAX's ragged 'dense' forward on each live crop."""
    from raft_tpu_torch.models import raft as port_raft
    built = []
    monkeypatch.setattr(port_raft, "build_pyramid",
                        lambda *a: built.append(1) or corr.build_pyramid(*a))
    params = seeded_jax_params(JaxConfig.full(), biased=biased)
    model = _model(rt.RAFTConfig.full(), params)
    sizes = np.array([[48, 64], [29, 40]], np.int32)
    im = np.random.RandomState(4).rand(2, 2, 48, 64, 3).astype(np.float32)
    out, _ = _jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]),
                          config=JaxConfig.full(iters=2), all_flows=True,
                          sizes=jnp.asarray(sizes))
    flows = {c: rt.raft_forward(model, _t(im[0]), _t(im[1]),
                                rt.RAFTConfig.full(corr_impl=c, iters=2),
                                all_flows=True, sizes=_t(sizes)).flow_iters
             for c in ("dense", "blockwise")}
    assert built == []
    torch.testing.assert_close(flows["dense"], flows["blockwise"], rtol=0, atol=0)
    _every_iteration(flows["dense"].numpy(), np.asarray(out.flow_iters),
                     sizes.tolist())
    rt.raft_forward(model, _t(im[0]), _t(im[1]), rt.RAFTConfig.full(iters=1))
    assert built == [1]                 # the pairwise batch builds it once


def test_default_configs_run_through_make_inference_fn_on_cpu():
    """``RAFTConfig()`` as it stands (dense) through the pairwise and the
    ragged entry points on the CPU: finite flows, and the pairwise flow
    equal to ``raft_forward``'s."""
    cfg = rt.RAFTConfig(iters=1)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = np.random.RandomState(5).rand(2, 1, 24, 32, 3).astype(np.float32)
    flow = rt.make_inference_fn(cfg, device="cpu")(model, im[0], im[1])
    torch.testing.assert_close(
        flow, rt.raft_forward(model, _t(im[0]), _t(im[1]), cfg).flow,
        rtol=0, atol=0)
    ragged = rt.make_ragged_inference_fn(cfg, device="cpu")(
        model, im[0], im[1], np.array([[19, 27]], np.int32))
    assert bool(torch.isfinite(ragged[0, :19, :27]).all())
