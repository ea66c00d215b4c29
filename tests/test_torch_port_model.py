"""The PyTorch port's full raft-things model against the JAX package:
same seeded frames, weights converted from JAX ``init_raft`` through
``from_jax_params`` (its zero conv biases, or biases and batch-norm affines
drawn away from zero and identity), every iteration's flow held to the
full-model bound of tests/test_torch_golden.py (``1e-3 + 1e-3 *
max|flow|``); the npz weight bridge; the float32 entry points' TF32
switches; and every configuration value of the JAX package accepted."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.convert.weights import save_params_npz
from raft_tpu.models import init_raft
from raft_tpu.models.raft import raft_forward as jax_forward
import raft_tpu_torch as rt

torch.set_num_threads(2)   # several test workers share the host's cores


BIASED = pytest.mark.parametrize("biased", [False, True],
                                 ids=["zero_bias", "biased"])


def with_biases(params, seed=0):
    """``params`` with every conv bias and batch-norm ``beta`` drawn from
    U(-0.25, 0.25) and every batch-norm ``gamma`` from U(0.75, 1.25), with
    numpy from a seed of their own (the other leaves unchanged), so that
    the bias and affine paths carry real values."""
    rng = np.random.RandomState(seed + 1000)

    def fill(path, leaf):
        name = path[-1].key
        if name not in ("b", "gamma", "beta"):
            return leaf
        lo, hi = (0.75, 1.25) if name == "gamma" else (-0.25, 0.25)
        return jnp.asarray(rng.uniform(lo, hi, leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, params)


def _jax_params(cfg, seed=0, biased=False):
    """JAX init with non-trivial batch-norm statistics, so eval-mode
    normalization is exercised; ``biased``: :func:`with_biases` on top."""
    params = init_raft(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed + 1)

    def bn(node):
        for v in node.values():
            if isinstance(v, dict):
                if "mean" in v:
                    v["mean"] = jnp.asarray(rng.uniform(
                        -0.05, 0.05, v["mean"].shape).astype(np.float32))
                    v["var"] = jnp.asarray(rng.uniform(
                        0.9, 1.1, v["var"].shape).astype(np.float32))
                else:
                    bn(v)
    bn(params)
    return with_biases(params, seed) if biased else params


@BIASED
def test_full_model_every_iteration_matches_jax_pallas(biased):
    """Full widths at 48x64 (a 6x8 grid, so pyramid level 3 is 0x1), two
    iterations, JAX with corr_impl='pallas' (interpret mode) and
    gru_impl='pallas' against the port with the same configuration."""
    jcfg = JaxConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    params = _jax_params(jcfg, biased=biased)
    im = np.random.RandomState(3).rand(2, 1, 48, 64, 3).astype(np.float32)
    out, _ = jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]), jcfg,
                         all_flows=True)
    want = np.asarray(out.flow_iters)

    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    got = rt.raft_forward(model.eval(), torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]), cfg, all_flows=True)
    got = got.flow_iters.numpy()
    assert got.shape == want.shape == (2, 1, 48, 64, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-3 + 1e-3 * scale, (
            f"iter {i}: max|Δflow|={err:.2e} vs scale {scale:.2e}")


def test_kernel_and_plain_configs_agree_on_cpu():
    """On CPU tensors the 'pallas' names run the plain versions, so the two
    configurations give identical flows."""
    model = rt.init_raft_torch(rt.RAFTConfig.full(), device="cpu")
    im = torch.from_numpy(np.random.RandomState(4).rand(2, 1, 32, 40, 3)
                          .astype(np.float32))
    k = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    p = dataclasses.replace(k, corr_impl="blockwise", gru_impl="xla")
    a = rt.raft_forward(model, im[0], im[1], k).flow
    b = rt.raft_forward(model, im[0], im[1], p).flow
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_npz_checkpoint_round_trip_loads_strict(tmp_path):
    """A checkpoint the JAX package saves loads into the port with
    strict=True, every tensor equal to the direct conversion."""
    params = _jax_params(JaxConfig.full(), seed=5)
    path = tmp_path / "params.npz"
    save_params_npz(params, path)
    sd = rt.from_jax_params(rt.load_params_npz(path))
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(sd, strict=True)
    direct = rt.from_jax_params(params)
    assert set(sd) == set(direct) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, direct[k], rtol=0, atol=0)


@pytest.mark.parametrize("overrides", [
    dict(pallas_pack=True),
    dict(pallas_pack=True, pallas_p_select="window"),
    dict(compute_dtype="bfloat16", corr_precision="default",
         pallas_pack=True, pallas_p_select="window", pallas_p_blk=1024),
    dict(compute_dtype="bfloat16", corr_precision="default"),
    dict(small=True, gru_impl="xla"),
    dict(corr_impl="dense"),
    dict(quant="bf16w"),
    dict(quant="int8+bf16w"),
    dict(iters_policy="converge:0.5"),
    dict(quant="int8"),
    dict(corr_impl="blockwise", corr_lookup="gather"),
    dict(corr_impl="blockwise", gru_impl="xla", gru_ctx_hoist=False),
], ids=["P32_all", "P32_window", "BF", "bf16corr_ctx_gru", "small=True,gru_impl=xla",
        "corr_impl=dense", "quant=bf16w", "quant=int8+bf16w",
        "iters_policy=converge:0.5", "quant=int8",
        "corr_impl=blockwise,corr_lookup=gather",
        "corr_impl=blockwise,gru_impl=xla,gru_ctx_hoist=False"])
def test_slice_configurations_are_accepted(overrides):
    cfg = rt.RAFTConfig.full(**{"corr_impl": "pallas", "gru_impl": "pallas",
                                **overrides})
    rt.check_port_support(cfg)
    rt.make_inference_fn(cfg, device="cpu")


def test_ragged_with_pack_runs_the_ragged_lookup(monkeypatch):
    """pallas_pack=True does not apply to a ragged batch (as in JAX): the
    ragged lookup (B4's path) runs, the packed one never, and the flow is
    bitwise that of pallas_pack=False."""
    from raft_tpu_torch.ops import corr_cuda
    calls = {"ragged": 0, "packed": 0}
    for name, key in (("ragged_lookup", "ragged"), ("packed_lookup", "packed")):
        def spy(*a, _f=getattr(corr_cuda, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(corr_cuda, name, spy)
    model = rt.init_raft_torch(rt.RAFTConfig.full(), device="cpu")
    rng = np.random.RandomState(9)
    im = rng.rand(2, 2, 24, 32, 3).astype(np.float32)
    sizes = np.array([[24, 32], [17, 21]], np.int32)
    flows = [rt.make_ragged_inference_fn(rt.RAFTConfig.full(
        corr_impl="pallas", gru_impl="pallas", pallas_pack=pack, iters=2),
        device="cpu")(model, im[0], im[1], sizes) for pack in (True, False)]
    assert calls == {"ragged": 4, "packed": 0}
    torch.testing.assert_close(flows[0], flows[1], rtol=0, atol=0)


def test_small_sizes_and_bad_knobs_raise():
    with pytest.raises(ValueError, match="3x3 ConvGRU"):
        rt.check_port_support(rt.RAFTConfig.small_model(gru_impl="pallas"))
    with pytest.raises(ValueError, match="lookup_style"):
        rt.check_port_support(rt.RAFTConfig.full(pallas_lookup_style="mxu"))
    with pytest.raises(ValueError, match="block_rows"):
        rt.check_port_support(rt.RAFTConfig.full(gru_block_rows=2))
    model = rt.init_raft_torch(rt.RAFTConfig.full(), device="cpu")
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1)
    im = torch.zeros(1, 20, 24, 3)
    with pytest.raises(ValueError, match="divisible by 8"):
        rt.raft_forward(model, im, im, cfg)
    im = torch.zeros(1, 16, 24, 3)
    with pytest.raises(ValueError, match="sizes"):
        rt.raft_forward(model, im, im, cfg, sizes=torch.tensor([[16, 24, 3]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_entry_points_turn_tf32_off_and_restore_the_flags(
        monkeypatch, dtype):
    """Under PyTorch's defaults (cuDNN TF32 on) and with cuBLAS TF32 on too,
    the three inference functions run a float32 forward with both off and
    leave both as the caller set them, also when the forward raises; the
    bf16 policy's forward runs under the caller's flags."""
    from raft_tpu_torch.models import raft as port_raft
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen, real = [], port_raft._iterate_flow

    def spy(model, fmap1, fmap2, net, inp, config, iters, *args):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        if iters == 0:
            raise RuntimeError("forward failed")
        return real(model, fmap1, fmap2, net, inp, config, iters, *args)

    monkeypatch.setattr(port_raft, "_iterate_flow", spy)
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1,
                             compute_dtype=dtype)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = np.random.RandomState(11).rand(2, 1, 16, 24, 3).astype(np.float32)
    sizes = np.array([[16, 24]], np.int32)
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        rt.make_inference_fn(cfg, device="cpu")(model, im[0], im[1])
        rt.make_ragged_inference_fn(cfg, device="cpu")(model, im[0], im[1], sizes)
        rt.make_ragged_counted_inference_fn(cfg, device="cpu")(
            model, im[0], im[1], sizes)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with pytest.raises(RuntimeError, match="forward failed"):
            rt.make_inference_fn(cfg, iters=0, device="cpu")(model, im[0], im[1])
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    inside = (False, False) if dtype == "float32" else (True, True)
    assert seen == [inside] * 4


@pytest.mark.parametrize("ragged", [False, True], ids=["pairwise", "ragged"])
def test_inference_functions_run_eager_on_cpu(ragged):
    """On ``device="cpu"`` the three factories capture nothing (``fn.graphs``
    is None) and return ``raft_forward``'s flow bitwise, and its
    ``iters_used``; fresh tensors on every call."""
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = np.random.RandomState(12).rand(2, 2, 16, 24, 3).astype(np.float32)
    sizes = np.array([[16, 24], [9, 13]], np.int32) if ragged else None
    want = rt.raft_forward(model, torch.from_numpy(im[0]),
                           torch.from_numpy(im[1]), cfg,
                           sizes=None if sizes is None else torch.from_numpy(sizes))
    if ragged:
        fns = [rt.make_ragged_inference_fn(cfg, device="cpu"),
               rt.make_ragged_counted_inference_fn(cfg, device="cpu")]
        outs = [fn(model, im[0], im[1], sizes) for fn in fns]
        flow, (flow2, used) = outs
        torch.testing.assert_close(flow2, want.flow, rtol=0, atol=0)
        torch.testing.assert_close(used, want.iters_used, rtol=0, atol=0)
    else:
        fns = [rt.make_inference_fn(cfg, device="cpu")]
        flow = fns[0](model, im[0], im[1])
        assert fns[0](model, im[0], im[1]) is not flow
    assert all(fn.graphs is None for fn in fns)
    torch.testing.assert_close(flow, want.flow, rtol=0, atol=0)
