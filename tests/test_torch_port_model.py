"""The PyTorch port's full raft-things model against the JAX package:
same seeded frames, weights converted from JAX ``init_raft`` through
``from_jax_params``, every iteration's flow held to the full-model bound of
tests/test_torch_golden.py (``1e-3 + 1e-3 * max|flow|``); the npz weight
bridge; and the slice boundary (unported values raise)."""

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


def _jax_params(cfg, seed=0):
    """JAX init with non-trivial batch-norm statistics, so eval-mode
    normalization is exercised."""
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
    return params


def test_full_model_every_iteration_matches_jax_pallas():
    """Full widths at 48x64 (a 6x8 grid, so pyramid level 3 is 0x1), two
    iterations, JAX with corr_impl='pallas' (interpret mode) and
    gru_impl='pallas' against the port with the same configuration."""
    jcfg = JaxConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
    params = _jax_params(jcfg)
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
    dict(quant="bf16w"),
    dict(quant="int8+bf16w"),
    dict(iters_policy="converge:0.5"),
    dict(small=True, gru_impl="xla"),
    dict(quant="int8"),
    dict(corr_impl="dense"),
    dict(corr_impl="blockwise", corr_lookup="gather"),
    dict(corr_impl="blockwise", gru_impl="xla", gru_ctx_hoist=False),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_unported_values_raise_not_implemented(overrides):
    cfg = rt.RAFTConfig.full(**{"corr_impl": "pallas", "gru_impl": "pallas",
                                **overrides})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.check_port_support(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.make_inference_fn(cfg, device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(pallas_pack=True),
    dict(pallas_pack=True, pallas_p_select="window"),
    dict(compute_dtype="bfloat16", corr_precision="default",
         pallas_pack=True, pallas_p_select="window", pallas_p_blk=1024),
    dict(compute_dtype="bfloat16", corr_precision="default"),
], ids=["P32_all", "P32_window", "BF", "bf16corr_ctx_gru"])
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
    with pytest.raises(NotImplementedError, match="6b"):
        rt.RAFT(rt.RAFTConfig.small_model())
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
