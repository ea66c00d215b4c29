"""bfloat16 training (``compute_dtype='bfloat16'``) in the port against the
JAX package, on the CPU.

One train step of raft-things through BF (the bench's
pallas-bf16corr-ctx-gru-winpack configuration: the kernels' wrappers,
``corr_precision='default'``, row packing, the window schedule), at full
widths, 48x64, 2 iterations, batch 2, from float32 master weights, against
``jax.jit(make_train_step)`` of the same configuration, with the converted
weights (zero conv biases, and biases and batch-norm affines drawn away
from 0 and 1).  bfloat16 moves both packages away from float32 by far more
than float32 rounding moves them apart, so each is held within twice JAX's
own bf16-vs-f32 distance (the JAX float32 step of the main kernel
configuration): the loss; each gradient leaf in L2, plus the float32
bound of ``tests/torch_train_parity.py``; the running statistics.  The
masters and the optimizer's state stay float32 (the JAX npz layout), and
each package's AdamW step from its own gradient is held as in
``tests/test_torch_port_train_step.py``.  Under ``freeze_bn`` the
statistics come back bit for bit (JAX pins its side in
``tests/test_training.py``).

Then each wrapper's bfloat16 backward against the JAX package's on the
same bfloat16 inputs: ``_Lookup`` ('all', 'window', packed, ragged)
against ``_fused_lookup_bwd`` / ``_ragged_fused_lookup_bwd`` at
``corr_precision='default'``, ``_SepConvGRU`` against ``_gru_fused_bwd``
(the vjp of ``sep_conv_gru_xla``).  Every gradient has JAX's dtype
(bfloat16 for bfloat16 operands, float32 for the coordinates and the
fused float32 GRU weights) and lies within one bfloat16 ulp of the
gradient's magnitude (the two packages sum the float32 products in other
orders, then round once).  Measured on the CPU: fmap1's gradient 1 ulp
(an element of the top binade rounded the other way), the other
bfloat16 gradients at most 0.5, the float32 ones 3.1e-5 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.update import init_sep_conv_gru
from raft_tpu.ops.corr_pallas import (_fused_lookup_bwd,
                                      _ragged_fused_lookup_bwd)
from raft_tpu.ops.gru_pallas import _gru_fused_bwd
from raft_tpu.ops.gru_pallas import fuse_gru_weights as jax_fuse

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.convert import weights
from raft_tpu_torch.convert.weights import to_jax_train_state
from raft_tpu_torch.models.update import SepConvGRU, precompute_gru_ctx
from raft_tpu_torch.ops.conv import to_nchw
from raft_tpu_torch.ops import corr_cuda, gru_cuda
from raft_tpu_torch.ops.coords import coords_grid
from raft_tpu_torch.ops.corr import lookup_operands
from raft_tpu_torch.training import TrainState, make_optimizer, make_train_step

from test_torch_port_model import BIASED
from torch_train_parity import (LEAF_RTOL, JaxStep, check_first_update,
                                jax_first_grads, make_batch, make_params,
                                named, port_step, stage_kwargs)

torch.set_num_threads(2)   # several test workers share the host's cores

KERNELS = dict(corr_impl="pallas", gru_impl="pallas", iters=2)
BF = dict(KERNELS, compute_dtype="bfloat16", corr_precision="default",
          pallas_pack=True, pallas_p_select="window", pallas_p_blk=1024)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX float32 and BF steps, each compiled once (about 17 s)."""
    tc = JaxTrainConfig(**stage_kwargs())
    return JaxStep(JaxConfig.full(**KERNELS), tc), JaxStep(JaxConfig.full(**BF), tc)


def _dist(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b))


@BIASED
def test_bf16_train_step_matches_jax(jax_steps, biased):
    j32, j16 = jax_steps
    params = make_params(rt.RAFTConfig.full(), biased=biased)
    batch = make_batch(0)
    s32, m32 = j32(j32.create(params), batch)
    s16, m16 = j16(j16.create(params), batch)
    cfg, tc = rt.RAFTConfig.full(**BF), TrainConfig(**stage_kwargs())
    state, m, gp = port_step(cfg, tc, params, batch)

    lp, l16, l32 = (float(x["loss"]) for x in (m, m16, m32))
    assert np.isfinite(lp) and abs(lp - l16) <= 2 * abs(l16 - l32), \
        (lp, l16, l32)
    g32 = jax_first_grads(s32, m32, tc.clip_norm)
    g16 = jax_first_grads(s16, m16, tc.clip_norm)
    assert set(gp) == set(g16)
    for k, j in g16.items():
        bound = 2 * _dist(j, g32[k]) + LEAF_RTOL * np.linalg.norm(g32[k])
        assert _dist(gp[k], j) <= bound, (k, _dist(gp[k], j), bound)

    pn, jn, n32 = to_jax_train_state(state), named(s16), named(s32)
    assert set(pn) == set(jn)
    for k, v in jn.items():
        assert pn[k].dtype == v.dtype, k
        if k.startswith(("params/", "opt_state/inner_state/1/0/mu",
                         "opt_state/inner_state/1/0/nu")):
            assert v.dtype == np.float32, k
    bn = [k for k in jn if k.startswith("bn_state/")]
    assert bn
    for k in bn:
        assert _dist(pn[k], jn[k]) <= 2 * _dist(jn[k], n32[k]), k
    p0 = {k[len("params/"):]: v for k, v in
          named(j16.create(params)).items() if k.startswith("params/")}
    check_first_update(pn, jn, p0, gp, g16, tc, m, m16)
    assert state.step == int(s16.step) == 1
    assert all(p.dtype == torch.float32 for p in state.params)


def test_bf16_freeze_bn_statistics_bitwise():
    """Under freeze_bn the float32 statistics are neither rounded through
    bfloat16 nor moved; the affines and the masters train, in float32."""
    cfg = rt.RAFTConfig.full(**BF)
    tc = TrainConfig(**stage_kwargs(freeze_bn=True))
    params = make_params(rt.RAFTConfig.full(), seed=3, biased=True)
    model = rt.RAFT(cfg)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    tx = make_optimizer(tc)
    state = TrainState.create(model.eval(), tx)
    stats0 = {k: v.clone() for k, v in state.bn_state.items()}
    aff0 = {k: v.detach().clone() for k, v in model.named_parameters()
            if k.startswith("cnet") and ("norm" in k or "downsample.1" in k)}
    state, m = make_train_step(cfg, tc, tx)(state, make_batch(5), 0)
    assert np.isfinite(float(m["loss"]))
    for k, v in state.bn_state.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, stats0[k], rtol=0, atol=0)
    now = dict(state.model.named_parameters())
    assert aff0 and all(not torch.equal(v, now[k]) for k, v in aff0.items())
    assert {p.dtype for p in state.params} == {torch.float32}
    assert {t.dtype for t in state.opt_state.mu + state.opt_state.nu} == \
        {torch.float32}


def _ulp_bf16(x: np.ndarray) -> float:
    """One bfloat16 ulp at the magnitude of ``x`` (8 significant bits)."""
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _hold(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), \
        (name, got.dtype, want.dtype)
    d = np.abs(got.float().numpy() - want.astype(np.float32)).max()
    assert d <= _ulp_bf16(want), (name, d, _ulp_bf16(want))


def _lookup_inputs(ragged: bool):
    """bfloat16 operands (``lookup_operands`` at 'default', the ragged ones
    masked at sizes8) and coordinates that reach off the map."""
    B, H, W, C, L, r = (2, 8, 12, 32, 3, 2)
    rng = np.random.RandomState(11)
    f1 = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    sizes8 = torch.tensor([[8, 12], [5, 7]], dtype=torch.int32) if ragged \
        else None
    f1, levels = lookup_operands(f1, f2, L, "default", sizes8)
    coords = coords_grid(B, H, W) + torch.from_numpy(
        (3.0 * rng.randn(B, H, W, 2)).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H, W, L * (2 * r + 1) ** 2)
                         .astype(np.float32))
    return f1, levels, coords, sizes8, g, r


@pytest.mark.parametrize("entry", ["all", "window", "packed", "ragged"])
def test_lookup_backward_bf16_matches_jax(entry):
    f1, levels, coords, sizes8, g, r = _lookup_inputs(entry == "ragged")
    leaves = [t.clone().requires_grad_(True) for t in [f1, coords] + levels]
    a, c, lv = leaves[0], leaves[1], leaves[2:]
    out = {"all": lambda: corr_cuda.fused_lookup(a, lv, c, r),
           "window": lambda: corr_cuda.window_lookup(a, lv, c, r),
           "packed": lambda: corr_cuda.packed_lookup(a, lv, c, r, "window"),
           "ragged": lambda: corr_cuda.ragged_lookup(a, lv, c, sizes8, r),
           }[entry]()
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, leaves, g)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    res = (jx(f1), tuple(jx(t) for t in levels), jx(coords))
    if entry == "ragged":
        da, db, dc, _ = _ragged_fused_lookup_bwd(
            r, "default", 128, 4096, "matmul",
            res + (jnp.asarray(sizes8.numpy()),), jx(g))
    else:
        da, db, dc = _fused_lookup_bwd(
            r, "default", 128, 4096, "matmul",
            "all" if entry == "all" else "window", entry == "packed",
            res, jx(g))
    _hold(got[0], da, "fmap1")
    _hold(got[1], dc, "coords")
    for i, (p, j) in enumerate(zip(got[2:], db)):
        _hold(p, j, f"level {i}")


def test_gru_backward_bf16_matches_jax():
    """``_SepConvGRU`` at bfloat16 I/O: the gradients of h, motion and the
    two context terms bfloat16, those of the fused weights float32 (the
    weights ride float32 in both packages; JAX returns them to its
    bfloat16 parameters, the port to the fused weights, which the model's
    cast takes to its parameters), each against JAX's."""
    B, H, W, hid, mdim, ctxd = 2, 5, 7, 16, 12, 8
    p = init_sep_conv_gru(jax.random.PRNGKey(2), hid, ctxd + mdim)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    rng = np.random.RandomState(2)

    def bf(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    h = bf(np.tanh(rng.randn(B, H, W, hid)))
    motion = bf(rng.randn(B, H, W, mdim))
    inp = bf(np.maximum(rng.randn(B, H, W, ctxd), 0))
    g = bf(rng.randn(B, H, W, hid))

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    gru = SepConvGRU(hid, ctxd + mdim)
    gru.load_state_dict(weights.from_jax_params(p), strict=True)
    gru = gru.bfloat16()
    fw = {k: v.detach().requires_grad_(True) for k, v in
          gru_cuda.fuse_gru_weights(gru, hid, ctxd).items()}
    # the hoisted context terms (z | r | q of each pass), the port's, as
    # both packages' backward takes them
    c1, c2 = (c.detach().requires_grad_(True)
              for c in precompute_gru_ctx(gru, to_nchw(inp), hid))
    ctx = {n + s: jx(c.detach()[..., i * hid:(i + 1) * hid])
           for s, c in (("1", c1), ("2", c2))
           for i, n in enumerate(("convz", "convr", "convq"))}
    hh, mm = h.clone().requires_grad_(True), motion.clone().requires_grad_(True)
    out = gru_cuda.sep_conv_gru(fw, hh, mm, (c1, c2))
    assert out.dtype == torch.bfloat16
    leaves = [hh, mm, c1, c2] + [fw[k] for k in sorted(fw)]
    got = torch.autograd.grad(out, leaves, g)

    dp, dh, dm, dctx = jax.jit(lambda *a: _gru_fused_bwd(8, None, "xla", *a))(
        (p16, jx(h), jx(motion), ctx), jx(g))
    _hold(got[0], dh, "h")
    _hold(got[1], dm, "motion")
    for i, s in enumerate(("1", "2")):
        want = jnp.concatenate([dctx[n + s] for n in
                                ("convz", "convr", "convq")], -1)
        _hold(got[2 + i], want, f"ctx{s}")
    fused = jax_fuse(dp, hid, ctxd)
    for k, gk in zip(sorted(fw), got[4:]):
        assert gk.dtype == torch.float32, k
        # JAX's weight gradients are its bfloat16 parameters'; the port's
        # fused float32 ones reach the parameters through the cast
        _hold(gk.bfloat16(), fused[k], k)
