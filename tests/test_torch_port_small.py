"""The port's raft-small variant (``RAFTConfig.small_model()``) against the
JAX package: the same numpy-seeded inputs and the JAX small parameter
tree through ``from_jax_params`` (zero conv biases, or biases drawn away
from zero: ``test_torch_port_model.with_biases``).

Tolerances: a layer in float32 at rtol = atol = 1e-5 (the JAX suite's
kernel tolerance; the two frameworks sum a conv's products in other
orders, ~1e-6 apart); an encoder, a stack of 20 such convs and 13 norms,
at 5e-5 (1.4e-5 measured at worst); the whole model at every iteration at the
full-model bound ``1e-3 + 1e-3 * max|flow|`` of tests/test_torch_golden.py
(the random-weight recurrence amplifies float32 differences); bf16 as
tests/test_torch_port_bf16.py holds the full model (layers in bf16 ulps,
the recurrent core within JAX's own bf16-vs-float32 envelope)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.encoders import apply_encoder
from raft_tpu.models.raft import _iterate_flow as jax_iterate
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.models.update import (apply_conv_gru_hoisted,
                                    apply_small_motion_encoder,
                                    apply_small_update_block)
from raft_tpu.models.update import precompute_gru_ctx as jax_precompute
from raft_tpu.ops.coords import upflow8 as jax_upflow8
import raft_tpu_torch as rt
from raft_tpu_torch.models.raft import _iterate_flow as port_iterate
from raft_tpu_torch.models.update import (conv_gru_hoisted,
                                          fuse_conv_gru_weights,
                                          precompute_gru_ctx)
from raft_tpu_torch.ops.conv import to_nchw, to_nhwc
from raft_tpu_torch.ops.upsample import upflow8
from test_torch_port_bf16 import _bf16_params, _hold, _to_torch, _ulp
from test_torch_port_pack import seeded_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
ENCODER_TOL = dict(rtol=5e-5, atol=5e-5)
BF16 = jnp.bfloat16
HID, CTX, CORR = 96, 64, 4 * 7 ** 2       # raft-small: hidden, context, L(2r+1)^2

_jax_encoder = jax.jit(apply_encoder, static_argnames=("norm_fn", "small"))
_jax_forward = jax.jit(jax_forward, static_argnames=("config", "all_flows"))
_jax_iterate = jax.jit(jax_iterate, static_argnames=(
    "config", "iters", "train", "all_flows"))


@pytest.fixture(scope="module", params=[False, True],
                ids=["zero_bias", "biased"])
def small_pair(request):
    """raft-small's JAX parameters and the port's module loaded from them
    strictly."""
    params = seeded_jax_params(JaxConfig.small_model(), biased=request.param)
    model = rt.RAFT(rt.RAFTConfig.small_model())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, model.eval()


def _nchw(a) -> torch.Tensor:
    return to_nchw(torch.from_numpy(np.ascontiguousarray(a, np.float32)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return to_nhwc(t).detach().numpy()


def test_small_state_dict_is_the_jax_tree(small_pair):
    """Every leaf of the JAX small tree has its tensor and nothing more:
    bottleneck blocks (norm3, the strided 3x3 in conv2), no norm leaves in
    the cnet ('none'), no mask head."""
    params, model = small_pair
    keys = set(model.state_dict())
    assert keys == set(rt.from_jax_params(params))
    assert "fnet.layer2.0.conv3.weight" in keys
    assert not any(k.startswith("cnet.") and "norm" in k for k in keys)
    assert not any(k.startswith("update_block.mask") for k in keys)
    assert tuple(model.update_block.gru.convz.weight.shape) == (HID, HID + CTX + 82, 3, 3)


def test_small_encoders_match_jax(small_pair):
    """fnet (instance norm) and cnet (no norm) at 40x56, [-1, 1] inputs."""
    params, model = small_pair
    x = (2 * np.random.RandomState(1).rand(2, 40, 56, 3) - 1).astype(np.float32)
    for name, norm in (("fnet", "instance"), ("cnet", "none")):
        want, _ = _jax_encoder(params[name], jnp.asarray(x), norm_fn=norm,
                               small=True)
        with torch.no_grad():
            got = getattr(model, name)(_nchw(x))
        assert got.shape[1] == (128 if name == "fnet" else HID + CTX)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **ENCODER_TOL)


def _update_inputs(seed=2, shape=(2, 5, 7)):
    rng = np.random.RandomState(seed)
    return (np.tanh(rng.randn(*shape, HID)).astype(np.float32),
            np.maximum(rng.randn(*shape, CTX), 0).astype(np.float32),
            rng.randn(*shape, CORR).astype(np.float32),
            (3 * rng.randn(*shape, 2)).astype(np.float32))


def test_small_motion_encoder_matches_jax(small_pair):
    params, model = small_pair
    _, _, corr, flow = _update_inputs()
    want = apply_small_motion_encoder(params["update_block"]["encoder"],
                                      jnp.asarray(flow), jnp.asarray(corr))
    with torch.no_grad():
        got = model.update_block.encoder(_nchw(flow), _nchw(corr))
    assert got.shape[1] == 82
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_hoisted_conv_gru_matches_jax(small_pair):
    """The context terms of ``precompute_gru_ctx(small=True)`` and one
    hoisted 3x3 ConvGRU iteration."""
    params, model = small_pair
    net, inp, _, _ = _update_inputs(3)
    motion = np.random.RandomState(4).randn(*net.shape[:3], 82).astype(np.float32)
    p = params["update_block"]["gru"]
    jctx = jax_precompute(p, jnp.asarray(inp), HID, small=True)
    want = apply_conv_gru_hoisted(p, jnp.asarray(net), jnp.asarray(motion), jctx)
    gru = model.update_block.gru
    with torch.no_grad():
        ctx = precompute_gru_ctx(gru, _nchw(inp), HID)
        for g, name in zip(ctx, ("convz", "convr", "convq")):
            np.testing.assert_allclose(_nhwc(g), np.asarray(jctx[name]), **TOL)
        got = conv_gru_hoisted(fuse_conv_gru_weights(gru, HID, CTX),
                               _nchw(net), _nchw(motion), ctx)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_small_update_block_matches_jax(small_pair):
    """Motion encoder, hoisted ConvGRU and flow head; no mask."""
    params, model = small_pair
    net, inp, corr, flow = _update_inputs(5)
    ub = params["update_block"]
    jctx = jax_precompute(ub["gru"], jnp.asarray(inp), HID, small=True)
    want = apply_small_update_block(ub, jnp.asarray(net), jnp.asarray(inp),
                                    jnp.asarray(corr), jnp.asarray(flow),
                                    gru_ctx=jctx)
    gru = model.update_block.gru
    with torch.no_grad():
        got = model.update_block(
            torch.from_numpy(net), _nchw(corr), _nchw(flow),
            precompute_gru_ctx(gru, _nchw(inp), HID),
            fuse_conv_gru_weights(gru, HID, CTX))
    assert got[1] is None and want[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(_nhwc(got[2]), np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 1, 3), (1, 6, 1)],
                         ids=["5x7", "1x3", "6x1"])
def test_upflow8_matches_jax(shape):
    """x8 align-corners bilinear, values x8; a side of 1 included."""
    flow = (20 * np.random.RandomState(6).randn(*shape, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_upflow8)(jnp.asarray(flow)))
    got = upflow8(torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# each lookup the full model supports, at raft-small's r = 3, C = 128:
# (config overrides, the ragged crops in a 32x48 box or None)
SMALL_LOOKUPS = {
    "blockwise": (dict(corr_impl="blockwise"), None),
    "pallas": (dict(corr_impl="pallas"), None),
    "dense": (dict(corr_impl="dense"), None),
    "pallas-window": (dict(corr_impl="pallas", pallas_p_select="window"), None),
    "pallas-pack": (dict(corr_impl="pallas", pallas_pack=True), None),
    "pallas-ragged": (dict(corr_impl="pallas"), [(32, 48), (19, 30)]),
}


@pytest.mark.parametrize("lookup", list(SMALL_LOOKUPS))
def test_small_model_every_iteration_matches_jax(small_pair, lookup):
    """raft-small at 32x48 (a 4x6 grid; levels 2-3 are 1x1 and 0x0), three
    iterations, every iteration's upflow8 flow on each item's crop; JAX
    runs its Pallas lookups ('all', 'window', packed, ragged) in interpret
    mode, as its own suite does on the CPU, and the port each kernel's
    plain version.  The ragged case holds a 32x48 and a 19x30 item (odd
    extent, not a multiple of 8) in one box."""
    params, model = small_pair
    overrides, crops = SMALL_LOOKUPS[lookup]
    kw = dict(overrides, iters=3)
    B = 1 if crops is None else len(crops)
    im = np.random.RandomState(7).rand(2, B, 32, 48, 3).astype(np.float32)
    sizes = None if crops is None else np.asarray(crops, np.int32)
    out, _ = _jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]),
                          config=JaxConfig.small_model(**kw), all_flows=True,
                          sizes=None if sizes is None else jnp.asarray(sizes))
    want = np.asarray(out.flow_iters)
    got = rt.raft_forward(model, torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]),
                          rt.RAFTConfig.small_model(**kw), all_flows=True,
                          sizes=None if sizes is None else torch.from_numpy(sizes)
                          ).flow_iters.numpy()
    assert got.shape == want.shape == (3, B, 32, 48, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        for b, (h, wd) in enumerate(crops or [(32, 48)]):
            gb, wb = g[b, :h, :wd], w[b, :h, :wd]
            err, scale = np.abs(gb - wb).max(), np.abs(wb).max()
            assert err <= 1e-3 + 1e-3 * scale, (i, b, err, scale)


def test_small_inference_fn_runs_every_lookup_on_cpu():
    """``make_inference_fn`` on the CPU runs the default small_model()
    ('dense') and its 'pallas' and 'blockwise' twins; 'pallas' and
    'blockwise' run the same plain lookup there, so they agree bitwise,
    and 'dense' within the full-model bound of them after one iteration
    (its lookup is held at 1e-5 in test_torch_port_dense.py); the ragged
    entry takes a small batch too."""
    model = rt.init_raft_torch(rt.RAFTConfig.small_model(), device="cpu")
    im = np.random.RandomState(8).rand(2, 1, 24, 32, 3).astype(np.float32)
    flows = {c: rt.make_inference_fn(rt.RAFTConfig.small_model(
        corr_impl=c, iters=1), device="cpu")(model, im[0], im[1])
        for c in ("dense", "pallas", "blockwise")}
    torch.testing.assert_close(flows["pallas"], flows["blockwise"],
                               rtol=0, atol=0)
    err = float((flows["dense"] - flows["blockwise"]).abs().max())
    assert err <= 1e-3 + 1e-3 * float(flows["blockwise"].abs().max()), err
    ragged = rt.make_ragged_inference_fn(rt.RAFTConfig.small_model(iters=1),
                                         device="cpu")(
        model, im[0], im[1], np.array([[17, 30]], np.int32))
    assert bool(torch.isfinite(ragged[0, :17, :30]).all())


# ---------------------------------------------------------------- bf16

@pytest.fixture(scope="module")
def small_bf16():
    params = seeded_jax_params(JaxConfig.small_model(), biased=True)
    model = rt.RAFT(rt.RAFTConfig.small_model())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, _bf16_params(params), model.to(torch.bfloat16).eval()


def test_small_layers_bf16_match_jax(small_bf16):
    """The encoders on identical bf16 inputs, held as the full model's are
    (8 bf16 ulps of max|out| at any element, 1 on average); the update
    block on identical bf16 net, context, correlation and flow, each
    output within 2 bf16 ulps of its max (its elementwise gate arithmetic
    is rounded op by op in PyTorch, where XLA's fusions keep float32)."""
    _, pb, model = small_bf16
    x = jnp.asarray(2 * np.random.RandomState(9).rand(2, 40, 56, 3) - 1).astype(BF16)
    for name, norm in (("fnet", "instance"), ("cnet", "none")):
        want, _ = _jax_encoder(pb[name], x, norm_fn=norm, small=True)
        with torch.no_grad():
            got = getattr(model, name)(to_nchw(_to_torch(x)).contiguous(
                memory_format=torch.channels_last))
        assert got.dtype == torch.bfloat16
        w = np.asarray(want.astype(jnp.float32))
        err = np.abs(to_nhwc(got).float().numpy() - w)
        assert err.max() <= 8 * _ulp(w), (name, err.max() / _ulp(w))
        assert err.mean() <= _ulp(w), (name, err.mean() / _ulp(w))
    net, inp, corr, flow = (jnp.asarray(a).astype(BF16) for a in _update_inputs(10))
    ub = pb["update_block"]
    want = apply_small_update_block(ub, net, inp, corr, flow, gru_ctx=jax_precompute(
        ub["gru"], inp, HID, small=True))
    gru = model.update_block.gru
    with torch.no_grad():
        got = model.update_block(
            _to_torch(net), to_nchw(_to_torch(corr)), to_nchw(_to_torch(flow)),
            precompute_gru_ctx(gru, to_nchw(_to_torch(inp)), HID),
            fuse_conv_gru_weights(gru, HID, CTX))
    for name, g, w in (("net", got[0], want[0]),
                       ("delta_flow", to_nhwc(got[2]), want[2])):
        assert g.dtype == torch.bfloat16 and w.dtype == BF16, name
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2 * _ulp(w), (name, err / _ulp(w))


def test_small_model_bf16_within_jax_bf16_envelope(small_bf16):
    """raft-small under the bf16 policy with 'pallas' at 48x64, two
    iterations from identical bf16 features (JAX's encoders'), held as
    test_torch_port_bf16.py holds the full model (``_hold``); the whole
    bf16 forward through ``make_inference_fn`` gives finite flows."""
    params, pb, model = small_bf16
    im = np.random.RandomState(11).rand(2, 1, 48, 64, 3).astype(np.float32)
    x1, x2 = (jnp.asarray(2.0 * im[i] - 1.0).astype(BF16) for i in (0, 1))
    fmaps, _ = _jax_encoder(pb["fnet"], jnp.concatenate([x1, x2]),
                            norm_fn="instance", small=True)
    cnet, _ = _jax_encoder(pb["cnet"], x1, norm_fn="none", small=True)
    feats = (fmaps[:1], fmaps[1:], jnp.tanh(cnet[..., :HID]),
             jax.nn.relu(cnet[..., HID:]))
    flows = []
    for dt, p in (("bfloat16", pb), ("float32", params)):
        fs = [f.astype(dt) for f in feats]
        flows.append(np.asarray(_jax_iterate(
            p, *fs, config=JaxConfig.small_model(corr_impl="pallas",
                                                 compute_dtype=dt),
            iters=2, train=False, all_flows=True, flow_init=None).flow_iters))
    f1, f2, net, inp = (_to_torch(f) for f in feats)
    for prec in ("highest", "default"):
        cfg = rt.RAFTConfig.small_model(corr_impl="pallas",
                                        compute_dtype="bfloat16",
                                        corr_precision=prec)
        with torch.no_grad():
            flows.append(port_iterate(model, to_nchw(f1), to_nchw(f2), net,
                                      to_nchw(inp), cfg, 2, True, None)
                         .flow_iters.numpy())
    assert flows[2].shape == (2, 1, 48, 64, 2)
    _hold(*flows, [(48, 64)])
    cfg = rt.RAFTConfig.small_model(corr_impl="pallas", compute_dtype="bfloat16",
                                    corr_precision="default", iters=2)
    flow = rt.make_inference_fn(cfg, device="cpu")(model, im[0], im[1])
    assert flow.dtype == torch.float32 and bool(torch.isfinite(flow).all())
