"""The port's bf16 compute path (``compute_dtype='bfloat16'``) and
``corr_precision='default'`` against the JAX package.

'default' is defined in ``raft_tpu_torch/config.py``: the lookup's dot
products take fmap1 and the pooled pyramid levels rounded to bfloat16 and
accumulate in float32.  On the JAX package's CPU backend 'default' computes
in float32, so JAX is fed the bf16-rounded operands itself, at 'highest'.

Both frameworks round every bf16 op's result, but their convolutions sum
in other orders, so a sum near a rounding boundary now and then rounds the
other way: the layers are held in bf16 ulps of their output's magnitude,
and the recurrent core to the distance between JAX's own bf16 and float32
flows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.encoders import apply_encoder
from raft_tpu.models.raft import _iterate_flow as jax_iterate
from raft_tpu.models.update import apply_basic_update_block
from raft_tpu.models.update import precompute_gru_ctx as jax_precompute
from raft_tpu.ops.corr import fmap2_pyramid as jax_pyramid
from raft_tpu.ops.corr import mask_ragged_rows as jax_mask
from raft_tpu.ops.corr import ragged_pyramid as jax_ragged_pyramid
from raft_tpu.ops.corr_pallas import _fused_lookup_impl, _ragged_fused_lookup_impl
from raft_tpu.ops.gru_pallas import sep_conv_gru_pallas
import raft_tpu_torch as rt
from raft_tpu_torch.ops import corr_cuda, gru_cuda
from raft_tpu_torch.ops.conv import to_nchw, to_nhwc
from raft_tpu_torch.ops.corr import (live_mask, lookup_blockwise_onehot,
                                     lookup_operands, lookup_packed_plain,
                                     lookup_ragged_plain, lookup_window_plain)
from raft_tpu_torch.models.raft import _iterate_flow as port_iterate
from raft_tpu_torch.models.update import precompute_gru_ctx
from test_torch_port_pack import seeded_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = jnp.bfloat16


def _bf16_params(params):
    """JAX ``_cast_params`` under compute_dtype='bfloat16'."""
    return jax.tree.map(lambda a: a.astype(BF16) if a.dtype == jnp.float32
                        else a, params)


def _to_torch(a) -> torch.Tensor:
    """A JAX array (bf16 or f32) as a torch tensor of the same dtype and
    values."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.bfloat16() if a.dtype == BF16 else t


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the magnitude of max|x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _round(a):
    return jnp.asarray(a).astype(BF16).astype(jnp.float32)


# The JAX functions run jitted (one XLA program each, the Pallas kernels in
# interpret mode inside): the same values as eager, in about half the time.
_jax_lookup = jax.jit(_fused_lookup_impl, static_argnames=(
    "radius", "q_blk", "p_blk_target", "p_select", "pack_rows"))
_jax_ragged_lookup = jax.jit(_ragged_fused_lookup_impl,
                             static_argnames=("radius",))
_jax_encoder = jax.jit(apply_encoder, static_argnames=("norm_fn", "small"))
_jax_iterate = jax.jit(jax_iterate, static_argnames=(
    "config", "iters", "train", "all_flows"))
_jax_gru = jax.jit(sep_conv_gru_pallas, static_argnames=("impl",))
_jax_update = jax.jit(apply_basic_update_block, static_argnames=("gru_impl",))


# --------------------------------------------- corr_precision='default'

def _corr_case(seed=0, B=1, H=8, W=12, C=16):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-4, 4, coords.shape).astype(np.float32)
    return f1, f2, coords


def test_default_operands_are_rounded_after_pooling():
    f1, f2, _ = _corr_case()
    t1, levels = lookup_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                 3, "default")
    assert t1.dtype == torch.bfloat16 and {lv.dtype for lv in levels} == {torch.bfloat16}
    np.testing.assert_array_equal(t1.float().numpy(), np.asarray(_round(f1)))
    for got, want in zip(levels, jax_pyramid(jnp.asarray(f2), 3)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(_round(want)))
    hi1, hi_levels = lookup_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                     3, "highest")
    assert hi1.dtype == torch.float32 and hi_levels[1].dtype == torch.float32


@pytest.mark.parametrize("kind", ["all", "window", "packed"])
def test_default_lookups_match_jax_on_rounded_operands(kind):
    """B1's, B3's and B5's plain versions on bf16 operands against JAX's
    Pallas kernels (interpret mode) fed the same rounded operands at
    'highest', at 1e-5; and the 'default' closure on CPU tensors."""
    L, r = 3, 3
    f1, f2, coords = _corr_case()
    jl = tuple(_round(lv) for lv in jax_pyramid(jnp.asarray(f2), L))
    want = np.asarray(_jax_lookup(
        _round(f1), jl, jnp.asarray(coords), radius=r, q_blk=64, p_blk_target=1024,
        p_select="all" if kind == "all" else "window",
        pack_rows=kind == "packed"))
    t1, levels = lookup_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                 L, "default")
    tc = torch.from_numpy(coords)
    plain = {"all": lookup_blockwise_onehot, "window": lookup_window_plain,
             "packed": lambda *a: lookup_packed_plain(*a, "window")}[kind]
    got = plain(t1, levels, tc, r)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    make = corr_cuda.make_fused_lookup if kind == "all" else corr_cuda.make_window_lookup
    closure = make(torch.from_numpy(f1), torch.from_numpy(f2), L, r,
                   pack=kind == "packed", corr_precision="default")
    torch.testing.assert_close(closure(tc), got, rtol=0, atol=0)


def test_default_ragged_lookup_matches_jax_on_rounded_operands():
    """B4's plain version on bf16 masked operands against JAX's ragged
    kernel (interpret mode) fed the masked, pooled, rounded operands."""
    L, r = 3, 3
    f1, f2, coords = _corr_case(1, B=2, H=10, W=14)
    sizes8 = np.array([[10, 14], [7, 9]], np.int32)
    js = jnp.asarray(sizes8)
    jl = tuple(_round(lv) for lv in jax_ragged_pyramid(jnp.asarray(f2), js, L))
    want = np.asarray(_jax_ragged_lookup(
        _round(jax_mask(jnp.asarray(f1), js)), jl, jnp.asarray(coords), js,
        radius=r))
    s8 = torch.from_numpy(sizes8)
    t1, levels = lookup_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                 L, "default", s8)
    got = lookup_ragged_plain(t1, levels, torch.from_numpy(coords), s8, r)
    live = live_mask(s8, 10, 14).numpy()
    np.testing.assert_allclose(got.numpy()[live], want[live], **TOL)
    assert np.abs(got.numpy()[~live]).max() == 0.0
    closure = corr_cuda.make_ragged_fused_lookup(
        torch.from_numpy(f1), torch.from_numpy(f2), s8, L, r, "default")
    torch.testing.assert_close(closure(torch.from_numpy(coords)), got,
                               rtol=0, atol=0)


# ---------------------------------------------------- layers in bf16

@pytest.mark.parametrize("form", ["module", "fused", "nhwc"])
def test_bf16_conv_adds_its_bias_after_rounding_as_jax(form):
    """JAX rounds a bf16 conv's output to bf16 and then adds the bias in
    bf16 (``raft_tpu/ops/conv.py::conv2d``); the port's bf16 convs do the
    same in each of their three forms (a model's conv module,
    ``apply_conv_fused``, the NHWC ``conv2d``).  Against JAX's bf16 conv on
    the same bf16 operands only a sum that lands at a rounding boundary may
    round the other way: under 1% of the outputs differ, each by at most 1
    bf16 ulp of its own magnitude (adding the bias before the one rounding,
    as ``F.conv2d`` does on the CPU, changes about 28%)."""
    from raft_tpu.ops import conv as jconv
    from raft_tpu_torch.ops import conv
    rng = np.random.RandomState(12)
    x = rng.randn(2, 13, 18, 64).astype(np.float32)
    w = (rng.randn(3, 3, 64, 48) / 24.0).astype(np.float32)
    b = rng.uniform(-0.25, 0.25, 48).astype(np.float32)
    want = np.asarray(jconv.conv2d(*(jnp.asarray(a).astype(BF16) for a in (x, w, b)))
                      .astype(jnp.float32))

    def t(a):
        return torch.from_numpy(a).bfloat16()
    with torch.no_grad():
        if form == "module":
            m = conv.make_conv(3, 64, 48).bfloat16()
            m.weight.copy_(t(w).permute(3, 2, 0, 1))
            m.bias.copy_(t(b))
            got = to_nhwc(m(to_nchw(t(x))))
        elif form == "fused":
            ws = t(w).permute(3, 2, 0, 1)
            got = to_nhwc(torch.cat(conv.apply_conv_fused(
                [ws[:20], ws[20:]], [t(b)[:20], t(b)[20:]], to_nchw(t(x))), 1))
        else:
            got = conv.conv2d(t(x), t(w), t(b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    differ = got != want
    assert differ.mean() < 0.01, differ.mean()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[differ]))) - 7)
    assert (np.abs(got - want)[differ] <= ulp).all()


def test_gru_bf16_matches_jax_bf16_kernel():
    """The plain GRU (the CUDA kernel's plain version) on bf16 h, motion
    and context terms against the JAX kernel's twin ``sep_conv_gru_xla``
    (the kernel's schedule and I/O policy) on the same bf16 inputs and bf16
    parameters.  Both upcast once, compute in
    float32 (h1 between the passes too) and round only the result, so the
    float32 values agree to ~1e-6 and a value lying at a rounding boundary
    may round the other way: at most 1 bf16 ulp of max|h|."""
    from raft_tpu.models.update import init_sep_conv_gru
    from raft_tpu_torch.convert import weights
    from raft_tpu_torch.models.update import SepConvGRU
    hid, mdim, ctxd = 64, 16, 24
    p = _bf16_params(init_sep_conv_gru(jax.random.PRNGKey(4), hid, ctxd + mdim))
    rng = np.random.RandomState(4)
    h = jnp.asarray(np.tanh(rng.randn(1, 7, 9, hid))).astype(BF16)
    motion = jnp.asarray(rng.randn(1, 7, 9, mdim)).astype(BF16)
    inp = jnp.asarray(np.maximum(rng.randn(1, 7, 9, ctxd), 0)).astype(BF16)
    jctx = jax_precompute(p, inp, hid)
    want = _jax_gru(p, h, motion, jctx, impl="xla")
    assert want.dtype == BF16
    gru = SepConvGRU(hid, ctxd + mdim)
    gru.load_state_dict(weights.from_jax_params(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), p)), strict=True)
    ctx = tuple(_to_torch(jnp.concatenate(
        [jctx[g + s] for g in ("convz", "convr", "convq")], -1)) for s in "12")
    assert ctx[0].dtype == torch.bfloat16
    fw = gru_cuda.fuse_gru_weights(gru.bfloat16(), hid, ctxd)
    got = gru_cuda.sep_conv_gru(fw, _to_torch(h), _to_torch(motion), ctx)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - w).max() <= _ulp(w)


@pytest.fixture(scope="module", params=[False, True],
                ids=["zero_bias", "biased"])
def bf16_pair(request):
    """raft-things parameters (JAX init, non-trivial BN statistics; zero
    conv biases and identity BN affines, or both drawn away from them),
    their JAX bf16 cast and the port's bf16 module."""
    params = seeded_jax_params(JaxConfig.full(), biased=request.param)
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, _bf16_params(params), model.to(torch.bfloat16).eval()


def test_encoders_bf16_match_jax(bf16_pair):
    """fnet (instance norm) and cnet (eval batch norm) on identical bf16
    inputs.  Each of the encoder's 13 convs and norms rounds its output to
    bf16, XLA's CPU fusions round at other places than PyTorch's ops, and
    a one-ulp difference early (a norm's statistics) travels through six
    residual blocks: held to 8 bf16 ulps of max|out| at any element (3.5
    measured for fnet, 1.25 for cnet) and 1 ulp on average."""
    _, pb, model = bf16_pair
    x = jnp.asarray(2 * np.random.RandomState(5).rand(2, 48, 64, 3) - 1).astype(BF16)
    for name, norm in (("fnet", "instance"), ("cnet", "batch")):
        want, _ = _jax_encoder(pb[name], x, norm_fn=norm, small=False)
        assert want.dtype == BF16
        with torch.no_grad():
            got = getattr(model, name)(to_nchw(_to_torch(x)).contiguous(
                memory_format=torch.channels_last))
        assert got.dtype == torch.bfloat16
        w = np.asarray(want.astype(jnp.float32))
        err = np.abs(to_nhwc(got).float().numpy() - w)
        assert err.max() <= 8 * _ulp(w), (name, err.max() / _ulp(w))
        assert err.mean() <= _ulp(w), (name, err.mean() / _ulp(w))


def test_update_block_bf16_matches_jax(bf16_pair):
    """Motion encoder, hoisted GRU (float32 core) and the fused heads on
    identical bf16 net, context, correlation and flow: held to 1 bf16 ulp
    of each output's max (a final rounding that may fall the other way)."""
    _, pb, model = bf16_pair
    rng = np.random.RandomState(6)
    shape = (1, 6, 8)
    net = jnp.asarray(np.tanh(rng.randn(*shape, 128))).astype(BF16)
    inp = jnp.asarray(np.maximum(rng.randn(*shape, 128), 0)).astype(BF16)
    corr = jnp.asarray(rng.randn(*shape, 324)).astype(BF16)
    flow = jnp.asarray(3 * rng.randn(*shape, 2)).astype(BF16)
    ub = pb["update_block"]
    want = _jax_update(ub, net, inp, corr, flow,
                       gru_ctx=jax_precompute(ub["gru"], inp, 128),
                       gru_impl="pallas")
    with torch.no_grad():
        gru = model.update_block.gru
        got = model.update_block(
            _to_torch(net), to_nchw(_to_torch(corr)), to_nchw(_to_torch(flow)),
            precompute_gru_ctx(gru, to_nchw(_to_torch(inp)), 128),
            gru_cuda.fuse_gru_weights(gru, 128, 128), gru_impl="pallas")
    got = (got[0], to_nhwc(got[1]), to_nhwc(got[2]))
    for name, g, w in zip(("net", "mask", "delta_flow"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == BF16, name
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= _ulp(w), (name, err / _ulp(w))


# ------------------------------------------------------- full model
#
# The recurrent core is compared from identical bf16 features (JAX's
# encoders' outputs, the encoders being held above in ulps).  From the
# images end to end the encoders' rare accumulation-order flips spread to
# about half of the features at +-1 ulp — the size of the bf16 rounding
# itself — and the random-weight recurrence amplifies any such difference
# to the same scale, so end to end the port-vs-JAX and the JAX
# bf16-vs-float32 distances are of one order (ratios 0.5-1.3 over six image
# seeds) and the envelope would not separate them.

def _jax_features(pb, im, sizes=None):
    """JAX's bf16 encoder outputs for frame pairs ``im`` [2, B, H, W, 3]:
    fmap1, fmap2, net, inp (NHWC), the images masked as ``raft_forward``
    masks a ragged batch."""
    x1, x2 = (jnp.asarray(2.0 * im[i] - 1.0).astype(BF16) for i in (0, 1))
    if sizes is not None:
        x1, x2 = (jax_mask(x, jnp.asarray(sizes)) for x in (x1, x2))
    fmaps, _ = _jax_encoder(pb["fnet"], jnp.concatenate([x1, x2]),
                            norm_fn="instance", small=False)
    cnet, _ = _jax_encoder(pb["cnet"], x1, norm_fn="batch", small=False)
    B = im.shape[1]
    return (fmaps[:B], fmaps[B:], jnp.tanh(cnet[..., :128]),
            jax.nn.relu(cnet[..., 128:]))


def _core_flows(params, pb, model, feats, kw, sizes8=None):
    """Every iteration's flow from the same bf16 features: JAX in bf16
    and in float32 (corr_precision='highest', the only value that means
    the same in both packages on the CPU), the port in bf16 with
    'highest' and with 'default' (the BF configuration itself)."""
    js = None if sizes8 is None else jnp.asarray(sizes8)
    jax_flows = []
    for dt, p in (("bfloat16", pb), ("float32", params)):
        fs = [f.astype(dt) for f in feats]
        jax_flows.append(np.asarray(_jax_iterate(
            p, fs[0], fs[1], fs[2], fs[3], config=JaxConfig.full(
                compute_dtype=dt, **kw), iters=2, train=False, all_flows=True,
            flow_init=None, sizes8=js).flow_iters))
    f1, f2, net, inp = (_to_torch(f) for f in feats)
    port = []
    for prec in ("highest", "default"):
        cfg = rt.RAFTConfig.full(compute_dtype="bfloat16", corr_precision=prec,
                                 **kw)
        with torch.no_grad():
            port.append(port_iterate(
                model, to_nchw(f1), to_nchw(f2), net, to_nchw(inp), cfg, 2,
                True, None, None if sizes8 is None else torch.from_numpy(sizes8)
            ).flow_iters.numpy())
    return jax_flows + port


def _hold(jax_bf, jax_f32, port, port_default, crops):
    """At each iteration, on each live crop: the port's distance from JAX's
    bf16 flow is no larger than JAX's own bf16-vs-float32 distance on the
    same features (the envelope), and smaller than its distance from JAX's
    float32 flow (a port that ran the core in float32 would sit at the
    latter).  The BF configuration's flow is finite and within twice the
    envelope: 'default' rounds the pooled pyramid levels to bf16, a change
    of the same kind and size as the rounding the envelope measures, and
    the recurrence amplifies either alike (ratios 0.4-1.7 over six image
    seeds).  It also differs from the port's 'highest' flow: a port that
    ignored 'default' would give the 'highest' flow bit for bit (what
    'default' computes is held per lookup above; on a small crop the
    difference may vanish when the correlation is rounded to bf16)."""
    moved = 0.0
    for i in range(jax_bf.shape[0]):
        for b, (h, w) in enumerate(crops):
            def d(x, y):
                return np.abs(x[i, b, :h, :w] - y[i, b, :h, :w]).max()
            env = d(jax_bf, jax_f32)
            assert np.isfinite(port_default[i, b, :h, :w]).all()
            assert d(port, jax_bf) <= env, (i, b, d(port, jax_bf), env)
            assert d(port, jax_bf) < d(port, jax_f32), (
                i, b, d(port, jax_bf), d(port, jax_f32))
            assert d(port_default, jax_bf) <= 2 * env, (
                i, b, d(port_default, jax_bf), env)
            moved = max(moved, d(port_default, port))
    assert moved > 0


def test_full_model_bf16_within_jax_bf16_envelope(bf16_pair):
    """BF (pallas_pack, p_select='window', p_blk 1024) at 48x64 (every
    level packs), two iterations from the same bf16 features; and the
    whole BF forward through ``make_inference_fn`` gives finite flows."""
    params, pb, model = bf16_pair
    kw = dict(corr_impl="pallas", gru_impl="pallas", pallas_pack=True,
              pallas_p_select="window", pallas_p_blk=1024)
    im = np.random.RandomState(3).rand(2, 1, 48, 64, 3).astype(np.float32)
    flows = _core_flows(params, pb, model, _jax_features(pb, im), kw)
    assert flows[2].shape == (2, 1, 48, 64, 2)
    _hold(*flows, [(48, 64)])
    bf = rt.RAFTConfig.full(compute_dtype="bfloat16", corr_precision="default",
                            iters=2, **kw)
    flow = rt.make_inference_fn(bf, device="cpu")(model, im[0], im[1])
    assert flow.dtype == torch.float32 and bool(torch.isfinite(flow).all())


def test_ragged_bf16_within_jax_bf16_envelope(bf16_pair):
    """A ragged batch of two crops (one with sides not multiples of 8) in
    a 32x48 box, bf16 with ``pallas_pack=True`` (which the ragged lookup
    ignores, as in JAX), two iterations from the same bf16 features, on
    each live crop; the ragged entry point runs BF and gives finite flows
    there."""
    params, pb, model = bf16_pair
    kw = dict(corr_impl="pallas", gru_impl="pallas", pallas_pack=True)
    rng = np.random.RandomState(8)
    sizes = np.array([[32, 48], [22, 30]], np.int32)
    im = np.zeros((2, 2, 32, 48, 3), np.float32)
    for b, (h, w) in enumerate(sizes):
        im[:, b, :h, :w] = rng.rand(2, h, w, 3)
    flows = _core_flows(params, pb, model, _jax_features(pb, im, sizes), kw,
                        sizes // 8)
    _hold(*flows, (sizes // 8).tolist())
    bf = rt.RAFTConfig.full(compute_dtype="bfloat16", corr_precision="default",
                            iters=2, **kw)
    flow = rt.make_ragged_inference_fn(bf, device="cpu")(model, im[0], im[1],
                                                         sizes)
    for b, (h, w) in enumerate(sizes):
        assert bool(torch.isfinite(flow[b, :h, :w]).all())
