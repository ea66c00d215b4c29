"""The port's streaming entry points against the JAX package's: the
per-frame encoder (``encode_frame``), the recurrent core from features
(``forward_from_features``), the solo and the slot-batched stream steps
and their ragged twins, the ``quant`` storage formats (int8 slot rows,
bf16 encoder weights) and the warm-start seed.  Full model (raft-things)
with the kernels' names (their plain versions on the CPU; JAX's Pallas
kernels in interpret mode), 32x48 frames, 2 iterations, numpy-seeded
weights through ``from_jax_params``.

The JAX package's own streaming tests compare its stream path with its
pairwise path at 1e-5 and fail on the random-weight recurrence's
amplification of float32 differences (ROADMAP, known failures); so the
port is held here against the JAX stream entries' own outputs, each fed
the same numpy features, frames and slot buffers.  Tolerances: an encoder
at 5e-5 (``test_torch_port_small.py``), flows at the full-model bound
``1e-3 + 1e-3 * max|flow|``, int8 rows exactly.

The warm start's nearest-hit fill is exact Euclidean in the port and
OpenCV's 3x3-mask approximation in JAX: the splat is held bitwise, the
fill equal wherever OpenCV picked the unique exact nearest hit.  On this
test's three flow fields 226 of 2304 pixels (9.8%; 820 were filled) differ
from JAX's, every one a tie: OpenCV picked an exact nearest hit and scipy
another hit at the same distance, so each takes a value of an exact
nearest hit (on a pixel grid, equal distances are common)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models import raft as jax_raft
from raft_tpu.ops.warmstart import warm_start_seed as jax_warm_start
from raft_tpu.utils import frame_utils as jax_frame_utils
import raft_tpu_torch as rt
from raft_tpu_torch.models import capture as capture_mod
from raft_tpu_torch.models import raft as port_raft
from raft_tpu_torch.ops import warmstart as port_warmstart
from test_torch_port_capture import stand_in  # noqa: F401 (a fixture)
from test_torch_port_pack import seeded_jax_params

ITERS = 2
KW = dict(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
ENCODER_TOL = dict(rtol=5e-5, atol=5e-5)
H, W, h, w = 32, 48, 4, 6


def _hold(got, want, label=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-3 + 1e-3 * scale, (
        f"{label}: max|diff| {err:.3e} vs scale {scale:.3e}")


@pytest.fixture(scope="module", params=[False, True], ids=["zero_bias", "biased"])
def pair(request):
    params = seeded_jax_params(JaxConfig.full(), seed=0, biased=request.param)
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, model.eval()


def _frames(seed, n, B=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(B, H, W, 3).astype(np.float32) for _ in range(n)]


def test_encode_frame_matches_jax(pair):
    params, model = pair
    im = _frames(1, 1, B=2)[0]
    jf, jc = jax_raft.encode_frame(params, jnp.asarray(im), JaxConfig.full(**KW))
    f, c = rt.encode_frame(model, torch.from_numpy(im), rt.RAFTConfig.full(**KW))
    assert tuple(f.shape) == (2, h, w, 256) and tuple(c.shape) == (2, h, w, 256)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **ENCODER_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **ENCODER_TOL)
    with pytest.raises(ValueError, match="divisible by 8"):
        rt.encode_frame(model, torch.zeros(1, 20, 24, 3), rt.RAFTConfig.full())


def test_forward_from_features_matches_jax(pair):
    """The same numpy features into both cores: the core held apart from
    the encoders, with and without a seed."""
    params, model = pair
    rng = np.random.RandomState(2)
    f1, f2, cnet = (rng.randn(2, h, w, 256).astype(np.float32)
                    for _ in range(3))
    init = (2 * rng.randn(2, h, w, 2)).astype(np.float32)
    t = torch.from_numpy
    for flow_init in (None, init):
        want = jax_raft.forward_from_features(
            params, *map(jnp.asarray, (f1, f2, cnet)), JaxConfig.full(**KW),
            flow_init=None if flow_init is None else jnp.asarray(flow_init))
        got = rt.forward_from_features(
            model, t(f1), t(f2), t(cnet), rt.RAFTConfig.full(**KW),
            flow_init=None if flow_init is None else t(flow_init))
        _hold(got.flow.numpy(), want.flow, "flow")
        _hold(got.flow_lr.numpy(), want.flow_lr, "flow_lr")
        assert got.iters_used.tolist() == [ITERS, ITERS]


@pytest.mark.parametrize("policy", ["fixed", "converge:1e9:1"])
def test_stream_step_matches_jax(pair, policy):
    """The solo step on frame 1 from frame 0's JAX maps and a seed (the
    same numpy arrays in both): the flows, and the current frame's maps
    handed back for the cache; ``iters_used`` appended under converge."""
    params, model = pair
    im0, im1 = _frames(3, 2)
    jcfg = JaxConfig.full(**KW, iters_policy=policy)
    fm0, cn0 = (np.array(x) for x in jax_raft.encode_frame(
        params, jnp.asarray(im0), jcfg))
    init = (1.5 * np.random.RandomState(4).randn(1, h, w, 2)).astype(np.float32)
    want = jax_raft.make_stream_step_fn(jcfg)(
        params, jnp.asarray(im1), jnp.asarray(fm0), jnp.asarray(cn0),
        jnp.asarray(init))
    step = rt.make_stream_step_fn(rt.RAFTConfig.full(**KW, iters_policy=policy),
                                  device="cpu")
    assert step.graphs is None
    got = step(model, im1, torch.from_numpy(fm0), torch.from_numpy(cn0), init)
    assert len(got) == len(want) == (5 if policy != "fixed" else 4)
    _hold(got[0].numpy(), want[0], "flow")
    _hold(got[1].numpy(), want[1], "flow_lr")
    for g, wt in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **ENCODER_TOL)
    if policy != "fixed":
        assert got[4].tolist() == np.asarray(want[4]).tolist() == [1]
    enc = rt.make_encode_fn(rt.RAFTConfig.full(**KW), device="cpu")(model, im1)
    for g, wt in zip(enc, want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **ENCODER_TOL)


def _pool(params, cfg, quant, seed=5, cap=4, n=3):
    """A slot pool (rows 0..cap-1, row cap the scratch slot) holding JAX's
    maps of n previous frames and seeds, as numpy arrays (int8 pairs from
    JAX's quantize_rows under quant), and n current frames."""
    rng = np.random.RandomState(seed)
    prev = _frames(seed, n)
    maps = [jax_raft.encode_frame(params, jnp.asarray(p), cfg) for p in prev]
    fbuf = np.zeros((cap + 1, h, w, 256), np.float32)
    cbuf = np.zeros((cap + 1, h, w, 256), np.float32)
    for i, (fm, cn) in enumerate(maps):
        fbuf[i], cbuf[i] = np.asarray(fm[0]), np.asarray(cn[0])
    flbuf = (2 * rng.randn(cap + 1, h, w, 2)).astype(np.float32)
    if quant:
        fbuf, cbuf = (tuple(np.array(x) for x in jax_raft.quantize_rows(
            jnp.asarray(b))) for b in (fbuf, cbuf))
    return fbuf, cbuf, flbuf, _frames(seed + 1, 1, B=n + 1)[0]


def _to_port(buf):
    if isinstance(buf, tuple):
        return tuple(torch.from_numpy(x) for x in buf)
    return torch.from_numpy(buf)


def _to_jax(buf):
    return tuple(map(jnp.asarray, buf)) if isinstance(buf, tuple) \
        else jnp.asarray(buf)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_stream_batch_step_matches_jax(pair, quant):
    """Three sessions in slots 2, 0 and 3 and a padding row on the scratch
    slot (active False), under converge (the padding row counts 0):
    each real row's flows within the bound of JAX's, the maps handed back
    at the encoder tolerance."""
    params, model = pair
    policy = "converge:1e9:2"
    jcfg = JaxConfig.full(**KW, iters_policy=policy, quant=quant)
    cfg = rt.RAFTConfig.full(**KW, iters_policy=policy, quant=quant)
    fbuf, cbuf, flbuf, images = _pool(params, jcfg, quant == "int8")
    slots = np.array([2, 0, 3, 4], np.int32)
    active = np.array([True, True, True, False])
    want = jax_raft.make_stream_batch_step_fn(jcfg)(
        params, jnp.asarray(images), _to_jax(fbuf), _to_jax(cbuf),
        jnp.asarray(flbuf), jnp.asarray(slots), jnp.asarray(active))
    got = rt.make_stream_batch_step_fn(cfg, device="cpu")(
        model, images, _to_port(fbuf), _to_port(cbuf),
        torch.from_numpy(flbuf), slots, active)
    assert got[4].tolist() == np.asarray(want[4]).tolist() == [2, 2, 2, 0]
    _hold(got[0][:3].numpy(), np.asarray(want[0])[:3], "flow")
    _hold(got[1][:3].numpy(), np.asarray(want[1])[:3], "flow_lr")
    for g, wt in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **ENCODER_TOL)
    with pytest.raises(ValueError, match="quant="):
        rt.make_stream_batch_step_fn(cfg, device="cpu")(
            model, images, torch.zeros(5, h, w, 256) if quant == "int8"
            else (torch.zeros(5, h, w, 256, dtype=torch.int8),
                  torch.ones(5, 256)),
            _to_port(cbuf), torch.from_numpy(flbuf), slots, active)


def test_quantize_rows_equal_jax_exactly():
    """int8 values and scales bit for bit (the same float32 division,
    absmax and round-half-to-even), an all-zero channel included, and the
    dequantized rows at 0 ulp."""
    rng = np.random.RandomState(7)
    rows = (rng.randn(3, 5, 7, 64) * rng.uniform(0.01, 30, 64)).astype(np.float32)
    rows[1, ..., 5] = 0.0
    rows[2, 0, 0, :8] = np.float32(0.5) * rows[2, ..., :8].max(axis=(0, 1))
    jv, js = jax_raft.quantize_rows(jnp.asarray(rows))
    v, s = rt.quantize_rows(torch.from_numpy(rows))
    assert v.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(rt.dequantize_rows(v, s).numpy(),
                                  np.asarray(jax_raft.dequantize_rows(jv, js)))
    assert not v[1, ..., 5].any()


@pytest.mark.parametrize("quant", ["bf16w", "int8+bf16w"])
def test_bf16_encoder_weights_match_jax(pair, quant):
    """Encoder weights stored bf16 (cast_encoder_weights in both
    packages), computed in float32: the encoders at the encoder tolerance
    of JAX's, and the batched step (int8 rows too under 'int8+bf16w')
    within the bound.  The model's dtype check accepts the bf16 encoders
    under this quant only."""
    params, model0 = pair
    jcfg = JaxConfig.full(**KW, quant=quant)
    cfg = rt.RAFTConfig.full(**KW, quant=quant)
    jparams = jax_raft.cast_encoder_weights(params, jcfg)
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(model0.state_dict())
    assert rt.cast_encoder_weights(model.eval(), cfg) is model
    assert next(model.fnet.parameters()).dtype == torch.bfloat16
    assert next(model.update_block.parameters()).dtype == torch.float32
    im = _frames(8, 1, B=2)[0]
    jf, jc = jax_raft.encode_frame(jparams, jnp.asarray(im), jcfg)
    f, c = rt.encode_frame(model, torch.from_numpy(im), cfg)
    assert f.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **ENCODER_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **ENCODER_TOL)
    fbuf, cbuf, flbuf, images = _pool(jparams, jcfg, "int8" in quant, seed=9,
                                      n=1)
    slots, active = np.array([0, 4], np.int32), np.array([True, False])
    want = jax_raft.make_stream_batch_step_fn(jcfg)(
        jparams, jnp.asarray(images), _to_jax(fbuf), _to_jax(cbuf),
        jnp.asarray(flbuf), jnp.asarray(slots), jnp.asarray(active))
    got = rt.make_stream_batch_step_fn(cfg, device="cpu")(
        model, images, _to_port(fbuf), _to_port(cbuf),
        torch.from_numpy(flbuf), slots, active)
    _hold(got[0][:1].numpy(), np.asarray(want[0])[:1], "flow")
    with pytest.raises(ValueError, match="fnet weights are torch.bfloat16"):
        rt.encode_frame(model, torch.from_numpy(im), rt.RAFTConfig.full(**KW))


@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batch"])
def test_ragged_stream_entries_match_jax(pair, batched):
    """The ragged stream steps on a 32x48 max box holding a 32x48 and a
    21x30 session: each item's flow on its crop within the bound of
    JAX's."""
    params, model = pair
    jcfg, cfg = JaxConfig.full(**KW), rt.RAFTConfig.full(**KW)
    sizes = np.array([[32, 48], [21, 30]], np.int32)
    rng = np.random.RandomState(10)
    prev, cur = (rng.rand(2, H, W, 3).astype(np.float32) for _ in range(2))
    jfm, jcn = (np.array(x) for x in jax_raft.encode_frame(
        params, jax_raft.mask_ragged_rows(jnp.asarray(prev),
                                          jnp.asarray(sizes)), jcfg))
    init = (2 * rng.randn(2, h, w, 2)).astype(np.float32)
    if batched:
        slots, active = np.array([1, 0], np.int32), np.array([True, True])
        fbuf, cbuf, flbuf = (np.ascontiguousarray(x[::-1])
                             for x in (jfm, jcn, init))
        want = jax_raft.make_ragged_stream_batch_step_fn(jcfg)(
            params, jnp.asarray(cur), jnp.asarray(fbuf), jnp.asarray(cbuf),
            jnp.asarray(flbuf), jnp.asarray(slots), jnp.asarray(active),
            jnp.asarray(sizes))
        got = rt.make_ragged_stream_batch_step_fn(cfg, device="cpu")(
            model, cur, *(torch.from_numpy(x) for x in (fbuf, cbuf, flbuf)),
            slots, active, sizes)
    else:
        want = jax_raft.make_ragged_stream_step_fn(jcfg)(
            params, jnp.asarray(cur), jnp.asarray(jfm), jnp.asarray(jcn),
            jnp.asarray(init), jnp.asarray(sizes))
        got = rt.make_ragged_stream_step_fn(cfg, device="cpu")(
            model, cur, torch.from_numpy(jfm), torch.from_numpy(jcn), init,
            sizes)
    for b, (hb, wb) in enumerate(sizes):
        _hold(got[0][b, :hb, :wb].numpy(), np.asarray(want[0])[b, :hb, :wb],
              f"item {b} flow")
        _hold(got[1][b, :hb // 8, :wb // 8].numpy(),
              np.asarray(want[1])[b, :hb // 8, :wb // 8], f"item {b} flow_lr")


def _flow_fields():
    """Three 1/8-grid flows [24, 32, 2]: a translation (whole border strips
    empty), a rotation about the centre with noise, and random motion."""
    rng = np.random.RandomState(12)
    ys, xs = np.mgrid[0:24, 0:32].astype(np.float32)
    shift = np.stack([np.full_like(xs, 3.4), np.full_like(ys, -2.6)], -1)
    rot = np.stack([-(ys - 12) * 0.3, (xs - 16) * 0.3], -1) + 0.4 * rng.randn(24, 32, 2)
    wild = 4.0 * rng.randn(24, 32, 2)
    return [f.astype(np.float32) for f in (shift, rot, wild)]


def test_warm_start_seed_matches_jax():
    """The splat bitwise; the fill equal wherever OpenCV picked the unique
    exact nearest hit, and elsewhere a value of an exact nearest hit;
    cold starts zeros in both."""
    import cv2
    differ, ties = 0, 0
    for flow in _flow_fields():
        f = flow.astype(np.float64)
        want_acc, want_hit, _ = jax_frame_utils._splat_average(f, f, oob="discard")
        acc, hit = port_warmstart._splat_average(f, f)
        np.testing.assert_array_equal(acc, want_acc)
        np.testing.assert_array_equal(hit, want_hit)
        got = rt.warm_start_seed(flow[None], (24, 32))[0]
        want = jax_warm_start(flow[None], (24, 32))[0]
        assert got.dtype == np.float32 and got.shape == (24, 32, 2)
        empty = (~hit).astype(np.uint8)
        _, labels = cv2.distanceTransformWithLabels(
            empty, cv2.DIST_L2, 3, labelType=cv2.DIST_LABEL_PIXEL)
        hits = np.argwhere(hit)
        for y, x in zip(*np.nonzero(hit)):
            assert np.array_equal(got[y, x], want[y, x])
        for y, x in zip(*np.nonzero(~hit)):
            d2 = ((hits - (y, x)) ** 2).sum(1)
            nearest = hits[d2 == d2.min()]
            cv_pick = hits[labels[y, x] - 1]
            vals = acc[nearest[:, 0], nearest[:, 1]].astype(np.float32)
            assert any(np.array_equal(got[y, x], v) for v in vals), (y, x)
            cv_exact = any(np.array_equal(cv_pick, n) for n in nearest)
            if len(nearest) == 1 and cv_exact:
                assert np.array_equal(got[y, x], want[y, x]), (y, x)
            if not np.array_equal(got[y, x], want[y, x]):
                differ += 1
                ties += cv_exact and len(nearest) > 1
    assert differ == ties == 226
    for prev, grid, reset in ((None, (24, 32), False),
                              (_flow_fields()[0][None], (24, 32), True),
                              (_flow_fields()[0][None], (12, 16), False)):
        np.testing.assert_array_equal(rt.warm_start_seed(prev, grid, reset),
                                      jax_warm_start(prev, grid, reset))


@pytest.mark.parametrize("policy", ["fixed", "converge:1e9:1"])
def test_stream_batch_graph_reads_the_pool_by_address(stand_in, policy):
    """On CUDA the batch step's graph reads the pool's buffers where they
    lie (held here with the stand-in graph of test_torch_port_capture.py):
    one capture for calls on the same buffers, an in-place write to a
    buffer seen by the next replay, a buffer that moved captured anew (a
    key of its own);
    each call equal to the eager step bitwise.  Under converge the key is
    three graphs, the encoders and the gathers in the prologue, and a
    padding row never extends the loop (one iteration replay)."""
    cfg = rt.RAFTConfig.full(**KW, iters_policy=policy)
    model = rt.init_raft_torch(cfg, device="cpu")
    entry = port_raft._stream_batch_entry(cfg, None, False)
    fn = capture_mod.GraphedForward(
        entry.forward, lambda m: None, entry.spec, entry.validate,
        staged=entry.forward if entry.forward.adaptive else None)
    eager = port_raft._factory(cfg, "cpu", entry)
    rng = np.random.RandomState(13)
    fbuf, cbuf = (torch.from_numpy(rng.randn(3, 2, 3, 256).astype(np.float32))
                  for _ in range(2))
    flbuf = torch.zeros(3, 2, 3, 2)
    images = rng.rand(2, 16, 24, 3).astype(np.float32)
    args = (fbuf, cbuf, flbuf, np.array([2, 0], np.int32),
            np.array([True, False]))
    for _ in range(2):
        got = fn(model, images, *args)
        for g, w in zip(got, eager(model, images, *args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        fbuf.mul_(0.5)                       # in place: the next replay reads it
    assert fn.captures == 1
    if policy != "fixed":
        assert got[4].tolist() == [1, 0] and fn.step_replays == 1
    moved = (fbuf.clone(),) + args[1:]
    got = fn(model, images, *moved)
    torch.testing.assert_close(got[0], eager(model, images, *moved)[0],
                               rtol=0, atol=0)
    assert fn.captures == 2 and fn.graph_count() == 2


@pytest.mark.parametrize("policy", ["fixed", "converge:1e9:1"])
def test_stream_batch_pools_in_turns_keep_their_graphs(stand_in, policy):
    """Two slot pools of one shape used in turns: each pool's addresses are
    part of its key, so each is captured once and every later call replays
    its own graph, equal to the eager step on that pool bitwise."""
    cfg = rt.RAFTConfig.full(**KW, iters_policy=policy)
    model = rt.init_raft_torch(cfg, device="cpu")
    entry = port_raft._stream_batch_entry(cfg, None, False)
    fn = capture_mod.GraphedForward(
        entry.forward, lambda m: None, entry.spec, entry.validate,
        staged=entry.forward if entry.forward.adaptive else None)
    eager = port_raft._factory(cfg, "cpu", entry)
    rng = np.random.RandomState(14)
    pools = [tuple(torch.from_numpy(rng.randn(3, 2, 3, c).astype(np.float32))
                   for c in (256, 256, 2)) for _ in range(2)]
    images = rng.rand(2, 16, 24, 3).astype(np.float32)
    rows = (np.array([1, 0], np.int32), np.array([True, True]))
    for k in range(4):
        args = (images,) + pools[k % 2] + rows
        for g, w in zip(fn(model, *args), eager(model, *args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fn.captures == 2 and fn.graph_count() == 2
