"""The port's converge iteration policy and counted inference against the
JAX package: ``iters_policy='converge:eps[:min_iters]'`` through
``raft_forward``, ``make_counted_inference_fn``, the ragged counted entry
and ``forward_from_features`` with padding rows, on the full model with
the kernels' names (their plain versions on the CPU; JAX's Pallas kernels
in interpret mode), numpy-seeded weights through ``from_jax_params`` (zero
biases, or the biased ones of ``test_torch_port_model.with_biases``).

``iters_used`` must equal JAX's exactly.  So ``eps`` is chosen from JAX's
own per-iteration ``dn`` (the mean L2 norm of a sample's flow update, from
the differences of its low-resolution flows after 1, 2 and 3 iterations),
midway between two of the values, so that the two samples freeze at
different iterations and no sample's ``dn`` lies within the full-model
tolerance of ``eps``.  Flows are held to the full-model bound ``1e-3 +
1e-3 * max|flow|``.  ``converge:0`` is bitwise the fixed policy in the
port.  The CUDA graphs of the converge policy (three per key) are held
here with the stand-in graph of ``test_torch_port_capture.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.raft import (forward_from_features as jax_from_features,
                                  make_counted_inference_fn as jax_counted,
                                  make_ragged_counted_inference_fn as
                                  jax_ragged_counted,
                                  raft_forward as jax_forward)
import raft_tpu_torch as rt
from raft_tpu_torch.models import capture as capture_mod
from raft_tpu_torch.models import raft as port_raft
from test_torch_port_capture import stand_in  # noqa: F401 (a fixture)
from test_torch_port_model import BIASED
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

ITERS = 3
KW = dict(corr_impl="pallas", gru_impl="pallas", iters=ITERS)


def _hold(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-3 + 1e-3 * scale, (
        f"{label}: max|diff| {err:.3e} vs scale {scale:.3e}")


def _case(biased, seed=3, H=32, W=48):
    params = seeded_jax_params(JaxConfig.full(), seed=0, biased=biased)
    model = rt.RAFT(rt.RAFTConfig.full())
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    im = np.random.RandomState(seed).rand(2, 2, H, W, 3).astype(np.float32)
    return params, model.eval(), im


def _jax_dn(params, im):
    """JAX's per-iteration dn [ITERS, B] under the fixed policy."""
    lr = [np.zeros((2, 4, 6, 2), np.float32)]
    for k in range(1, ITERS + 1):
        out, _ = jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]),
                             JaxConfig.full(**{**KW, "iters": k}))
        lr.append(np.asarray(out.flow_lr))
    return np.stack([np.sqrt(((b - a) ** 2).sum(-1)).mean((1, 2))
                     for a, b in zip(lr, lr[1:])])


def _freeze_counts(dn, eps, min_iters=1):
    """iters_used of each sample under converge:eps:min_iters."""
    used = []
    for b in range(dn.shape[1]):
        hit = [i for i in range(ITERS) if dn[i, b] < eps and i + 1 >= min_iters]
        used.append(hit[0] + 1 if hit else ITERS)
    return used


def _pick_eps(dn):
    """A midpoint of two sorted dn values at which the samples freeze at
    different iterations, the one farthest from every dn (relative)."""
    vals = np.unique(dn)
    best = None
    for lo, hi in zip(vals, vals[1:]):
        eps = 0.5 * (lo + hi)
        used = _freeze_counts(dn, eps)
        if len(set(used)) < 2:
            continue
        gap = np.abs(dn - eps).min()
        if best is None or gap > best[1]:
            best = (eps, gap, used)
    return best


@BIASED
def test_converge_matches_jax_iters_used_and_flows(biased):
    params, model, im = _case(biased)
    dn = _jax_dn(params, im)
    eps, gap, used = _pick_eps(dn)
    # no sample's dn within the full-model tolerance of eps
    assert gap > 1e-3 + 1e-3 * np.abs(dn).max(), (dn, eps)
    policy = f"converge:{float(eps)!r}"
    jflow, jused = jax_counted(JaxConfig.full(**KW, iters_policy=policy))(
        params, jnp.asarray(im[0]), jnp.asarray(im[1]))
    assert np.asarray(jused).tolist() == used
    cfg = rt.RAFTConfig.full(**KW, iters_policy=policy)
    flow, got = rt.make_counted_inference_fn(cfg, device="cpu")(model, im[0],
                                                                im[1])
    assert got.dtype == torch.int32 and got.tolist() == used
    _hold(flow.numpy(), jflow, "counted")
    out = rt.raft_forward(model, torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]), cfg)
    torch.testing.assert_close(out.flow, flow, rtol=0, atol=0)
    assert out.iters_used.tolist() == used


def test_converge_zero_is_fixed_bitwise():
    """A norm is never < 0: converge:0 (with any min_iters) runs every
    iteration of every sample and gives the fixed policy's values bit for
    bit, through raft_forward (also with all_flows) and the counted entry."""
    _, model, im = _case(False, seed=4, H=16, W=24)
    a, b = torch.from_numpy(im[0]), torch.from_numpy(im[1])
    fixed = rt.RAFTConfig.full(**KW)
    want = rt.raft_forward(model, a, b, fixed, all_flows=True)
    for policy in ("converge:0", "converge:0.0:2"):
        cfg = dataclasses.replace(fixed, iters_policy=policy)
        got = rt.raft_forward(model, a, b, cfg, all_flows=True)
        for k in ("flow", "flow_iters", "flow_lr", "iters_used"):
            torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                       rtol=0, atol=0)
        flow, used = rt.make_counted_inference_fn(cfg, device="cpu")(
            model, im[0], im[1])
        torch.testing.assert_close(flow, want.flow, rtol=0, atol=0)
        assert used.tolist() == [ITERS, ITERS]


@pytest.mark.parametrize("min_iters", [2, 3])
def test_min_iters_matches_jax(min_iters):
    """eps = 1e9 freezes every sample at its first chance: iteration
    min_iters."""
    params, model, im = _case(False, seed=5)
    policy = f"converge:1e9:{min_iters}"
    jflow, jused = jax_counted(JaxConfig.full(**KW, iters_policy=policy))(
        params, jnp.asarray(im[0]), jnp.asarray(im[1]))
    flow, used = rt.make_counted_inference_fn(
        rt.RAFTConfig.full(**KW, iters_policy=policy), device="cpu")(
        model, im[0], im[1])
    assert used.tolist() == np.asarray(jused).tolist() == [min_iters] * 2
    _hold(flow.numpy(), jflow, policy)


def test_padding_rows_match_jax_and_never_extend_the_loop():
    """forward_from_features with active [True, False] from the same numpy
    features in both packages: the padding row starts frozen (iters_used
    0, its flow the seed's upsampling), and the loop ends with the real
    row (eps 1e9:2: two iterations, not ITERS); a batch of padding rows
    alone runs no iteration."""
    params, model, _ = _case(False)
    rng = np.random.RandomState(6)
    f1, f2 = (rng.randn(2, 4, 6, 256).astype(np.float32) for _ in range(2))
    cnet = rng.randn(2, 4, 6, 256).astype(np.float32)
    init = (2 * rng.randn(2, 4, 6, 2)).astype(np.float32)
    jcfg = JaxConfig.full(**KW, iters_policy="converge:1e9:2")
    cfg = rt.RAFTConfig.full(**KW, iters_policy="converge:1e9:2")
    t = torch.from_numpy
    for active in ([True, False], [False, False]):
        want = jax_from_features(params, *map(jnp.asarray, (f1, f2, cnet)),
                                 jcfg, flow_init=jnp.asarray(init),
                                 active=jnp.asarray(active))
        got = rt.forward_from_features(model, t(f1), t(f2), t(cnet), cfg,
                                       flow_init=t(init),
                                       active=torch.tensor(active))
        assert got.iters_used.tolist() == np.asarray(want.iters_used).tolist() \
            == [2 if a else 0 for a in active]
        _hold(got.flow.numpy(), want.flow, f"active {active}")
        _hold(got.flow_lr.numpy(), want.flow_lr, f"active {active}")
    # none ran: (coords0 + init) - coords0 in both, bit for bit
    np.testing.assert_array_equal(got.flow_lr.numpy(), np.asarray(want.flow_lr))
    fixed = rt.forward_from_features(model, t(f1), t(f2), t(cnet),
                                     rt.RAFTConfig.full(**KW),
                                     active=torch.tensor([True, False]))
    assert fixed.iters_used.tolist() == [ITERS, 0]


def test_all_flows_under_converge_matches_jax():
    """all_flows=True runs the masked loop over every iteration (no early
    exit): per iteration within the bound of JAX's masked scan, and a
    frozen sample's later flows repeat its frozen flow exactly."""
    params, model, im = _case(False, seed=7)
    policy = "converge:1e9:2"
    want, _ = jax_forward(params, jnp.asarray(im[0]), jnp.asarray(im[1]),
                          JaxConfig.full(**KW, iters_policy=policy),
                          all_flows=True)
    got = rt.raft_forward(model, torch.from_numpy(im[0]),
                          torch.from_numpy(im[1]),
                          rt.RAFTConfig.full(**KW, iters_policy=policy),
                          all_flows=True)
    assert got.iters_used.tolist() == np.asarray(want.iters_used).tolist()
    for i in range(ITERS):
        _hold(got.flow_iters[i].numpy(), want.flow_iters[i], f"iteration {i}")
    torch.testing.assert_close(got.flow_iters[2], got.flow_iters[1],
                               rtol=0, atol=0)
    torch.testing.assert_close(got.flow, got.flow_iters[-1], rtol=0, atol=0)


def test_ragged_counted_converge_matches_jax():
    """The ragged counted entry under a converge policy: iters_used as
    JAX's, each item's flow on its crop within the bound."""
    params, model, _ = _case(False)
    rng = np.random.RandomState(8)
    im = rng.rand(2, 2, 32, 48, 3).astype(np.float32)
    sizes = np.array([[32, 48], [21, 30]], np.int32)
    policy = "converge:1e9:2"
    jflow, jused = jax_ragged_counted(JaxConfig.full(**KW, iters_policy=policy))(
        params, jnp.asarray(im[0]), jnp.asarray(im[1]), jnp.asarray(sizes))
    flow, used = rt.make_ragged_counted_inference_fn(
        rt.RAFTConfig.full(**KW, iters_policy=policy), device="cpu")(
        model, im[0], im[1], sizes)
    assert used.tolist() == np.asarray(jused).tolist() == [2, 2]
    for b, (h, w) in enumerate(sizes):
        _hold(flow[b, :h, :w].numpy(), np.asarray(jflow)[b, :h, :w], f"item {b}")


def test_converge_key_captures_three_graphs(stand_in):
    """On CUDA a converge key is three graphs from one pool (prologue, one
    masked iteration, epilogue), captured once; a call replays the
    iteration max(iters_used) times (``step_replays``) and equals the
    eager forward bitwise (here with the stand-in graph, which re-runs the
    captured function as a replay writes its buffers)."""
    cfg = rt.RAFTConfig.full(**{**KW, "iters": 4}, iters_policy="converge:1e9:2")
    model = rt.init_raft_torch(cfg, device="cpu")
    forward, spec, validate = port_raft._pair_entry(cfg, None, False)
    fn = capture_mod.GraphedForward(forward, lambda m: None, spec, validate,
                                    staged=forward)
    eager = port_raft._factory(cfg, "cpu", (forward, spec, validate))
    im = np.random.RandomState(9).rand(2, 2, 16, 24, 3).astype(np.float32)
    for _ in range(2):
        got = fn(model, im[0], im[1])
        want = eager(model, im[0], im[1])
        torch.testing.assert_close(got.flow, want.flow, rtol=0, atol=0)
        assert got.iters_used.tolist() == want.iters_used.tolist() == [2, 2]
        assert fn.step_replays == 2
    assert fn.captures == 1 and fn.graph_count() == 1
    assert stand_in == ["pool"] * 3
