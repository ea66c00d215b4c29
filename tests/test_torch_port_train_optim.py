"""The port's training pieces against the JAX package's, on seeded numpy
inputs: the sequence loss and the EPE metrics (both normalizations, a
sparse valid mask, ``max_flow``); the optimizer against optax (clip,
adamw / adam / sgd, each schedule, ``apply_if_finite``) over 12 steps with
one clipped step and one non-finite gradient, every parameter and state
leaf within 1e-6 of its leaf's max and named as optax names it; and
training-mode batch norm (output and running statistics) and
``freeze_bn``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.ops.norm import batch_norm as jax_batch_norm
from raft_tpu.training.checkpoint import _named_leaves
from raft_tpu.training.loss import epe_metrics as jax_epe
from raft_tpu.training.loss import sequence_loss as jax_sequence_loss
from raft_tpu.training.optim import make_optimizer as jax_optimizer

from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.ops.norm import BatchNorm
from raft_tpu_torch.training import epe_metrics, make_optimizer, sequence_loss

torch.set_num_threads(2)   # several test workers share the host's cores

RTOL = 1e-6


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), \
        (what, np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("normalization", ["total", "valid"])
def test_sequence_loss_and_metrics_match_jax(normalization):
    rng = np.random.RandomState(0)
    preds = (4.0 * rng.randn(3, 2, 16, 24, 2)).astype(np.float32)
    gt = (4.0 * rng.randn(2, 16, 24, 2)).astype(np.float32)
    gt[0, :3] *= 100.0                      # beyond max_flow: masked out
    valid = (rng.rand(2, 16, 24) > 0.6).astype(np.float32)
    kw = dict(gamma=0.8, max_flow=50.0, normalization=normalization)
    loss, m = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                            torch.from_numpy(valid), **kw)
    jloss, jm = jax_sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                  jnp.asarray(valid), **kw)
    _close(float(loss), float(jloss), 1e-6, "loss")
    assert set(m) == set(jm)
    for k in m:
        _close(float(m[k]), float(jm[k]), 1e-6, k)
    for reduce in ("mean", "sum"):
        got = epe_metrics(torch.from_numpy(preds[-1]), torch.from_numpy(gt),
                          torch.from_numpy(valid), reduce=reduce)
        want = jax_epe(jnp.asarray(preds[-1]), jnp.asarray(gt),
                       jnp.asarray(valid), reduce=reduce)
        assert set(got) == set(want)
        for k in got:
            _close(float(got[k]), float(want[k]), 1e-6, f"{reduce} {k}")
    with pytest.raises(ValueError):
        sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                      normalization="pixels")


# a toy parameter tree: JAX path -> shape (the port's list follows the
# sorted paths, as jax.tree flattens a dict)
TOY = {"a/w": (3, 3, 4, 5), "a/b": (5,), "c/gamma": (7,), "d": (2, 6)}
NAN_STEP, BIG_STEP, STEPS = 4, 7, 12


def _toy_grads():
    rng = np.random.RandomState(1)
    out = []
    for step in range(STEPS):
        g = {k: (0.05 * rng.randn(*s)).astype(np.float32)
             for k, s in TOY.items()}
        if step == BIG_STEP:                 # global norm > clip: clipped
            g = {k: 40.0 * v for k, v in g.items()}
        if step == NAN_STEP:                 # dropped by apply_if_finite
            g["a/b"] = g["a/b"].copy()
            g["a/b"][2] = np.nan
        out.append(g)
    return out


def _tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("schedule", ["one_cycle", "constant", "cyclic"])
@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(optimizer, schedule):
    kw = dict(optimizer=optimizer, schedule=schedule, num_steps=STEPS,
              lr=0.05, weight_decay=1e-2, clip_norm=1.0)
    jtx = jax_optimizer(JaxTrainConfig(**kw))
    tx = make_optimizer(TrainConfig(**kw))
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in TOY.items()}
    names = sorted(TOY)
    jparams = _tree(init)
    jstate = jtx.init(jparams)
    jupdate = jax.jit(lambda g, st, ps: (lambda u: (optax.apply_updates(
        ps, u[0]), u[1], optax.global_norm(g)))(jtx.update(g, st, ps)))
    params = [torch.from_numpy(init[k].copy()) for k in names]
    state = tx.init(params)
    for g in _toy_grads():
        jparams, jstate, want = jupdate(_tree(g), jstate, jparams)
        norm = tx.update([torch.from_numpy(g[k]) for k in names], state,
                         params)
        want = float(want)
        assert np.isnan(want) or abs(float(norm) - want) <= 1e-6 * want
        jflat = {"/".join(str(getattr(p, "key", p)) for p in path): v
                 for path, v in jax.tree_util.tree_flatten_with_path(
                     jparams)[0]}
        for k, p in zip(names, params):
            _close(p.numpy(), jflat[k], what=f"param {k}")
    # every state leaf, by optax's names (the checkpoints' opt_state/...)
    jnamed = {k: np.asarray(v) for k, v in _named_leaves(jstate).items()}
    mine = {}
    for suffix, leaf in state.leaves():
        if isinstance(leaf, list):
            for k, t in zip(names, leaf):
                mine[f"{suffix}/{k}"] = t.numpy()
        else:
            mine[suffix] = leaf.numpy()
    assert set(mine) == set(jnamed)
    for k, v in jnamed.items():
        assert mine[k].dtype == v.dtype, k
        _close(mine[k], v, what=k)
    assert int(mine["total_notfinite"]) == 1
    assert int(mine["notfinite_count"]) == 0 and bool(mine["last_finite"])


def test_nonfinite_step_leaves_inner_state_unchanged():
    """A non-finite gradient zeroes the update and keeps the moments and
    counts as they were; the wrapper counts it."""
    tx = make_optimizer(TrainConfig(optimizer="adamw", num_steps=10))
    params = [torch.ones(3), torch.zeros(2, 2)]
    state = tx.init(params)
    tx.update([torch.full((3,), 0.1), torch.full((2, 2), -0.2)], state, params)
    before = ([p.clone() for p in params], [m.clone() for m in state.mu],
              [v.clone() for v in state.nu], state.count.clone(),
              state.sched_count.clone())
    tx.update([torch.tensor([0.1, float("inf"), 0.0]), torch.zeros(2, 2)],
              state, params)
    for a, b in zip(before[0] + before[1] + before[2],
                    params + state.mu + state.nu):
        assert torch.equal(a, b)
    assert torch.equal(before[3], state.count)
    assert torch.equal(before[4], state.sched_count)
    assert int(state.notfinite_count) == 1 and int(state.total_notfinite) == 1
    assert not bool(state.last_finite)


def _jax_bn(params, x_nchw, train):
    out, new = jax_batch_norm(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x_nchw.transpose(0, 2, 3, 1)), train=train)
    return np.asarray(out).transpose(0, 3, 1, 2), new


def test_train_mode_batch_norm_matches_jax():
    rng = np.random.RandomState(2)
    x = (3.0 * rng.randn(4, 6, 5, 7) + 1.5).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "beta": rng.uniform(-0.5, 0.5, 6).astype(np.float32),
         "mean": rng.uniform(-0.2, 0.2, 6).astype(np.float32),
         "var": rng.uniform(0.8, 1.2, 6).astype(np.float32)}
    bn = BatchNorm(6)
    with torch.no_grad():
        for name, key in (("weight", "gamma"), ("bias", "beta"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))
    bn.batch_stats = True
    out = bn(torch.from_numpy(x))
    jout, jnew = _jax_bn(p, x, train=True)
    _close(out.detach().numpy(), jout, 1e-5, "output")
    _close(bn.running_mean.numpy(), np.asarray(jnew["mean"]), 1e-6, "mean")
    _close(bn.running_var.numpy(), np.asarray(jnew["var"]), 1e-6, "var")

    # eval mode (freeze_bn): the running statistics are used and left bit
    # for bit; the affine parameters get the gradient JAX gives them
    before = (bn.running_mean.clone(), bn.running_var.clone())
    bn.batch_stats = False
    xt = torch.from_numpy(x)
    w = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    (bn(xt) * w).sum().backward()
    assert torch.equal(before[0], bn.running_mean)
    assert torch.equal(before[1], bn.running_var)
    state = {"mean": before[0].numpy(), "var": before[1].numpy()}

    def f(gamma, beta):
        out, _ = jax_batch_norm({"gamma": gamma, "beta": beta,
                                 "mean": jnp.asarray(state["mean"]),
                                 "var": jnp.asarray(state["var"])},
                                jnp.asarray(x.transpose(0, 2, 3, 1)))
        return (out * jnp.asarray(w.numpy().transpose(0, 2, 3, 1))).sum()
    gg, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(p["gamma"]),
                                         jnp.asarray(p["beta"]))
    _close(bn.weight.grad.numpy(), np.asarray(gg), 1e-5, "d gamma")
    _close(bn.bias.grad.numpy(), np.asarray(gb), 1e-5, "d beta")
