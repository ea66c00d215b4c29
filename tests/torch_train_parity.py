"""Shared pieces of the training parity tests (tests/test_torch_port_train_*):
seeded batches, one JAX ``make_train_step`` and its gradients, one port
step and its gradients, and the checks that hold one against the other.

Why the gradient checks are not elementwise at 1e-4 of each leaf's max:
the random-weight model's float32 gradients are ill-conditioned (the L1
loss's +-1 terms cancel across thousands of pixels; the recurrence
amplifies rounding) and not smooth (a ReLU input within rounding of 0
lands on either side in two float32 computations).  At 48x64, 2
iterations, the port's own float32 gradient differs from its float64
gradient by up to 677x ``1e-4 * max|g_leaf| + 1e-7`` in a leaf
(fnet/layer3/1/conv2/w) and by 0.6-1.2% of the leaf's L2 norm in the
worst leaves; JAX's float32 gradient lies at the same distance.  So a leaf
is held by its L2 norm (:data:`LEAF_RTOL`), the whole gradient by
:data:`GRAD_RTOL`, and the conv biases feeding a normalization, whose
exact gradient is 0, by their size against the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.training import Batch as JaxBatch
from raft_tpu.training import TrainState as JaxState
from raft_tpu.training import make_optimizer as jax_optimizer
from raft_tpu.training import make_train_step as jax_train_step
from raft_tpu.training.checkpoint import _named_leaves

import raft_tpu_torch as rt
from raft_tpu_torch.convert.weights import (_jax_leaves, to_jax_params,
                                            to_jax_train_state)
from raft_tpu_torch.training import TrainState, make_optimizer, make_train_step

torch.set_num_threads(2)   # several test workers share the host's cores

LOSS_RTOL = 1e-5          # the loss, relative
LEAF_RTOL = 3e-2          # ||g_port - g_jax|| / ||g_jax|| per leaf
GRAD_RTOL = 1e-2          # the same over the whole gradient
ZERO_ATOL = 1e-5          # a zero-gradient leaf's max, over the largest |g|
BN_RTOL = 1e-5            # running statistics, of the leaf's max
B1 = 0.9


def make_params(config, seed: int = 0, biased: bool = False) -> dict:
    """A JAX parameter tree (numpy) of seeded random weights: the port's
    initialization converted (Kaiming convs), batch-norm statistics drawn
    away from 0 and 1 and, with ``biased``, every conv bias and ``beta``
    from U(-0.25, 0.25) and every ``gamma`` from U(0.75, 1.25) — what
    tests/test_torch_port_model.py's ``_jax_params`` draws, without JAX's
    slow eager initialization."""
    model = rt.init_raft_torch(config, torch.Generator().manual_seed(seed),
                               device="cpu")
    tree = to_jax_params(model.state_dict())
    rng = np.random.RandomState(seed + 1)
    brng = np.random.RandomState(seed + 1000)

    def fill(node):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                node[k] = rng.uniform(-0.05, 0.05, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.9, 1.1, v.shape).astype(np.float32)
            elif biased and k in ("b", "beta"):
                node[k] = brng.uniform(-0.25, 0.25, v.shape).astype(np.float32)
            elif biased and k == "gamma":
                node[k] = brng.uniform(0.75, 1.25, v.shape).astype(np.float32)
    fill(tree)
    return tree


def make_batch(seed: int = 0, B: int = 2, H: int = 48, W: int = 64):
    """Seeded (im1, im2, flow, valid): frames in [0, 1], flows of a few
    pixels, about 70% of the pixels valid."""
    rng = np.random.RandomState(seed)
    return (rng.rand(B, H, W, 3).astype(np.float32),
            rng.rand(B, H, W, 3).astype(np.float32),
            (3.0 * rng.randn(B, H, W, 2)).astype(np.float32),
            (rng.rand(B, H, W) > 0.3).astype(np.float32))


def stage_kwargs(**overrides) -> dict:
    """The chairs stage's hyperparameters, sized for the CPU tests."""
    kw = dict(num_steps=100, lr=4e-4, batch_size=2, image_size=(48, 64),
              weight_decay=1e-4)
    kw.update(overrides)
    return kw


class JaxStep:
    """``jax.jit(make_train_step)`` with the JAX package's optimizer,
    compiled once, at its first call (share it through a module-scoped
    fixture).  XLA's expensive LLVM passes are skipped: the same HLO
    compiles in about 10 s instead of 20-30 s (it runs in 0.4 s instead
    of 0.3 s)."""

    def __init__(self, jcfg, jtc):
        self.tc = jtc
        self.tx = jax_optimizer(jtc)
        self.jitted = jax.jit(jax_train_step(jcfg, jtc, self.tx))
        self.fn = None

    def create(self, params):
        return JaxState.create(params, self.tx)

    def __call__(self, state, batch, seed: int = 0):
        args = (state, JaxBatch(*map(jnp.asarray, batch)),
                jax.random.PRNGKey(seed))
        if self.fn is None:
            self.fn = self.jitted.lower(*args).compile(
                {"xla_llvm_disable_expensive_passes": True})
        return self.fn(*args)


def named(state) -> dict:
    return {k: np.asarray(v) for k, v in
            _named_leaves(jax.device_get(state)).items()}


def jax_first_grads(new_state, metrics, clip: float) -> dict:
    """A first (accepted) step's gradients, by JAX parameter path, read
    back from Adam's first moment: ``mu = (1 - b1) * clipped(g)``."""
    mu = new_state.opt_state.inner_state[1][0].mu
    norm = float(metrics["grad_norm"])
    scale = norm / clip if norm >= clip else 1.0
    return {k[len("mu/"):]: np.asarray(v, np.float64) / np.float32(1 - B1)
            * scale for k, v in named({"mu": mu}).items()}


def port_step(cfg, tc, params, batch, seed: int = 0, state=None):
    """One port train step on the CPU from the JAX ``params`` (or from
    ``state``); returns (state, metrics, its gradients by JAX path)."""
    tx = make_optimizer(tc)
    if state is None:
        model = rt.RAFT(cfg)
        model.load_state_dict(rt.from_jax_params(params), strict=True)
        state = TrainState.create(model.eval(), tx)
    got = {}

    class Capture:
        """The optimizer, keeping the gradients it is given."""

        def update(self, grads, opt_state, ps):
            got["g"] = [g.detach().clone() for g in grads]
            return tx.update(grads, opt_state, ps)
    state, metrics = make_train_step(cfg, tc, Capture())(state, batch, seed)
    layout = _jax_leaves(state.model.state_dict().keys())
    grads = {}
    for (n, _), g in zip(state.model.named_parameters(), got["g"]):
        path, kernel = layout[n]
        g = g.numpy().astype(np.float64)
        grads[path] = g.transpose(2, 3, 1, 0) if kernel else g
    return state, metrics, grads


def zero_grad_leaf(path: str, small: bool, frozen: bool = False) -> bool:
    """A conv bias followed by a normalization over the batch's or the
    sample's statistics (every encoder conv but the output ``conv2``;
    raft-small's cnet has no norm, a frozen batch norm is affine): its
    exact gradient is 0."""
    parts = path.split("/")
    normed = parts[0] == "fnet" or (parts[0] == "cnet" and not small
                                    and not frozen)
    return normed and parts[-1] == "b" and parts[1:] != ["conv2", "b"]


def check_loss(metrics, jmetrics):
    lp, lj = float(metrics["loss"]), float(jmetrics["loss"])
    assert np.isfinite(lp) and abs(lp - lj) <= LOSS_RTOL * abs(lj), (lp, lj)


def check_grads(gp: dict, gj: dict, small: bool, frozen: bool = False
                ) -> None:
    assert set(gp) == set(gj)
    gscale = max(np.abs(g).max() for g in gj.values())
    num = den = 0.0
    for k, j in gj.items():
        p = gp[k]
        assert p.shape == j.shape, k
        if zero_grad_leaf(k, small, frozen):
            assert max(np.abs(p).max(), np.abs(j).max()) <= ZERO_ATOL * gscale, k
            continue
        d, n = np.linalg.norm(p - j), np.linalg.norm(j)
        assert d <= LEAF_RTOL * n, (k, d / n)
        num, den = num + d * d, den + n * n
    assert np.sqrt(num) <= GRAD_RTOL * np.sqrt(den), np.sqrt(num / den)


def check_bn(pnamed: dict, jnamed: dict) -> None:
    keys = [k for k in jnamed if k.startswith("bn_state/")]
    for k in keys:
        d = np.abs(pnamed[k].astype(np.float64) - jnamed[k]).max()
        assert d <= BN_RTOL * np.abs(jnamed[k]).max(), (k, d)


def check_first_update(pnamed, jnamed, p0: dict, gp, gj, tc, mp, mj):
    """Parameters after a first AdamW step: ``p - lr0 * (g_c / (|g_c| +
    eps) + wd * p)`` for each package's own clipped gradient ``g_c``; they
    agree as far as the two gradients' normalized values do, plus
    float32 rounding of the parameters and of Adam's bias corrections (a
    relative 1e-5 of the step)."""
    lr0 = tc.lr / 25.0                      # one-cycle's first learning rate

    def unit(g, metrics):
        norm = float(metrics["grad_norm"])
        gc = g / norm * tc.clip_norm if norm >= tc.clip_norm else g
        return gc / (np.abs(gc) + tc.adamw_eps)
    for k, j in jnamed.items():
        if not k.startswith("params/"):
            continue
        path = k[len("params/"):]
        bound = (2e-7 * np.abs(p0[path]).max() + 1e-5 * lr0
                 + lr0 * np.abs(unit(gp[path], mp) - unit(gj[path], mj)))
        assert (np.abs(pnamed[k].astype(np.float64) - j) <= bound).all(), k



def check_variant(jax_step: JaxStep, cfg, tc, B: int) -> None:
    """One step of a configuration and recipe from the same seeded biased
    weights and batch in both packages, held as
    tests/test_torch_port_train_step.py holds the main one; under
    ``freeze_bn`` the running statistics stay bit for bit and the
    batch-norm affines move, otherwise the statistics move."""
    params = make_params(cfg, seed=3, biased=True)
    batch = make_batch(5, B=B)
    j0 = jax_step.create(params)
    jstate, jm = jax_step(j0, batch)
    state, m, gp = port_step(cfg, tc, params, batch)
    check_loss(m, jm)
    gj = jax_first_grads(jstate, jm, tc.clip_norm)
    check_grads(gp, gj, small=cfg.small, frozen=tc.freeze_bn)
    pn, jn, n0 = to_jax_train_state(state), named(jstate), named(j0)
    check_bn(pn, jn)
    p0 = {k[len("params/"):]: v for k, v in n0.items()
          if k.startswith("params/")}
    check_first_update(pn, jn, p0, gp, gj, tc, m, jm)
    bn = [k for k in pn if k.startswith("bn_state/")]
    assert bool(bn) != cfg.small
    if tc.freeze_bn:
        for k in bn:                     # bit for bit, in both packages
            np.testing.assert_array_equal(pn[k], n0[k], err_msg=k)
            np.testing.assert_array_equal(jn[k], n0[k], err_msg=k)
        affines = [k for k in pn if k.startswith("params/cnet/")
                   and k.rsplit("/", 1)[-1] in ("gamma", "beta")]
        assert affines and all(np.abs(pn[k] - n0[k]).max() > 0
                               for k in affines)
    elif bn:
        assert all(np.abs(pn[k] - n0[k]).max() > 0 for k in bn)
