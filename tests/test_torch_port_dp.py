"""The port's data-parallel layer (``raft_tpu_torch/parallel/
data_parallel.py``) on the CPU: the train step over 2 gloo ranks against
the single-process step on the whole batch (and, for raft-small, against
the JAX package's ``make_dp_train_step`` on 2 virtual devices), the
evaluation function over two CPU replicas, and data-parallel serving's
configuration and engine.

One group of 2 ranks (``tests/torch_parallel_ranks.py::dp_rank``, started
once for the module, a ``file://`` rendezvous, a 60 s group timeout and a
deadline) runs every step case; each case is then its own test.  The
whole-batch references run in the test process meanwhile.

Bounds (tests/torch_train_parity.py's held ones): the loss at
1e-5 relative; the gradient handed to the optimizer, each leaf by its L2
norm at 3e-2 and as a whole at 1e-2, the leaves whose exact gradient is 0
by their size against the largest gradient; the synchronized batch-norm
running statistics at 1e-5 of each leaf's largest magnitude.  The ranks'
updated parameters must agree bit for bit (one update on every replica).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.parallel import make_dp_train_step as jax_dp_step
from raft_tpu.parallel import make_mesh as jax_make_mesh
from raft_tpu.parallel import shard_batch as jax_shard_batch
from raft_tpu.serving.config import ServeConfig as JaxServeConfig
from raft_tpu.training import Batch as JaxBatch
from raft_tpu.training import TrainState as JaxState
from raft_tpu.training import make_optimizer as jax_optimizer

import raft_tpu_torch as rt
from raft_tpu_torch.convert.weights import _jax_leaves, to_jax_params
from raft_tpu_torch.ops import spmd
from raft_tpu_torch.parallel import (DATA_AXIS, Mesh, make_dp_eval_fn,
                                     make_pjit_train_step, shard_batch)
from raft_tpu_torch.parallel.launch import start_ranks
from raft_tpu_torch.serving.config import ServeConfig
from raft_tpu_torch.serving.engine import InferenceEngine
from raft_tpu_torch.training import make_optimizer

import torch_parallel_ranks as R
from torch_train_parity import check_grads, jax_first_grads

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
BN_RTOL = 1e-5


class _Ranks:
    def __init__(self, group):
        self.group, self.out = group, None

    def get(self):
        if self.out is None:
            self.out = self.group.results()
        return self.out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("dp_rdv") / "store"
    group = start_ranks(R.dp_rank, 2, args=(list(R.DP_CASES),),
                        init_method=f"file://{store}", group_timeout_s=60,
                        deadline_s=500, threads=R.THREADS)
    yield _Ranks(group)
    group._stop()


def _by_path(grads: dict, bufs: dict) -> dict:
    """Port gradients by parameter name -> by JAX path (HWIO kernels); the
    buffers' names tell a batch norm's leaves from a conv's."""
    layout = _jax_leaves(list(grads) + list(bufs))
    out = {}
    for n, g in grads.items():
        path, kernel = layout[n]
        g = g.astype(np.float64)
        out[path] = g.transpose(2, 3, 1, 0) if kernel else g
    return out


def _check_loss(got: float, want: float) -> None:
    assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want), \
        (got, want)


def _check_bn(got: dict, want: dict) -> None:
    keys = [k for k in want if k.rsplit(".", 1)[-1] in ("running_mean",
                                                        "running_var")]
    for k in keys:
        d = np.abs(got[k].astype(np.float64) - want[k]).max()
        assert d <= BN_RTOL * np.abs(want[k]).max(), (k, d)


_WHOLE = {}


def _whole_batch(name: str):
    """The single-process step on the whole batch (kept per case)."""
    if name not in _WHOLE:
        cfg, tc = R.dp_configs(name)
        if tc.accum_steps > 1:      # one whole-batch step is the reference
            tc = R.dp_configs(name.replace("_accum2", ""))[1]
        _WHOLE[name] = R.step_with_grads(cfg, tc,
                                         R.make_batch(7, R.DP_BATCH))
    return _WHOLE[name]


@pytest.mark.parametrize("name", list(R.DP_CASES))
def test_dp_train_step_matches_whole_batch_step(name, ranks):
    """``make_dp_train_step`` over 2 ranks (2 samples each, 48x64, 2
    iterations; SGD and AdamW; raft-things with its synchronized batch
    norm, raft-small; and accumulation over 2 micro-batches of each rank's
    rows, split stride-major) equals one single-process step on the whole
    batch: the loss, the averaged gradient, the running statistics; both
    ranks take the same update."""
    loss, grads, bufs, _ = _whole_batch(name)
    r0, r1 = ranks.get()[0][name], ranks.get()[1][name]
    _check_loss(r0[0], loss)
    assert r0[0] == r1[0] and r0[3] == r1[3], (r0[0], r1[0], r0[3], r1[3])
    small = R.DP_CASES[name][0]
    check_grads(_by_path(r0[1], bufs), _by_path(grads, bufs), small=small)
    _check_bn(r0[2], bufs)
    if not small:                     # the statistics did move
        start = R.biased_model(R.dp_configs(name)[0]).state_dict()
        moved = [k for k in bufs if k.endswith("running_var")]
        assert moved and all(np.abs(r0[2][k] - start[k].numpy()).max() > 0
                             for k in moved)


def test_dp_train_step_matches_jax_dp_step(ranks):
    """raft-small under AdamW: the port's 2-rank step against the JAX
    package's ``make_dp_train_step`` on 2 virtual devices, from the same
    weights and batch (its gradient read back from Adam's first moment)."""
    cfg, tc = R.dp_configs("small_adamw")
    jtc = JaxTrainConfig(**{f: getattr(tc, f) for f in (
        "num_steps", "lr", "batch_size", "image_size", "weight_decay",
        "optimizer", "schedule", "accum_steps")})
    tx = jax_optimizer(jtc)
    from raft_tpu.config import RAFTConfig as JaxConfig
    jcfg = JaxConfig.small_model(iters=2)
    params = to_jax_params(R.biased_model(cfg).state_dict())
    mesh = jax_make_mesh(shape=(2,), devices=jax.devices()[:2])
    step = jax_dp_step(jcfg, jtc, tx, mesh)
    batch = jax_shard_batch(mesh, JaxBatch(*map(jnp.asarray,
                                                R.make_batch(7, R.DP_BATCH))))
    args = (JaxState.create(params, tx), batch, jax.random.PRNGKey(0))
    compiled = step.lower(*args).compile(
        {"xla_llvm_disable_expensive_passes": True})
    jstate, jm = compiled(*args)
    gj = jax_first_grads(jstate, jm, tc.clip_norm)
    r0 = ranks.get()[0]["small_adamw"]
    _check_loss(r0[0], float(jm["loss"]))
    check_grads(_by_path(r0[1], r0[2]), gj, small=True)


def _fake_axis(size: int, index: int) -> spmd.Axis:
    """A data axis of ``size`` ranks as rank ``index`` sees it (a
    simulated topology, with no process group)."""
    ax = spmd.Axis(DATA_AXIS)
    ax.size, ax.index = size, index
    return ax


def test_shard_batch_partitions_and_rejects_indivisible():
    """Each rank's rows tile the batch; a batch that does not divide over
    the ranks raises (JAX's ``shard_map`` refuses it too)."""
    batch = R.make_batch(1, 6, 8, 8)
    for n in (1, 2, 3):
        rows = [shard_batch(Mesh({DATA_AXIS: _fake_axis(n, i)}, (n,), "cpu"),
                            batch) for i in range(n)]
        for k in range(4):
            np.testing.assert_array_equal(
                np.concatenate([r[k].numpy() for r in rows]), batch[k])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(Mesh({DATA_AXIS: _fake_axis(4, 0)}, (4,), "cpu"), batch)


def test_dp_eval_fn_matches_single_factory():
    """``make_dp_eval_fn`` over two CPU replicas (one device repeated, as
    a one-card machine runs it): the batch split, each half through the
    factory, gathered in order; an indivisible batch raises."""
    cfg = rt.RAFTConfig.small_model(iters=2)
    model = R.biased_model(cfg).eval()
    rng = np.random.RandomState(4)
    im1 = rng.rand(4, 32, 48, 3).astype(np.float32)
    im2 = rng.rand(4, 32, 48, 3).astype(np.float32)
    want = rt.make_inference_fn(cfg, device="cpu")(model, im1, im2).numpy()
    fn = make_dp_eval_fn(cfg, ["cpu", "cpu"])
    got = fn(model, im1, im2).numpy()
    bound = 1e-3 + 1e-3 * np.abs(want).max()
    assert got.shape == want.shape and np.abs(got - want).max() <= bound
    assert len(fn.factories) == 1 and fn.factories[0].graphs is None
    with pytest.raises(ValueError, match="not divisible"):
        fn(model, im1[:3], im2[:3])


def test_dp_eval_fn_converge_exits_per_replica():
    """Under ``converge:*`` each replica exits on its own part: its
    ``iters_used`` are the counted factory's on that part."""
    cfg = rt.RAFTConfig.small_model(iters=4, iters_policy="converge:5.0:1")
    model = R.biased_model(cfg).eval()
    rng = np.random.RandomState(6)
    im1 = rng.rand(2, 32, 48, 3).astype(np.float32)
    im2 = np.concatenate([im1[:1], rng.rand(1, 32, 48, 3).astype(np.float32)])
    fn = make_dp_eval_fn(cfg, ["cpu", "cpu"], with_iters=True)
    flow, used = fn(model, im1, im2)
    one = rt.make_counted_inference_fn(cfg, device="cpu")
    for i in range(2):
        f, u = one(model, im1[i:i + 1], im2[i:i + 1])
        assert int(used[i]) == int(u[0])
        assert np.abs(flow[i].numpy() - f[0].numpy()).max() <= \
            1e-3 + 1e-3 * np.abs(f.numpy()).max()


@pytest.mark.parametrize("max_batch,n", [(1, 2), (3, 2), (4, 2), (5, 3),
                                         (8, 4)])
def test_serve_config_dp_batch_steps_as_jax(max_batch, n):
    """``dp_devices=N`` rounds every batch step up to a multiple of N, as
    the JAX package's ServeConfig does."""
    kw = dict(max_batch=max_batch, dp_devices=n)
    got = ServeConfig(**kw).batch_steps
    assert got == JaxServeConfig(**kw).batch_steps
    assert all(s % n == 0 for s in got)


def test_serve_config_dp_refuses_ragged_as_jax():
    kw = dict(ragged=True, dp_devices=2)
    with pytest.raises(NotImplementedError) as want:
        JaxServeConfig(**kw)
    with pytest.raises(NotImplementedError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_engine_serves_data_parallel():
    """``InferenceEngine`` under ``dp_devices=2`` on the CPU (two replicas
    of the CPU model): warmup builds the rounded batch steps, a batch of 2
    answers as the single-device engine does, and a reload reaches every
    replica."""
    cfg = rt.RAFTConfig.small_model(iters=2)
    model = R.biased_model(cfg).eval()
    kw = dict(buckets=((32, 48),), max_batch=2, max_sessions=0,
              trace_sample=0.0, history_interval_s=0.0)
    dp = InferenceEngine(cfg, model, ServeConfig(dp_devices=2, **kw))
    one = InferenceEngine(cfg, R.biased_model(cfg).eval(), ServeConfig(**kw))
    assert dp.warmup(verbose=False) == 1           # batch steps (2,)
    rng = np.random.RandomState(8)
    im1 = rng.rand(2, 32, 48, 3).astype(np.float32)
    im2 = rng.rand(2, 32, 48, 3).astype(np.float32)
    got, want = dp.run((32, 48), im1, im2), one.run((32, 48), im1, im2)
    assert np.abs(got - want).max() <= 1e-3 + 1e-3 * np.abs(want).max()
    fresh = R.biased_model(cfg, seed=9).state_dict()
    dp.reload(fresh, probe=False)
    assert all(torch.equal(m.state_dict()["fnet.conv1.weight"],
                           fresh["fnet.conv1.weight"]) for m in dp._models())


def _jax_ragged_error() -> str:
    """JAX's NotImplementedError message for a ragged batch under its
    row-sharded forward (raised while tracing, before anything compiles)."""
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P
    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.models.raft import raft_forward as jax_forward
    from raft_tpu.ops import spmd as jspmd
    from raft_tpu.parallel.mesh import compat_shard_map
    jcfg = JaxConfig.small_model(iters=2)
    params = to_jax_params(R.biased_model(R.dp_configs("small_sgd")[0])
                           .state_dict())
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("spatial",))
    im = jnp.zeros((1, 128, 32, 3), jnp.float32)

    def fwd(p, a, b):
        with jspmd.spatial_sharding("spatial"):
            return jax_forward(p, a, b, jcfg, train=True,
                               sizes=jnp.asarray([[120, 30]]))[0].flow
    f = compat_shard_map(fwd, mesh=mesh,
                         in_specs=(P(), P(None, "spatial"),
                                   P(None, "spatial")),
                         out_specs=P(None, "spatial"))
    with pytest.raises(NotImplementedError) as e:
        jax.eval_shape(f, params, im, im)
    return str(e.value)


@pytest.mark.parametrize("case", ["ragged", "h_multiple"])
def test_row_sharded_training_raises_as_jax(case):
    """Row-sharded training runs (ROADMAP 11b, tests/test_torch_port_sp_
    train.py); what it refuses raises before any compute: a ragged batch
    under the context, with the JAX package's message, and an H that is
    not a multiple of ``required_h_multiple`` in the pjit step, in the JAX
    command line's words."""
    cfg, tc = R.dp_configs("small_sgd")
    model = R.biased_model(cfg)
    if case == "ragged":
        im = torch.zeros((1, 64, 32, 3))
        with spmd.spatial_sharding(spmd.Axis("spatial")):
            with pytest.raises(NotImplementedError) as e:
                rt.raft_forward(model, im, im, cfg, train=True,
                                sizes=torch.tensor([[60, 30]],
                                                   dtype=torch.int32))
        assert str(e.value) == _jax_ragged_error()
        return
    sp = _fake_axis(2, 0)
    sp.name = "spatial"
    mesh = Mesh({DATA_AXIS: spmd.Axis(DATA_AXIS), "spatial": sp}, (1, 2),
                "cpu")
    step = make_pjit_train_step(cfg, tc, make_optimizer(tc), mesh,
                                spatial_axis="spatial")
    batch = R.make_batch(1, 2, 48, 32)
    local = tuple(x[:, :24] for x in batch)
    state = rt.training.TrainState.create(model, make_optimizer(tc))
    with pytest.raises(ValueError) as e:
        step(state, local, 0)
    # the JAX command line's sentence (raft_tpu/cli.py, --spatial)
    assert ("requires H divisible by 128 (8 * N devices * "
            "2^(corr_levels-1)); got H=48") in str(e.value)
