"""The port's row-sharded pieces (``raft_tpu_torch/ops/spmd.py``,
``parallel/spatial.py`` and the ops that consult the context) over 2 and 4
gloo ranks on the CPU, against the JAX package's ``shard_map`` versions on
as many of the 8 virtual CPU devices tests/conftest.py makes, from the
same numpy inputs.

One group of 4 ranks (``tests/torch_parallel_ranks.py::spmd_rank``,
started once for the module, a ``file://`` rendezvous under a tmp
directory, a 60 s group timeout and a deadline on the group) runs every
case: the 2-rank ones on the spatial pairs {0, 1} and {2, 3} of a 2x2
mesh, the 4-rank ones on all four.  Each case is then its own test.

Tolerances: the small ops (halo exchange, the halo'd convs, instance norm,
the 3x3 neighbourhoods, ``upflow8``) and the ring lookups at ``1e-5``
relative to the reference's largest magnitude (``_close``: the two
packages' float32 convolutions and sums differ in order); the
whole-model flows at tests/test_torch_golden.py's ``1e-3 + 1e-3 *
max|flow|`` at 2 iterations, against JAX's ``make_shard_inference_fn`` and
against the port's own single-process forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.raft import raft_forward as jax_forward
from raft_tpu.ops import spmd as jspmd
from raft_tpu.ops.conv import conv2d as jax_conv2d
from raft_tpu.ops.coords import upflow8 as jax_upflow8
from raft_tpu.ops.corr import build_pyramid as jax_build_pyramid
from raft_tpu.ops.corr import lookup_dense as jax_lookup_dense
from raft_tpu.ops.norm import instance_norm as jax_instance_norm
from raft_tpu.ops.upsample import _shift_stack_3x3 as jax_shift_stack
from raft_tpu.parallel import (SPATIAL_AXIS, compat_shard_map,
                               conv2d_row_sharded as jax_conv_rows,
                               halo_exchange as jax_halo,
                               make_ring_corr_lookup as jax_ring,
                               make_shard_inference_fn as jax_shard_fn)
from raft_tpu.parallel.spatial import make_ring_lookup_local as jax_ring_local

import raft_tpu_torch as rt
from raft_tpu_torch.convert.weights import to_jax_params
from raft_tpu_torch.ops import spmd
from raft_tpu_torch.parallel.launch import start_ranks

import torch_parallel_ranks as R

torch.set_num_threads(2)

OP_RTOL = 1e-5
WORLD = 4


def _close(got, want, rtol=OP_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= rtol * scale, (err, rtol * scale)
    return err


def _flow_close(got, want):
    err = float(np.abs(got - want).max())
    bound = 1e-3 + 1e-3 * float(np.abs(want).max())
    assert got.shape == want.shape and err <= bound, (err, bound)


class _Ranks:
    """The module's group of ranks: started at once, its results read
    (and kept) by the first test that needs them, so the tests before it
    compile their JAX references while the ranks run."""

    def __init__(self, group):
        self.group, self.out = group, None

    def get(self):
        if self.out is None:
            self.out = self.group.results()
        return self.out

    def cat(self, case, n):
        """The case's output over ranks 0..n-1, slabs joined on H."""
        return np.concatenate([self.get()[r][case] for r in range(n)], axis=1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("spmd_rdv") / "store"
    group = start_ranks(R.spmd_rank, WORLD, args=(list(R.MODEL_CASES),),
                        init_method=f"file://{store}", group_timeout_s=60,
                        deadline_s=400, threads=R.THREADS)
    yield _Ranks(group)
    group._stop()


def _jax_rows(fn, n, *arrays, ctx=True):
    """``fn`` under ``shard_map`` on ``n`` devices, every argument and the
    output row-sharded (H, dim 1); under the spatial context when ``ctx``."""
    mesh = JaxMesh(np.array(jax.devices()[:n]), (SPATIAL_AXIS,))

    def inner(*xs):
        if ctx:
            with jspmd.spatial_sharding(SPATIAL_AXIS):
                return fn(*xs)
        return fn(*xs)
    f = jax.jit(compat_shard_map(
        inner, mesh=mesh, in_specs=tuple(P(None, SPATIAL_AXIS) for _ in arrays),
        out_specs=P(None, SPATIAL_AXIS)))
    return np.asarray(f(*map(jnp.asarray, arrays)))


# -- whole-model row-sharded inference (first: JAX compiles while the ranks
# run) ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.MODEL_CASES))
def test_shard_inference_matches_jax_and_single_process(name, ranks):
    """``make_shard_inference_fn`` over 4 ranks: raft-things and
    raft-small at 1x256x48 with ``gru_ctx_hoist`` on and off, and
    ``corr_levels=2`` at 1x64x32 (slabs of 2 rows at 1/8, so the motion
    encoder's 7x7 flow conv takes the halo-wider-than-slab branch), held to
    JAX's ``make_shard_inference_fn`` on 4 devices and to the port's
    single-process forward, from the same biased weights."""
    cfg = R.model_config(name)
    model = R.biased_model(cfg).eval()
    im1, im2 = R.model_images(name)
    small, kw, _, _ = R.MODEL_CASES[name]
    jcfg = (JaxConfig.small_model if small else JaxConfig.full)(
        iters=R.MODEL_ITERS, **kw)
    params = to_jax_params(model.state_dict())
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]), (SPATIAL_AXIS,))
    want_jax = np.asarray(jax_shard_fn(jcfg, mesh, iters=R.MODEL_ITERS)(
        params, jnp.asarray(im1), jnp.asarray(im2)))
    want_port = rt.raft_forward(model, torch.from_numpy(im1),
                                torch.from_numpy(im2), cfg,
                                iters=R.MODEL_ITERS).flow.numpy()
    got = ranks.cat(f"model_{name}", WORLD)
    _flow_close(got, want_jax)
    _flow_close(got, want_port)


# -- the row-sharded ops ------------------------------------------------------

@pytest.mark.parametrize("n,halo", [(2, 2), (2, 9), (4, 2), (4, 5)])
def test_halo_exchange(n, halo, ranks):
    """Neighbour rows, zeros at the image edges; a halo wider than the slab
    (9 > 8, 5 > 4) takes the all-gather-then-slice branch."""
    x = R.OP_INPUTS["halo"]
    want = _jax_rows(lambda xl: jax_halo(xl, halo), n, x, ctx=False)
    _close(ranks.cat(f"halo{n}_{halo}", n), want)


@pytest.mark.parametrize("n", [2, 4])
def test_conv2d_row_sharded(n, ranks):
    """tests/test_parallel.py's inputs: a 5x5 conv of row slabs."""
    w = jnp.asarray(R.OP_INPUTS["conv_w"])
    want = _jax_rows(lambda xl: jax_conv_rows(xl, w), n,
                     R.OP_INPUTS["conv_x"], ctx=False)
    _close(ranks.cat(f"conv{n}", n), want)
    whole = np.asarray(jax_conv2d(jnp.asarray(R.OP_INPUTS["conv_x"]), w))
    _close(ranks.cat(f"conv{n}", n), whole)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,stride", R.CONV_CTX)
def test_conv_nchw_under_context(n, k, stride, ranks):
    """The model's convolution (``ops/conv.py::conv_nchw``, biased) under
    the spatial context, 1x1 to 7x7, strides 1 and 2: the JAX package's
    ``conv2d`` under its context."""
    w, b = R.conv_ctx_weights(k)
    want = _jax_rows(lambda xl: jax_conv2d(xl, jnp.asarray(w), jnp.asarray(b),
                                           stride=stride),
                     n, R.OP_INPUTS["conv_x"])
    _close(ranks.cat(f"convctx{n}_{k}_{stride}", n), want)


@pytest.mark.parametrize("n", [2, 4])
def test_instance_norm_under_context(n, ranks):
    """Statistics over the whole image: pmean of the mean and of E[x^2],
    ``var = max(E[x^2] - mean^2, 0)``, the JAX formula."""
    want = _jax_rows(jax_instance_norm, n, R.OP_INPUTS["inorm"])
    _close(ranks.cat(f"inorm{n}", n), want)


@pytest.mark.parametrize("n", [2, 4])
def test_shift_stack_3x3_under_context(n, ranks):
    """The convex upsampling's 3x3 neighbourhoods: a one-row halo."""
    want = _jax_rows(jax_shift_stack, n, R.OP_INPUTS["shift"])
    _close(ranks.cat(f"shift{n}", n), want)


@pytest.mark.parametrize("n", [2, 4])
def test_upflow8_under_context(n, ranks):
    """raft-small's upsampling: shard-offset align-corners rows (JAX's
    ``_interp_rows_sharded``), slabs of 4 and 2 rows."""
    want = _jax_rows(jax_upflow8, n, R.OP_INPUTS["upflow"])
    _close(ranks.cat(f"upflow{n}", n), want)
    whole = np.asarray(jax_upflow8(jnp.asarray(R.OP_INPUTS["upflow"])))
    _close(ranks.cat(f"upflow{n}", n), whole)


# -- the ring lookup ----------------------------------------------------------

def _dense(which):
    f1, f2, c, levels, radius = R.ring_inputs(which)
    return np.asarray(jax_lookup_dense(
        jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels,
                          precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(c), radius))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_corr_lookup_onehot(n, ranks):
    """``make_ring_corr_lookup(kernel='onehot')`` on the inputs of JAX's
    ``test_ring_corr_lookup_matches_dense``: JAX's ring on as many devices,
    and the dense lookup."""
    f1, f2, c, levels, radius = R.ring_inputs("onehot")
    mesh = JaxMesh(np.array(jax.devices()[:n]), (SPATIAL_AXIS,))
    want = np.asarray(jax_ring(mesh, levels, radius,
                               precision=jax.lax.Precision.HIGHEST)(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(c)))
    got = ranks.cat(f"ring_onehot{n}", n)
    _close(got, want)
    _close(got, _dense("onehot"))


@pytest.fixture(scope="module")
def jax_fused_ring():
    """JAX's ring riding the fused Pallas kernel (interpret mode on the
    CPU, window schedule and row packing, as its
    ``test_ring_lookup_via_fused_kernel_matches_dense`` runs it) on 4
    devices."""
    f1, f2, c, levels, radius = R.ring_inputs("fused")
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]), (SPATIAL_AXIS,))

    def inner(f1l, f2l, cl):
        return jax_ring_local(
            f1l, f2l, levels, radius, SPATIAL_AXIS,
            precision=jax.lax.Precision.HIGHEST, kernel="pallas",
            pallas_opts=dict(q_blk=64, p_blk_target=1024,
                             p_select="window", pack_rows=True))(cl)
    f = jax.jit(compat_shard_map(
        inner, mesh=mesh, in_specs=(P(None, SPATIAL_AXIS),) * 3,
        out_specs=P(None, SPATIAL_AXIS)))
    return np.asarray(f(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(c)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["all", "window", "pack"])
def test_ring_lookup_through_kernel_twins(n, variant, ranks, jax_fused_ring):
    """``kernel='pallas'``: one lookup wrapper's call per slab on the
    shifted coordinates; on CPU tensors the wrappers run the kernels'
    plain twins (``p_select`` 'all': B1's, 'window': B3's, ``pack_rows``:
    B5's).  Held to the dense lookup and to JAX's fused-kernel ring on the
    inputs of its ``test_ring_lookup_via_fused_kernel_matches_dense``."""
    got = ranks.cat(f"ring_{variant}{n}", n)
    _close(got, _dense("fused"))
    _close(got, jax_fused_ring)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_corr_lookup(n, ranks):
    """``make_spatial_corr_lookup`` (fmap2's slabs gathered, then the dense
    lookup) on the inputs of JAX's ``test_spatial_corr_lookup_matches_dense``:
    JAX's on as many devices, and the dense lookup."""
    from raft_tpu.parallel import make_spatial_corr_lookup as jax_spatial
    f1, f2, c, levels, radius = R.ring_inputs("spatial")
    mesh = JaxMesh(np.array(jax.devices()[:n]), (SPATIAL_AXIS,))
    want = np.asarray(jax_spatial(mesh, levels, radius)(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(c)))
    got = ranks.cat(f"spatial_lookup{n}", n)
    _close(got, want)
    _close(got, _dense("spatial"))


def test_spatial_inference_fn_gathers_the_shard_flow(ranks):
    """``make_spatial_inference_fn``: whole images in, this rank's rows
    through the same row-sharded forward, the whole flow gathered on every
    rank, bit for bit the slabs of ``make_shard_inference_fn``."""
    want = ranks.cat("model_small_hoist", WORLD)
    for r in range(WORLD):
        np.testing.assert_array_equal(
            ranks.get()[r]["spatial_fn_small_hoist"], want)


def test_ring_counts_its_collectives(ranks):
    """Every rank issued collectives over its groups, and none was staged
    (CPU tensors: gloo takes them as they are)."""
    for r in ranks.get():
        st = r["stats"]
        assert st["calls"] > 0 and st["staged_calls"] == 0, st


# -- what row sharding does not run -------------------------------------------

def _jax_error(jcfg, sizes=None):
    """JAX's NotImplementedError message for ``jcfg`` under its row-sharded
    forward (raised while tracing, before anything compiles)."""
    params = to_jax_params(rt.init_raft_torch(
        rt.RAFTConfig.full(), device="cpu").state_dict())
    mesh = JaxMesh(np.array(jax.devices()[:2]), (SPATIAL_AXIS,))
    im = jnp.zeros((1, 128, 32, 3), jnp.float32)

    def fwd(p, a, b):
        with jspmd.spatial_sharding(SPATIAL_AXIS):
            kw = {} if sizes is None else {"sizes": jnp.asarray(sizes)}
            return jax_forward(p, a, b, jcfg, **kw)[0].flow
    f = compat_shard_map(fwd, mesh=mesh,
                         in_specs=(P(), P(None, SPATIAL_AXIS),
                                   P(None, SPATIAL_AXIS)),
                         out_specs=P(None, SPATIAL_AXIS))
    with pytest.raises(NotImplementedError) as e:
        jax.eval_shape(f, params, im, im)
    return str(e.value)


@pytest.mark.parametrize("case", ["converge", "gru_pallas", "ragged"])
def test_unsupported_under_row_sharding_raise_as_jax(case):
    """``iters_policy='converge:*'``, ``gru_impl='pallas'`` and ragged
    batches raise NotImplementedError with the JAX package's message under
    the context, before any compute."""
    kw = {"converge": dict(iters_policy="converge:0.1"),
          "gru_pallas": dict(gru_impl="pallas"), "ragged": {}}[case]
    sizes = [[120, 30]] if case == "ragged" else None
    want = _jax_error(JaxConfig.full(iters=2, **kw), sizes)
    cfg = rt.RAFTConfig.full(iters=2, **kw)
    model = rt.init_raft_torch(cfg, device="cpu")
    im = torch.zeros((1, 64, 32, 3))
    with spmd.spatial_sharding(spmd.Axis(SPATIAL_AXIS)):
        with pytest.raises(NotImplementedError) as e:
            rt.raft_forward(model, im, im, cfg, sizes=None if sizes is None
                            else torch.tensor(sizes, dtype=torch.int32))
    assert str(e.value) == want
