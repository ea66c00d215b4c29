"""The backward of the port's collectives (``raft_tpu_torch/ops/
spmd.py``) on the CPU, and its multi-rank dry run.

Each collective (psum, pmean, the tiled all_gather, ppermute along a ring
and along an open shift, and ``halo_exchange`` in its neighbour branch and
its wide all-gather branch) runs on 4 gloo ranks
(``tests/torch_parallel_ranks.py::grad_rank``), its vjp taken with a
seeded cotangent, against ``jax.vjp`` of the JAX package's counterpart
under ``shard_map`` over 4 virtual devices on the same inputs (the
outputs and the input's gradient at 1e-6), and with a one-rank axis (no
group: the identity and its identity transpose).  ``STATS`` counts the
backward's collectives apart from the forward's.  ``parallel/dryrun.py``
runs at n = 4 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from raft_tpu.ops import spmd as jspmd
from raft_tpu.parallel.mesh import compat_shard_map

from raft_tpu_torch.ops import spmd
from raft_tpu_torch.parallel.dryrun import dryrun_multichip
from raft_tpu_torch.parallel.launch import start_ranks

import torch_parallel_ranks as R

torch.set_num_threads(2)

AXIS = "spatial"
TOL = 1e-6


class _Ranks:
    def __init__(self, group):
        self.group, self.out = group, None

    def get(self):
        if self.out is None:
            self.out = self.group.results()
        return self.out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("grad_rdv") / "store"
    group = start_ranks(R.grad_rank, 4, init_method=f"file://{store}",
                        group_timeout_s=60, deadline_s=300, threads=1)
    yield _Ranks(group)
    group._stop()


def _jax_op(name: str, x):
    n = jax.lax.psum(1, AXIS)
    if name == "psum":
        return jax.lax.psum(x, AXIS)
    if name == "pmean":
        return jax.lax.pmean(x, AXIS)
    if name == "all_gather":
        return jax.lax.all_gather(x, AXIS, axis=1, tiled=True)
    if name == "ring":
        return jax.lax.ppermute(x, AXIS, [(i, (i + 1) % n)
                                          for i in range(n)])
    if name == "shift":
        return jax.lax.ppermute(x, AXIS, [(i, i + 1) for i in range(n - 1)])
    return jspmd.halo_exchange(x, int(name[4:]), AXIS)


def _jax_vjp(name: str):
    """JAX's (output, input gradient) of op ``name`` over 4 devices, the
    outputs of the ranks concatenated along H."""
    mesh = JaxMesh(np.array(jax.devices()[:4]), (AXIS,))
    f = compat_shard_map(lambda x: _jax_op(name, x), mesh=mesh,
                         in_specs=P(None, AXIS), out_specs=P(None, AXIS))
    y, vjp = jax.vjp(f, jnp.asarray(R.GRAD_X))
    (g,) = vjp(jnp.asarray(R.grad_cotangent(name, y.shape[1])))
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("name", R.GRAD_OPS)
def test_collective_backward_matches_jax_vjp(name, ranks):
    """Each collective's output and transpose on 4 ranks against
    ``jax.vjp`` of its JAX counterpart under ``shard_map`` (psum <-> psum,
    all_gather <-> reduce-scatter, ppermute <-> the inverse permutation,
    a halo exchange <-> the halo rows' cotangents added to the
    neighbours' edge rows, dropped at the image edges)."""
    want_y, want_g = _jax_vjp(name)
    out = ranks.get()
    got_y = np.concatenate([r[name][0] for r in out], axis=1)
    got_g = np.concatenate([r[name][1] for r in out], axis=1)
    np.testing.assert_allclose(got_y, want_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_g, want_g, rtol=TOL, atol=TOL)


def test_backward_collectives_counted_apart(ranks):
    """``STATS`` counts each backward's collectives apart from the
    forward's: one forward and one backward collective an op (the halo's
    two directions travel in one exchange; pmean is psum and a
    division)."""
    for r in ranks.get():
        st = r["stats"]
        assert st["calls"] == len(R.GRAD_OPS), st
        assert st["bwd_calls"] == len(R.GRAD_OPS), st
        assert st["staged_calls"] == st["bwd_staged_calls"] == 0, st


@pytest.mark.parametrize("name", R.GRAD_OPS)
def test_collective_on_a_one_rank_axis(name):
    """A JAX-style one-rank axis (no group): each collective is the
    identity forward and backward, as JAX's is over one device (the
    halo's rows the image's zero padding)."""
    ax = spmd.Axis(AXIS)
    x = torch.from_numpy(R.GRAD_X[:, :2]).requires_grad_()
    y = R.grad_op(name, x, ax)
    ct = torch.from_numpy(R.grad_cotangent(name, y.shape[1]))
    (g,) = torch.autograd.grad(y, x, ct)
    if name.startswith("halo"):
        h = int(name[4:])
        assert torch.equal(y[:, h:-h], x) and not y[:, :h].any() \
            and not y[:, -h:].any()
        assert torch.equal(g, ct[:, h:-h])
    elif name == "shift":
        assert not y.any() and not g.any()
    else:
        assert torch.equal(y, x) and torch.equal(g, ct)


def test_dryrun_multichip_four_ranks(capsys):
    """``parallel/dryrun.py`` at n = 4 on the CPU: the dp x sp step
    (2 x 2) one finite step at H rounded up to ``required_h_multiple``,
    the row-sharded inference over 4 ranks, and the kernel ring against
    the onehot ring at JAX's tolerance."""
    r = dryrun_multichip(4, deadline_s=300)
    said = capsys.readouterr().out
    assert (r["dp"], r["sp"]) == (2, 2) and np.isfinite(r["loss"])
    assert r["hw"] == (32, 48) and r["hw_run"] == (128, 48)
    assert "rounded up to 128" in said and "one train step" in said
    assert r["pallas_max_abs_diff"] <= 2e-3
