"""The NaN/Inf sentinel (``telemetry/watchdogs.py::nan_guard``) against
the JAX package's: one input pixel set to NaN at 48x64, 2 iterations, the
sentinel on in both packages, gives the same events (stage and
``bad_values``) in the same order, pairwise and ragged; off, or under
``suppress_nan_sentinel()``, nothing is recorded and the outputs are
bitwise the unguarded run's; the training forward reports its stages
once (remat's recompute adds nothing); ``--watchdogs`` writes
``nonfinite`` events into the run log (``-m val``: ``-m test`` would
render the NaN flow, which fails as in the JAX package)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models import raft as jraft
from raft_tpu.telemetry import watchdogs as jwd

import raft_tpu_torch as rt
from raft_tpu_torch import cli
from raft_tpu_torch import convert as pconv
from raft_tpu_torch.telemetry import events as pevents
from raft_tpu_torch.telemetry import watchdogs as pwd

torch.set_num_threads(2)   # several test workers share the host's cores


@contextlib.contextmanager
def _sentinel(mod):
    mod.enable_nan_sentinel(True)
    try:
        yield
    finally:
        events = list(mod.nan_events())
        mod.enable_nan_sentinel(False)
        mod.nan_events()[:] = events


def _images():
    im = np.random.RandomState(0).rand(2, 2, 48, 64, 3).astype(np.float32)
    im[0, 0, 5, 7, 1] = np.nan
    return im


CASES = {
    "small-pallas": dict(small=True, corr_impl="pallas"),
    "full-kernels": dict(small=False, corr_impl="pallas", gru_impl="pallas"),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    kw = dict(CASES[request.param])
    small = kw.pop("small")
    jcfg = (JaxConfig.small_model if small else JaxConfig.full)(iters=2, **kw)
    pcfg = (rt.RAFTConfig.small_model if small else rt.RAFTConfig.full)(
        iters=2, **kw)
    model = rt.init_raft_torch(pcfg, device="cpu")
    params = jax.tree.map(jnp.asarray, pconv.to_jax_params(model.state_dict()))
    return jcfg, params, pcfg, model.eval()


@pytest.mark.parametrize("ragged", [False, True], ids=["pairwise", "ragged"])
def test_events_equal_jax(pair, ragged):
    jcfg, params, pcfg, model = pair
    im = _images()
    sizes = np.array([[48, 64], [40, 56]], np.int32)
    jargs = [jnp.asarray(im[0]), jnp.asarray(im[1])]
    pargs = [im[0], im[1]]
    if ragged:
        jargs.append(jnp.asarray(sizes))
        pargs.append(sizes)
        jfn = jraft.make_ragged_inference_fn(jcfg)
        pfn = rt.make_ragged_inference_fn(pcfg, device="cpu")
    else:
        jfn = jraft.make_inference_fn(jcfg)
        pfn = rt.make_inference_fn(pcfg, device="cpu")
    with _sentinel(jwd):
        jax.block_until_ready(jax.jit(jfn)(params, *jargs))
    with _sentinel(pwd):
        pfn(model, *pargs)
    want, got = jwd.nan_events(), pwd.nan_events()
    assert got == want
    stages = [e["stage"] for e in got]
    assert stages == ["raft/fnet"] + ["raft/corr_lookup", "raft/update"] * 2


def test_off_or_suppressed_records_nothing_and_changes_nothing(pair):
    _, _, pcfg, model = pair
    im = _images()
    fn = rt.make_inference_fn(pcfg, device="cpu")
    pwd.nan_events().clear()
    off = fn(model, im[0], im[1])
    with _sentinel(pwd), pwd.suppress_nan_sentinel():
        suppressed = fn(model, im[0], im[1])
    assert pwd.nan_events() == []
    with _sentinel(pwd):
        on = fn(model, im[0], im[1])
    assert len(pwd.nan_events()) == 5
    for out in (suppressed, on):
        assert torch.equal(out.isnan(), off.isnan())
        assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(off))


def test_train_forward_reports_each_stage_once():
    cfg = rt.RAFTConfig.small_model(iters=2, corr_impl="pallas")
    model = rt.init_raft_torch(cfg, device="cpu")
    im = torch.from_numpy(_images())
    with _sentinel(pwd):
        out = rt.raft_forward(model, im[0], im[1], cfg, train=True)
        out.flow_iters.nan_to_num().sum().backward()
    assert cfg.remat_iters
    assert [e["stage"] for e in pwd.nan_events()] == \
        ["raft/fnet"] + ["raft/corr_lookup", "raft/update"] * 2


def test_watchdogs_flag_writes_nonfinite_events(tmp_path):
    cfg = rt.RAFTConfig.small_model(iters=2)
    model = rt.init_raft_torch(cfg, device="cpu")
    state = model.state_dict()
    state["fnet.conv1.weight"][0, 0, 0, 0] = float("nan")
    ckpt = tmp_path / "nan.npz"
    pconv.save_params_npz(state, ckpt)
    pwd.nan_events().clear()
    try:
        assert cli.main(["-m", "val", "--cpu", "--small", "--iters", "2",
                         "--dataset", "synthetic", "--train-size", "48", "64",
                         "--max-samples", "2", "--load", str(ckpt),
                         "--watchdogs", "--out", str(tmp_path)]) == 0
    finally:
        import os
        os.environ.pop("RAFT_TPU_WATCHDOGS", None)
        pwd.enable_nan_sentinel(False)
        pevents.set_current(None)
    logged = [e for e in pevents.read_events(tmp_path)
              if e["event"] == "nonfinite"]
    # two samples, each call reporting every stage
    assert [e["stage"] for e in logged] == 2 * (
        ["raft/fnet"] + ["raft/corr_lookup", "raft/update"] * 2)
    assert all(e["bad_values"] > 0 for e in logged)


def test_kernel_weight_split_keeps_a_nan():
    """The GRU kernel's weight layout (3xTF32 pieces, split as the kernels
    split their activations) keeps a NaN: rounding CUDA's own NaN
    (0x7fffffff) on the bits carries into the sign and gives -0, so the lo
    piece, x - hi, keeps its NaN.  Every other weight's pieces are
    unchanged, and finite weights split as before."""
    from raft_tpu_torch.ops import gru_cuda
    cuda_nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    g = torch.Generator().manual_seed(0)
    fw = {k: torch.randn(s, generator=g) for k, s in (
        ("wzr1", (5, 256, 256)), ("wqh1", (5, 128, 128)), ("wqm1", (5, 128, 128)),
        ("wzr2", (5, 256, 256)), ("wqh2", (5, 128, 128)), ("wqm2", (5, 128, 128)))}
    clean = gru_cuda.prepare_gru_weights(fw, torch.float32)
    fw["wqh1"][2, 7, 9] = cuda_nan
    sick = gru_cuda.prepare_gru_weights(fw, torch.float32)
    assert int(sick["wqh1"].isnan().sum()) == 1           # its lo piece
    same = ~(sick["wqh1"] != clean["wqh1"])
    assert int((~same).sum()) == 2                        # its hi and lo only
    w = torch.randn(4096, generator=g)
    hi, lo = gru_cuda._split_tf32(w)
    assert torch.equal(hi, gru_cuda._tf32(w))
    assert torch.equal(lo, gru_cuda._tf32(w - hi))
    for bad in (cuda_nan, torch.tensor(float("inf")), torch.tensor(float("nan"))):
        assert gru_cuda._split_tf32(bad.reshape(1))[1].isnan().all()
