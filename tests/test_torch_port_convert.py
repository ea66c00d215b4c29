"""Every checkpoint format the port's ``--load`` reads, held against the
JAX package's ``raft_tpu.convert``: the official torch ``.pth`` (with and
without the ``{"model": ...}`` wrapper and the ``module.`` prefix,
``num_batches_tracked`` and the official norm aliases), an npz of torch
names, the reference's tensorpack npz (with and without ``:0``), the
native npz and a training checkpoint of either package.  Each file loads
into a ``RAFT`` ``state_dict`` bitwise equal to the port's
``from_jax_params`` of the JAX package's own load, for raft-things and
raft-small; ``detect_format`` agrees; the writers give JAX's names and
arrays.  The official models are ``tests/torch_raft_golden.py``'s,
seeded, so the aliases are real."""

import numpy as np
import pytest
import torch

import jax

from raft_tpu import convert as jconv
from raft_tpu.convert import weights as jweights
from raft_tpu.training import checkpoint as jckpt
from raft_tpu.training.state import TrainState as JaxTrainState

import raft_tpu_torch as rt
from raft_tpu_torch import convert as pconv
from raft_tpu_torch.training import checkpoint as pckpt
from raft_tpu_torch.training.optim import make_optimizer
from raft_tpu_torch.training.state import TrainState as PortTrainState
from raft_tpu_torch.config import TrainConfig

from torch_raft_golden import RAFT as OfficialRAFT

torch.set_num_threads(2)   # several test workers share the host's cores

VARIANTS = ("things", "small")


@pytest.fixture(scope="module")
def official():
    """variant -> the official model's state_dict (tensors), seeded, with
    BN running statistics off their init."""
    out = {}
    for variant in VARIANTS:
        torch.manual_seed(3)
        model = OfficialRAFT(small=variant == "small").eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.uniform_(-0.05, 0.05)
                    m.running_var.uniform_(0.9, 1.1)
        out[variant] = model.state_dict()
    return out


def _write(fmt: str, sd, path):
    """Write the official state_dict ``sd`` as checkpoint format ``fmt``."""
    tree = jconv.from_torch_state_dict(sd)
    if fmt == "pth":
        torch.save(sd, path)
    elif fmt == "pth_wrapped":
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    elif fmt == "torch_npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif fmt == "tensorpack":
        jconv.to_reference_npz(tree, path)
    elif fmt == "tensorpack_colon":
        flat = jconv.to_reference_npz(tree)
        np.savez(path, **{f"{k}:0": v for k, v in flat.items()})
    elif fmt == "native":
        jconv.save_params_npz(tree, path)
    elif fmt == "jax_trainstate":
        import optax
        state = JaxTrainState.create(tree, optax.adamw(1e-4))
        jckpt.save_checkpoint(path, state._replace(
            step=jax.numpy.asarray(7, jax.numpy.int32)))
    else:
        raise AssertionError(fmt)


FORMATS = {"pth": ".pth", "pth_wrapped": ".pt", "torch_npz": ".npz",
           "tensorpack": ".npz", "tensorpack_colon": ".npz",
           "native": ".npz", "jax_trainstate": ".npz"}
KIND = {"pth": "torch", "pth_wrapped": "torch", "torch_npz": "torch",
        # JAX's detect_format reads a ':0' leaf as no tensorpack name: such
        # a file loads through from_reference_npz, in both packages
        "tensorpack": "tensorpack", "tensorpack_colon": "native",
        "native": "native", "jax_trainstate": "trainstate"}


def _assert_state_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_each_format_loads_bitwise_as_jax(fmt, variant, official, tmp_path):
    path = tmp_path / f"ckpt{FORMATS[fmt]}"
    _write(fmt, official[variant], path)
    assert pconv.detect_format(path) == jweights.detect_format(path) == KIND[fmt]
    load_p, load_j = pconv.load_checkpoint_auto, jconv.load_checkpoint_auto
    if fmt == "tensorpack_colon":
        load_p, load_j = pconv.from_reference_npz, jconv.from_reference_npz
    got = pconv.from_jax_params(load_p(path))
    want = pconv.from_jax_params(load_j(path))
    _assert_state_equal(got, want)
    cfg = rt.RAFTConfig.small_model() if variant == "small" else rt.RAFTConfig()
    rt.RAFT(cfg).load_state_dict(got, strict=True)


def test_port_trainstate_loads_as_jax(official, tmp_path):
    """A training checkpoint written by the port's training code."""
    cfg = rt.RAFTConfig.small_model()
    model = rt.RAFT(cfg)
    model.load_state_dict(pconv.from_jax_params(
        jconv.from_torch_state_dict(official["small"])))
    tx = make_optimizer(TrainConfig.for_stage("synthetic"))
    state = PortTrainState.create(model, tx)
    path = tmp_path / "ckpt_3.npz"
    pckpt.save_checkpoint(path, state)
    assert pconv.detect_format(path) == jweights.detect_format(path) == "trainstate"
    got = pconv.from_jax_params(pconv.load_checkpoint_auto(path))
    _assert_state_equal(got, pconv.from_jax_params(
        jconv.load_checkpoint_auto(path)))
    _assert_state_equal(got, model.state_dict())


def test_positional_trainstate_and_unknown_names_raise(official, tmp_path):
    path = tmp_path / "old.npz"
    np.savez(path, leaf_0=np.zeros(2), leaf_1=np.ones(3))
    for mod in (pconv, jweights):
        with pytest.raises(ValueError, match="positional"):
            mod.detect_format(path)
    sd = dict(official["small"])
    sd["fnet.extra.thing"] = torch.zeros(2, 2)
    for mod in (pconv, jconv):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.from_torch_state_dict(sd)
    bad = {"fnet/conv1/Q": np.zeros(3)}
    for mod in (pconv, jconv):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.from_reference_npz(bad)
    assert pconv.from_torch_state_dict(sd, strict=False).keys() == \
        jconv.from_torch_state_dict(sd, strict=False).keys()


def test_aliased_norm_disagreement_raises(official):
    sd = dict(official["things"])
    name = next(k for k in sd if k.endswith("norm3.weight") and ".layer2." in k)
    sd[name] = sd[name] + 1.0
    for mod in (pconv, jconv):
        with pytest.raises(ValueError, match="alias"):
            mod.from_torch_state_dict(sd)


@pytest.mark.parametrize("variant", VARIANTS)
def test_writers_and_swap_match_jax(variant, official):
    tree_j = jconv.from_torch_state_dict(official[variant])
    tree_p = pconv.from_torch_state_dict(official[variant])
    ref_j, ref_p = jconv.to_reference_npz(tree_j), pconv.to_reference_npz(tree_p)
    assert list(ref_p) == list(ref_j)
    assert all(np.array_equal(ref_p[k], ref_j[k]) and
               ref_p[k].dtype == ref_j[k].dtype for k in ref_j)
    for layout in (True, False):
        sd_j = jconv.to_state_dict(tree_j, torch_layout=layout)
        sd_p = pconv.to_state_dict(tree_p, torch_layout=layout)
        assert list(sd_p) == list(sd_j)
        assert all(np.array_equal(sd_p[k], sd_j[k]) for k in sd_j)
    jconv.swap_rgb_bgr(tree_j)
    pconv.swap_rgb_bgr(tree_p)
    for enc in ("fnet", "cnet"):
        assert np.array_equal(tree_p[enc]["conv1"]["w"], tree_j[enc]["conv1"]["w"])
    swapped = pconv.from_torch_state_dict(official[variant],
                                          swap_input_channels=True)
    assert np.array_equal(swapped["fnet"]["conv1"]["w"],
                          tree_p["fnet"]["conv1"]["w"])
    pconv.assert_tree_shapes_match(tree_p, tree_j)
    del tree_p["cnet"]["conv1"]["w"]
    with pytest.raises(ValueError, match="keys differ"):
        pconv.assert_tree_shapes_match(tree_p, tree_j)
    tree_p["cnet"]["conv1"]["w"] = np.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        pconv.assert_tree_shapes_match(tree_p, tree_j)
