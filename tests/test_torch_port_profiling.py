"""``raft_tpu_torch.utils.profiling`` against the JAX package's: the
parameter census (count and table, row for row, the empty and scalar
trees included), each kernel operator's FLOP formula against a hand count
at a small shape, and ``-m flops`` on the CPU."""

import re

import numpy as np
import pytest
import torch

import jax

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models import init_raft
from raft_tpu.utils import profiling as jprof

import raft_tpu_torch as rt
from raft_tpu_torch import cli
from raft_tpu_torch.ops import corr_cuda, gru_cuda
from raft_tpu_torch.utils import profiling as pprof

torch.set_num_threads(2)   # several test workers share the host's cores


@pytest.fixture(scope="module")
def models():
    """variant -> (JAX's parameter tree, abstract: shapes are what the
    census reads; the port's model of the variant)."""
    out = {}
    for small in (False, True):
        jcfg = JaxConfig.small_model() if small else JaxConfig.full()
        params = jax.eval_shape(lambda: init_raft(jax.random.PRNGKey(0), jcfg))
        model = rt.RAFT(rt.RAFTConfig.small_model() if small
                        else rt.RAFTConfig.full())
        out["small" if small else "things"] = (params, model)
    return out


@pytest.mark.parametrize("variant", ["things", "small"])
def test_census_matches_jax(variant, models):
    params, model = models[variant]
    assert pprof.count_params(model) == jprof.count_params(params)
    assert pprof.param_table(model) == jprof.param_table(params)
    assert pprof.param_table(model, prefix="m/") == \
        jprof.param_table(params, prefix="m/")


def test_census_of_degenerate_trees_matches_jax():
    for tree in ({}, None, [], {"a": np.float32(2.0), "b": 3.5,
                                "c": np.zeros(())},
                 {"layer": {"w": np.zeros((3, 4)), "b": np.zeros((4,))}},
                 {"z": [np.zeros(2), {"k": np.zeros((1, 2))}]}):
        assert pprof.param_table(tree) == jprof.param_table(tree)
        assert pprof.count_params(tree) == jprof.count_params(tree)


def _flops(fn, *args):
    return pprof.count_flops(fn, *args)


def test_kernel_flop_formulas_equal_hand_counts():
    g = torch.Generator().manual_seed(0)
    B, H, W, C, r = 2, 4, 6, 8, 1
    f1 = torch.randn(B, H, W, C, generator=g)
    levels = [torch.randn(B, H >> i, W >> i, C, generator=g) for i in range(2)]
    coords = torch.rand(B, H, W, 2, generator=g) * 4
    sizes8 = torch.tensor([[4, 6], [2, 3]], dtype=torch.int32)
    want = 2 * B * H * W * len(levels) * (2 * r + 1) ** 2 * C
    ops = torch.ops.raft_tpu_torch
    assert _flops(ops.corr_lookup, f1, levels, coords, r) == want
    assert _flops(ops.corr_window, f1, levels, coords, r) == want
    assert _flops(ops.corr_packed, f1, levels, coords, r, "all") == want
    assert _flops(ops.corr_ragged, f1, levels, coords, sizes8, r) == want
    hid, mot = 64, 16
    fw = {"wzr1": (5, hid + mot, 2 * hid), "wqh1": (5, hid, hid),
          "wqm1": (5, mot, hid)}
    fw.update({k[:-1] + "2": v for k, v in fw.items()})
    weights = [torch.randn(fw[k], generator=g) * 0.05 for k in gru_cuda._WEIGHTS]
    h = torch.randn(B, H, W, hid, generator=g)
    motion = torch.randn(B, H, W, mot, generator=g)
    c1, c2 = (torch.randn(B, H, W, 3 * hid, generator=g) for _ in range(2))
    got = _flops(ops.sep_conv_gru, h, motion, c1, c2, weights, [])
    assert got == 2 * B * H * W * 30 * hid * (hid + mot)
    # the model's wrappers reach the operators: the same counts
    assert _flops(corr_cuda.fused_lookup, f1, levels, coords, r) == want
    assert _flops(gru_cuda.sep_conv_gru, dict(zip(gru_cuda._WEIGHTS, weights)),
                  h, motion, (c1, c2)) == got


def test_mode_flops_prints_the_counts(models, capsys):
    assert cli.main(["-m", "flops", "--cpu", "--small", "--iters", "2",
                     "--corr-impl", "pallas", "--run-log", "none"]) == 0
    text = capsys.readouterr().out
    n = int(text.split("trainable parameters:")[1].split()[0].replace(",", ""))
    assert n == jprof.count_params(models["small"][0])
    flops = int(re.search(r"total flops: ([\d,]+)", text).group(1)
                .replace(",", ""))
    cfg = rt.RAFTConfig.small_model(iters=2, corr_impl="pallas")
    model = rt.init_raft_torch(cfg, device="cpu")
    im = torch.zeros(cli.FLOPS_SHAPE)
    assert flops == _flops(rt.raft_forward, model, im, im, cfg) > 0
    # the lookups' share is the formula's: 2 iterations at the 1/8 grid
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        rt.raft_forward(model, im, im, cfg)
    per_op = counter.get_flop_counts()["Global"]
    h, w = cli.FLOPS_SHAPE[1] // 8, cli.FLOPS_SHAPE[2] // 8
    assert per_op[torch.ops.raft_tpu_torch.corr_lookup] == \
        2 * corr_cuda.lookup_flops((1, h, w, 128), [None] * 4, 3)
