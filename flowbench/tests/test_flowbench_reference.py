"""The plain reference against the port's plain path on the CPU, at a
tiny size: the forward of both variants and one train step.  The test
may import both; the reference imports nothing of the port (checked in a
process of its own).  The tolerances are set from float32: the two
compute the same functions in another order."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowbench import frames
from flowbench.reference import raft as ref
from flowbench.reference import train as ref_train
from flowbench.weights import make_weights

from .conftest import ROOT

MOTION = {"translation_px": 3.0, "field_px": 4.0, "noise": 0.01}


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "flowbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _port_model(cfg, sd):
    from raft_tpu_torch import RAFT, RAFTConfig
    model = RAFT(RAFTConfig(**cfg["model"])).eval()
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("name", ["raft-things-f32", "raft-small-f32"])
@pytest.mark.parametrize("iters", [1, 12])
def test_forward_matches_port(name, iters):
    from raft_tpu_torch import RAFTConfig, raft_forward
    cfg = _config(name)
    sd = make_weights(cfg, 2 ** 33 + 3, "cpu")
    im1, im2, _, _ = frames.make_pairs(2, 64, 96, 5, "cpu", MOTION)
    want = ref.forward(sd, cfg["model"], im1, im2, iters)
    got = raft_forward(_port_model(cfg, sd), im1, im2,
                       RAFTConfig(**cfg["model"]), iters=iters).flow
    scale = float(want.abs().max())
    assert scale > 0.5                  # the flows are not trivially zero
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_train_step_matches_port():
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.training.optim import make_optimizer
    from raft_tpu_torch.training.state import TrainState
    from raft_tpu_torch.training.step import make_train_step
    cfg = _config("raft-things-f32")
    mc = dict(cfg["model"], iters=3)
    sd = make_weights(cfg, 9, "cpu")
    batch = frames.make_pairs(2, 64, 96, 6, "cpu", MOTION)
    tc = TrainConfig.for_stage("chairs", batch_size=2, image_size=(64, 96))
    model = _port_model(cfg, sd)
    tx = make_optimizer(tc)
    state = TrainState.create(model, tx)
    state, m = make_train_step(RAFTConfig(**mc), tc, tx)(state, batch)
    tcd = {k: getattr(tc, k) for k in ("gamma", "max_flow", "clip_norm", "lr",
                                       "num_steps", "pct_start",
                                       "weight_decay", "adamw_eps")}
    losses, grad, change = ref_train.train_steps(sd, mc, tcd, [batch])
    assert abs(float(m["loss"]) - losses[0]) <= 1e-5 * abs(losses[0])
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(grad)
    norms = np.array([float(grad[n].norm()) for n in names])
    floor = np.median(norms)
    for n, mu, p in zip(names, state.opt_state.mu, model.parameters()):
        g = float(mu.norm()) / (1 - ref_train.B1)
        assert abs(g - float(grad[n].norm())) <= 1e-3 * max(
            float(grad[n].norm()), floor), n
        if float(grad[n].norm()) >= 1e-3 * floor:
            moved = float((p.detach() - sd[n]).norm())
            assert abs(moved - float(change[n].norm())) <= 1e-2 * max(
                float(change[n].norm()), 1e-12), n


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import flowbench.reference.raft, "
            "flowbench.reference.train, flowbench.counts, flowbench.frames, "
            "flowbench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'raft_tpu_torch', 'raft_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["things-serve-closed8", "small-serve-closed8",
                                  "things-train-chairs"])
def test_control_fails_on_the_card(card, cell):
    """The control (the reference in TF32) put in the program's place
    comes out not correct through the harness's own check, on three
    seeds at the cell's own size."""
    from flowbench import harness
    c = harness.load_cell(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        line = harness.run_cell(harness.Run(cell=c, seed=seed, seconds=2.0,
                                            trace=False, fault="control"))
        assert line["correct"] is False, line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["things-serve-closed8", "small-serve-closed8"])
def test_one_row_fault_fails_on_the_card(card, cell):
    """Half a pixel altered in the last row of each device call alone
    (a quarter of the requests at batch 4) comes out not correct at the
    cell's own size."""
    from flowbench import harness
    line = harness.run_cell(harness.Run(cell=harness.load_cell(cell),
                                        seed=2 ** 31 + 104, seconds=2.0,
                                        trace=False, fault="row"))
    assert line["correct"] is False, line["checks"]
