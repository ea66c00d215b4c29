"""The yardstick's arithmetic: the analytic model FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the reference's forward
(the convolutions and matrix products it counts), and the roofline
pieces on cases that can be counted by hand."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flowbench import counts
from flowbench.reference import raft as ref
from flowbench.weights import make_weights

from .conftest import ROOT


@pytest.mark.parametrize("name", ["raft-things-f32", "raft-small-f32"])
@pytest.mark.parametrize("hw", [(64, 96), (40, 56)])
def test_model_flops_equal_the_counter(name, hw):
    with open(os.path.join(ROOT, "flowbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    sd = make_weights(cfg, 1, "cpu")
    im = torch.rand(1, *hw, 3)
    with FlopCounterMode(display=False) as fc:
        ref.forward(sd, cfg["model"], im, im, 3)
    assert fc.get_total_flops() == counts.model_flops(cfg["model"], *hw, 3)


def test_peaks_and_bounds():
    assert counts.PEAK_F32 == pytest.approx(165e12)
    # bytes-bound: 3.35e12 bytes take a second
    assert counts.bound_s(3.35e12, {"fp32": 1.0}) == pytest.approx(1.0)
    assert counts.bound_s(0, {"f32xf32": 495e12 / 3}) == pytest.approx(1.0)


def test_corr_positions_by_hand():
    # every window wholly inside the 16 x 16 level: (2r+2)^2 positions each
    coords = torch.full((5, 2), 8.0)
    assert counts.corr_positions(coords, [(16, 16)], 2) == 5 * 36
    # a window from -2 to 3 at the corner keeps 4 x 4 positions
    corner = torch.zeros((1, 2))
    assert counts.corr_positions(corner, [(16, 16)], 2) == 4 * 4
    # a window wholly outside reads nothing
    assert counts.corr_positions(torch.full((1, 2), -100.0), [(16, 16)], 2) == 0


def test_gru_ops_per_tap():
    # one row and one column: one in-image tap each pass
    ops = counts.gru_ops(1, 1, 1, 64, 16)
    macs = 64 * 128 + 16 * 128 + 64 * 64 + 16 * 64
    assert ops["f32xf32"] == 2 * 2 * macs
    # at width >= 5 the interior taps are all five
    ops = counts.gru_ops(1, 1, 9, 64, 16)
    assert ops["f32xf32"] == 2 * (3 + 4 + 5 * 5 + 4 + 3 + 9) * macs
