"""A run with its timed path broken comes out not correct: each fault a
cell can have, planted in the CPU rehearsal (the answers altered where
they are produced, in every row of a batch or in its last row alone; a
train step that leaves its state unchanged; one that takes half of each
batch), and the control (the plain reference in TF32) put in the
program's place.  The exchange between chips does not exist in these
one-chip cells."""

from __future__ import annotations

import pytest

from .test_flowbench_line import rehearse


@pytest.mark.parametrize("cell,fault", [
    ("things-serve-closed8", "answer"),
    ("small-serve-closed8", "answer"),
    ("things-serve-closed8", "row"),
    ("small-serve-closed8", "row"),
    ("things-train-chairs", "unchanged"),
    ("things-train-chairs", "half_batch"),
])
def test_fault_is_not_correct(cell, fault):
    line, err = rehearse(cell, 0, fault)
    assert line["correct"] is False, line["checks"]
    assert "FAILED" in err
