"""``python -m raft_tpu_torch.cli -m export`` on the CPU: the native
params npz, the reference's tensorpack npz and ``<variant>.pt2``, a
``torch.export`` program of the eval forward.  The program, saved and
loaded back, equals the eager forward bitwise; its graph names the kernel
operators of the configuration; both npz files reload to the exported
weights bitwise, in this package and in the JAX package."""

import contextlib

import numpy as np
import pytest
import torch

from raft_tpu import convert as jconv

import raft_tpu_torch as rt
from raft_tpu_torch import cli
from raft_tpu_torch import convert as pconv

torch.set_num_threads(2)   # several test workers share the host's cores


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: each reduction in one order on both sides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _graph_ops(program) -> set:
    ops = set()
    for mod in program.graph_module.modules():
        if hasattr(mod, "graph"):
            ops |= {str(n.target) for n in mod.graph.nodes
                    if n.op == "call_function"}
    return ops


CASES = {
    "small-dense": (["--small"], set()),
    "small-pallas": (["--small", "--corr-impl", "pallas"],
                     {"raft_tpu_torch.corr_lookup.default"}),
    "full-kernels": (["--corr-impl", "pallas", "--gru-impl", "pallas"],
                     {"raft_tpu_torch.corr_lookup.default",
                      "raft_tpu_torch.sep_conv_gru.default"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_export_writes_a_program_equal_to_eager(case, tmp_path, capsys):
    flags, kernel_ops = CASES[case]
    assert cli.main(["-m", "export", "--cpu", "--iters", "2", "--size", "48",
                     "64", "--export-reference-npz", "--out", str(tmp_path),
                     *flags]) == 0
    variant = "raft-small" if "--small" in flags else "raft-things"
    assert f"{variant}.pt2" in capsys.readouterr().out
    args = cli.build_parser().parse_args(["--cpu", "--iters", "2", *flags])
    config = cli.make_config(args)

    native = pconv.load_params_npz(tmp_path / f"{variant}.npz")
    model = rt.RAFT(config)
    model.load_state_dict(pconv.from_jax_params(native), strict=True)
    model.eval()
    reference = tmp_path / f"{variant}.reference.npz"
    for tree in (pconv.from_reference_npz(reference),
                 jconv.from_reference_npz(reference),
                 pconv.load_checkpoint_auto(reference)):
        state = pconv.from_jax_params(tree)
        for k, v in model.state_dict().items():
            assert torch.equal(state[k], v), k

    program = torch.export.load(str(tmp_path / f"{variant}.pt2"))
    ops = _graph_ops(program)
    assert {o for o in ops if o.startswith("raft_tpu_torch.")} == kernel_ops
    im = torch.from_numpy(np.random.RandomState(4).rand(
        2, 1, 48, 64, 3).astype(np.float32))
    with _one_thread():
        got = program.module()(im[0], im[1])
        want = rt.raft_forward(model, im[0], im[1], config).flow
    assert got.shape == want.shape == (1, 48, 64, 2)
    assert torch.equal(got, want), (got - want).abs().max()
