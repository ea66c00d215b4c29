"""The port's ``@contract`` (``raft_tpu_torch/lint/contracts.py``) against the
JAX package's: the same grammar, the same checks and errors on a shared
list of specs; every JAX ``@contract`` site has a decorated counterpart in
the port; the CPU slice runs with checking on; a shape or dtype made wrong
on purpose raises ``ContractError``; checking never reads a value."""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.lint import contracts as jc
from raft_tpu_torch.lint import contracts as tc

torch.set_num_threads(2)   # several test workers share the host's cores

REPO = Path(__file__).resolve().parent.parent

SPECS = ["f32[B,H,W,2]", "*[B,...,2]", "bf16|f32[B,Q,N]", "[3]", "i32[B, 2]",
         "f32[_,_]", "bool[...]", "u8[1,2,3]", "f64[A,...,B]",
         # errors
         "f32", "f33[B]", "f32[B,...,...]", "f32[b]", "f32[B-1]", "",
         "x[1]", "*[B,H,", "f16|[B]"]


def _outcome(mod, fn, *args):
    try:
        return ("ok", fn(*args))
    except mod.ContractError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    def parsed(mod):
        return lambda s: (lambda p: (p.dtypes, p.dims, p.raw))(
            mod.parse_spec(s))
    assert _outcome(jc, parsed(jc), spec) == _outcome(tc, parsed(tc), spec)


# (specs, arguments): shapes as numpy arrays; every case runs through a
# function decorated by each package's contract, checking on
CASES = [
    ({"a": "f32[B,H]", "b": "f32[B,W]"}, dict(a=((2, 3), "float32"),
                                               b=((2, 5), "float32"))),
    ({"a": "f32[B,H]", "b": "f32[B,W]"}, dict(a=((2, 3), "float32"),
                                               b=((4, 5), "float32"))),
    ({"a": "i32[B,2]"}, dict(a=((3, 2), "float32"))),
    ({"a": "*[B,...,2]"}, dict(a=((3, 7, 9, 2), "float16"))),
    ({"a": "*[B,...,2]"}, dict(a=((3, 7, 9, 3), "float16"))),
    ({"a": "f32[B,H,W,2]"}, dict(a=((1, 2, 2), "float32"))),
    ({"a": "*[A,B,...,C,D]"}, dict(a=((1, 2), "float32"))),
    ({"a": "bf16|f32[_,4]"}, dict(a=((9, 4), "float64"))),
    ({"a": "[1,2]", "_returns": "f32[2]"}, dict(a=((1, 2), "int8"))),
    ({"a": "f32[B]"}, dict(a=None)),
    ({"a": "f32[B]"}, dict(a=3.0)),
]


def _decorated(mod, specs):
    @mod.contract(**specs)
    def fn(a, b=None):
        return np.zeros((2,), np.float32)
    return fn


@pytest.mark.parametrize("case", range(len(CASES)))
def test_checks_match_jax(case):
    specs, args = CASES[case]
    kwargs = {k: (np.zeros(v[0], v[1]) if isinstance(v, tuple) else v)
              for k, v in args.items()}
    outcomes = []
    for mod in (jc, tc):
        was = mod.checking_enabled()
        mod.enable_checking(True)
        try:
            outcomes.append(_outcome(mod, lambda: str(
                _decorated(mod, specs)(**kwargs).shape)))
        finally:
            mod.enable_checking(was)
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool,
                                   torch.float16, torch.uint8])
def test_torch_dtype_reads_as_numpy_name(dtype):
    """A torch tensor and a numpy array of one dtype name check alike (and
    fail alike, with the same message)."""
    npd = {torch.float32: "float32", torch.int32: "int32",
           torch.bool: "bool", torch.float16: "float16",
           torch.uint8: "uint8"}[dtype]
    tc.enable_checking(True)
    try:
        for spec in ("f32[B,2]", "i32|bool[B,2]"):
            fn = _decorated(tc, {"a": spec})
            got = [_outcome(tc, fn, x) for x in
                   (torch.zeros(3, 2, dtype=dtype), np.zeros((3, 2), npd))]
            assert got[0][0] == got[1][0] and str(got[0][1]) == str(
                got[1][1])
    finally:
        tc.enable_checking(False)


# every @contract site of the JAX package -> its counterpart
# in the port: (JAX module, function) -> (port module, qualname)
SITES = {
    ("raft_tpu/ops/corr.py", "dense_corr"): ("ops.corr", "dense_corr"),
    ("raft_tpu/ops/corr.py", "lookup_dense"): ("ops.corr", "lookup_dense"),
    ("raft_tpu/ops/corr.py", "lookup_partial_onehot"):
        ("ops.corr", "lookup_partial_onehot"),
    ("raft_tpu/ops/corr.py", "lookup_dense_onehot"):
        ("ops.corr", "lookup_dense_onehot"),
    ("raft_tpu/ops/corr.py", "lookup_ondemand"):
        ("ops.corr", "lookup_ondemand"),
    ("raft_tpu/ops/corr.py", "lookup_blockwise_onehot"):
        ("ops.corr", "lookup_blockwise_onehot"),
    ("raft_tpu/ops/corr_pallas.py", "_fused_lookup_impl"):
        ("ops.corr_cuda", "fused_lookup"),
    ("raft_tpu/ops/corr_pallas.py", "make_fused_lookup"):
        ("ops.corr_cuda", "make_fused_lookup"),
    ("raft_tpu/ops/corr_pallas.py", "_ragged_fused_lookup_impl"):
        ("ops.corr_cuda", "ragged_lookup"),
    ("raft_tpu/ops/corr_pallas.py", "make_ragged_fused_lookup"):
        ("ops.corr_cuda", "make_ragged_fused_lookup"),
    ("raft_tpu/ops/gru_pallas.py", "sep_conv_gru_xla"):
        ("ops.gru_cuda", "sep_conv_gru_plain"),
    ("raft_tpu/ops/gru_pallas.py", "sep_conv_gru_pallas"):
        ("ops.gru_cuda", "sep_conv_gru"),
    ("raft_tpu/ops/grid_sample.py", "grid_sample"):
        ("ops.grid_sample", "grid_sample"),
    ("raft_tpu/ops/grid_sample.py", "grid_sample_normalized"):
        ("ops.grid_sample", "grid_sample_normalized"),
    ("raft_tpu/models/raft.py", "raft_forward"):
        ("models.raft", "raft_forward"),
    ("raft_tpu/models/raft.py", "encode_frame"):
        ("models.raft", "encode_frame"),
    ("raft_tpu/models/raft.py", "forward_from_features"):
        ("models.raft", "forward_from_features"),
    ("raft_tpu/training/step.py", "train_step"):
        ("training.step", "make_train_step.compute"),
    ("raft_tpu/training/step.py", "counted_step"):
        ("training.step", "make_eval_step.eval_step"),
    ("raft_tpu/training/step.py", "eval_step"):
        ("training.step", "make_eval_step.eval_step"),
    ("raft_tpu/training/loss.py", "sequence_loss"):
        ("training.loss", "sequence_loss"),
}


def _decorated_functions(path: Path):
    """{function name: number of @contract decorators} of a source file."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            n = sum(isinstance(d, ast.Call) and getattr(
                d.func, "id", getattr(d.func, "attr", None)) == "contract"
                for d in node.decorator_list)
            if n:
                out[node.name] = out.get(node.name, 0) + n
    return out


def test_every_jax_site_is_listed_and_has_a_port_counterpart():
    jax_sites = set()
    for path in sorted({p for p, _ in SITES}):
        for name, n in _decorated_functions(REPO / path).items():
            jax_sites.add((path, name))
    # the JAX package's training/step.py decorates two eval_steps (the
    # plain and the warm one): one name here
    assert jax_sites == set(SITES), jax_sites ^ set(SITES)
    for (_, _), (mod, qual) in SITES.items():
        port = REPO / "raft_tpu_torch" / (mod.replace(".", "/") + ".py")
        fn_name = qual.split(".")[-1]
        assert fn_name in _decorated_functions(port), (mod, qual)


def test_module_level_counterparts_carry_their_specs():
    for (_, _), (mod, qual) in SITES.items():
        if "." in qual:
            continue
        fn = getattr(importlib.import_module(f"raft_tpu_torch.{mod}"), qual)
        specs = fn.__raftlint_contracts__
        for name, spec in specs.items():
            tc.parse_spec(spec)
            assert name == "_returns" or name.split(".")[0] in \
                inspect.signature(fn).parameters, (qual, name)


@pytest.fixture
def checking():
    tc.enable_checking(True)
    yield
    tc.enable_checking(False)


def _small():
    from raft_tpu_torch import RAFTConfig, init_raft_torch
    cfg = RAFTConfig.small_model(iters=2, corr_impl="pallas")
    model = init_raft_torch(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, model


def test_slice_runs_with_checking_on_and_matches_off(checking):
    """The pairwise factory, the streaming entries and an eager train step
    on the CPU with every contract checked: nothing raises, and the flow is
    bitwise the unchecked run's."""
    from raft_tpu_torch import (make_encode_fn, make_inference_fn,
                                make_stream_step_fn)
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.training import TrainState, make_optimizer
    from raft_tpu_torch.training.step import make_train_step
    cfg, model = _small()
    rng = np.random.RandomState(0)
    im1, im2 = (rng.rand(1, 32, 48, 3).astype(np.float32) for _ in range(2))
    fn = make_inference_fn(cfg, device="cpu")
    on = fn(model, im1, im2)
    tc.enable_checking(False)
    off = fn(model, im1, im2)
    tc.enable_checking(True)
    assert torch.equal(torch.as_tensor(on), torch.as_tensor(off))
    fmap, cnet = make_encode_fn(cfg, device="cpu")(model, im1)
    make_stream_step_fn(cfg, device="cpu")(
        model, im2, fmap, cnet, np.zeros((1, 4, 6, 2), np.float32))
    tcfg = TrainConfig(batch_size=2, image_size=(32, 48))
    tx = make_optimizer(tcfg)
    state = TrainState.create(model.train(), tx)
    batch = (rng.rand(2, 32, 48, 3).astype(np.float32),
             rng.rand(2, 32, 48, 3).astype(np.float32),
             rng.randn(2, 32, 48, 2).astype(np.float32),
             np.ones((2, 32, 48), np.float32))
    state, metrics = make_train_step(cfg, tcfg, tx)(state, batch)
    assert np.isfinite(float(metrics["loss"]))


def test_wrong_shape_or_dtype_raises(checking):
    from raft_tpu_torch.models.raft import raft_forward
    from raft_tpu_torch.ops.corr_cuda import fused_lookup
    from raft_tpu_torch.training.loss import sequence_loss
    cfg, model = _small()
    a = torch.zeros(1, 32, 48, 3)
    with pytest.raises(tc.ContractError, match="image2"):
        raft_forward(model, a, torch.zeros(2, 32, 48, 3), cfg)
    with pytest.raises(tc.ContractError, match="valid"):
        sequence_loss(torch.zeros(2, 1, 8, 8, 2), torch.zeros(1, 8, 8, 2),
                      torch.ones(1, 8, 9))
    f1 = torch.zeros(1, 4, 6, 16)
    with pytest.raises(tc.ContractError, match="dtype"):
        fused_lookup(f1, [f1], torch.zeros(1, 4, 6, 2, dtype=torch.float64),
                     1)


def test_checking_reads_no_value(checking):
    """Under FakeTensorMode tensors have shapes and dtypes and no values:
    a checked call runs, so the checks read neither (no host sync)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from raft_tpu_torch.ops.grid_sample import grid_sample
    with FakeTensorMode():
        img = torch.zeros(2, 8, 8, 3)
        out = grid_sample(img, torch.zeros(2, 5, 7, 2))
        assert out.shape == (2, 5, 7, 3)
        with pytest.raises(tc.ContractError):
            grid_sample(img, torch.zeros(3, 5, 7, 2))


def test_switch_is_the_jax_packages():
    """Same environment switch, read at import."""
    import subprocess
    import sys
    code = ("import raft_tpu_torch.lint.contracts as c; "
            "print(c.checking_enabled())")
    for val, want in (("1", "True"), ("0", "False"), ("yes", "True")):
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env={"RAFT_TPU_CHECK_CONTRACTS": val,
                                  "PATH": "/usr/bin:/bin"},
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.strip() == want, out.stderr
