"""The port's raftlint (``raft_tpu_torch/lint/engine.py``, ``lint/rules/``,
``python -m raft_tpu_torch.tools.raftlint``): each rule fires on its bad
fixture, not on its good twin, and not when suppressed; R9, R10 and C1-C6
report the same rule ids and lines as the JAX engine on the JAX suite's own
fixtures; the self-scan of ``raft_tpu_torch/`` is clean under ``--strict``
with every baselined finding carrying its reason; the budget command line
passes the default serving configuration and fails one made to overflow.
Pure AST for the scans (no JAX compile)."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.lint import engine
from raft_tpu_torch.tools import raftlint

torch.set_num_threads(2)   # several test workers share the host's cores

REPO = Path(__file__).resolve().parent.parent


def ids(findings):
    return {f.rule_id for f in findings}


FIXTURES = [
    ("R1", """
import torch
from raft_tpu_torch.models.capture import GraphedForward

def forward(model, x):
    print("tracing", x.shape)
    return model(x)

fn = GraphedForward(forward, None, (None,), None)
""", """
import torch
from raft_tpu_torch.models.capture import GraphedForward

def forward(model, x):
    return model(x)

fn = GraphedForward(forward, None, (None,), None)
print("built")
"""),
    ("R1", """
import time
import torch

def run(g, x):
    with torch.cuda.graph(g):
        t0 = time.perf_counter()
        y = x * 2
    return y
""", """
import time
import torch

def run(g, x):
    t0 = time.perf_counter()
    with torch.cuda.graph(g):
        y = x * 2
    return y
"""),
    ("R2", """
import torch

def train(model, xs):
    for x in xs:
        step = torch.compile(model)
        step(x)
""", """
import torch

def train(model, xs):
    step = torch.compile(model)
    for x in xs:
        step(x)
"""),
    ("R2", """
import torch

def serve(model, x):
    fast = torch.compile(model)
    return fast(x)
""", """
import torch

def factory(model):
    fast = torch.compile(model)
    return fast
"""),
    ("R3", """
import torch

def init_weights(shape):
    return torch.randn(*shape) * 0.02
""", """
import torch

def init_weights(shape, generator):
    return torch.randn(*shape, generator=generator) * 0.02
"""),
    ("R3", """
import torch

def reset(seed):
    torch.manual_seed(seed)
""", """
import torch

def reset(seed):
    return torch.Generator().manual_seed(seed)
"""),
    ("R4", """
import torch

def stats(x):
    return x.to(torch.float64).mean()
""", """
import torch

def stats(x):
    return x.float().mean()
"""),
    ("R4", """
import torch

def fast_mode():
    torch.backends.cuda.matmul.allow_tf32 = True
""", """
import torch
from raft_tpu_torch.models.raft import tf32_off

def exact(fn):
    with tf32_off():
        return fn()
"""),
    ("R5", """
import torch

def normalize(x, n):
    return torch.where(n > 0, x / n, x)
""", """
import torch

def normalize(x, n):
    safe = torch.where(n > 0, n, torch.ones_like(n))
    return torch.where(n > 0, x / safe, x)
"""),
    ("R6", """
import torch

def capture(g, x):
    with torch.cuda.graph(g):
        n = x.sum().item()
    return n
""", """
import torch

def capture(g, x):
    with torch.cuda.graph(g):
        n = x.sum()
    return n.item()
"""),
    ("R7", """
import torch

def two_calls(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = x * 2
    g.replay()
    first = out
    g.replay()
    return first, out
""", """
import torch

def two_calls(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = x * 2
    g.replay()
    first = out.clone()
    g.replay()
    return first, out
"""),
    ("R8", """
import torch

def iterate(coords1, update, steps):
    for _ in range(steps):
        coords1 = coords1 + update(coords1)
    return coords1
""", """
import torch

def iterate(coords1, update, steps):
    for _ in range(steps):
        coords1 = coords1.detach()
        coords1 = coords1 + update(coords1)
    return coords1
"""),
    ("K1", """
def corr_cuda(x):
    corr_cuda.launches += 1
    return x

corr_cuda.launches = 0
""", """
def corr_cuda(x):
    corr_cuda.launches += 1
    return x

corr_cuda.launches = 0

def _plain(x):
    return x

def _kernel(x):
    return corr_cuda(x)

LIB.impl("corr", _plain, "CPU")
LIB.impl("corr", _kernel, "CUDA")
"""),
    ("R9", """
from raft_tpu_torch.lint.contracts import contract

@contract(x="f32[B,,2]")
def f(x):
    return x
""", """
from raft_tpu_torch.lint.contracts import contract

@contract(x="f32[B,2]")
def f(x):
    return x
"""),
    ("R10", """
def load(path):
    print("loading", path)
    return path
""", """
from raft_tpu_torch.telemetry.log import get_logger

_log = get_logger("data")

def load(path):
    _log.info(f"loading {path}")
    return path
"""),
    ("B1", """
from raft_tpu_torch.models.raft import make_inference_fn

fn = make_inference_fn(config)

def handle(request, model):
    im1 = request.image1
    return fn(model, im1, im1)
""", """
from raft_tpu_torch.models.raft import make_inference_fn

fn = make_inference_fn(config)

def handle(request, model):
    im1 = pad_to_bucket(request.image1)
    return fn(model, im1, im1)
"""),
    ("B2", """
class Engine:
    def warmup(self):
        for kind in ("pair", "encode"):
            self._capture(kind)

    def run(self, kind):
        if kind == "pair":
            return 1
        if kind == "stream":
            return 2
""", """
class Engine:
    def warmup(self):
        for kind in ("pair", "encode", "stream"):
            self._capture(kind)

    def run(self, kind):
        if kind == "pair":
            return 1
        if kind == "stream":
            return 2
"""),
    ("B3", """
import torch

def handle(request):
    return torch.zeros(4, device="cuda")
""", """
import torch

def handle(request):
    return torch.zeros(4)
"""),
    ("B4", """
SMEM_LIMIT = 227 * 1024
""", """
from raft_tpu_torch.lint.budget import H100_LIMITS

SMEM_LIMIT = H100_LIMITS["smem_per_block"]
"""),
    ("B5", """
KEY_FIELDS = ("kind", "h", "w", "b", "policy")

def enumerate_warmup_grid(config, sconfig):
    key = (kind, w, h, b, policy)
    return [key]
""", """
KEY_FIELDS = ("kind", "h", "w", "b", "policy")

def enumerate_warmup_grid(config, sconfig):
    key = (kind, h, w, b, policy)
    return [key]
"""),
]

def _jax_fixtures():
    spec = importlib.util.spec_from_file_location(
        "jax_lint_fixtures", REPO / "tests" / "test_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FIXTURES


# C1-C6 are the JAX package's rules as they are: their bad and good
# fixtures are the JAX suite's own
FIXTURES += [f for f in _jax_fixtures() if f[0].startswith("C")]

_IDS = [f"{r}-{i}" for i, (r, _, _) in enumerate(FIXTURES)]


@pytest.mark.parametrize("rule_id,bad,good", FIXTURES, ids=_IDS)
def test_rule_fires_and_good_twin_clean(rule_id, bad, good):
    assert rule_id in ids(engine.scan_source(bad)), \
        f"{rule_id} did not fire on its bad fixture"
    assert rule_id not in ids(engine.scan_source(good)), \
        f"{rule_id} fired on its good twin"


@pytest.mark.parametrize("rule_id,bad,good", FIXTURES, ids=_IDS)
def test_suppression_comment_silences(rule_id, bad, good):
    findings = [f for f in engine.scan_source(bad) if f.rule_id == rule_id]
    assert findings
    lines = bad.splitlines()
    for f in findings:
        lines[f.line - 1] += f"  # raftlint: disable={rule_id}"
    assert rule_id not in ids(engine.scan_source("\n".join(lines)))


def test_every_rule_has_a_fixture_and_is_listed(capsys):
    engine.active_rules()
    assert set(engine.RULES) == {r for r, _, _ in FIXTURES}
    assert raftlint.main(["--list-rules"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
    assert listed == set(engine.RULES)
    docs = (REPO / "raft_tpu_torch" / "lint" / "RULES.md").read_text()
    for rid in engine.RULES:
        assert f"**{rid}**" in docs, rid


SHARED = ("R9", "R10", "C1", "C2", "C3", "C4", "C5", "C6")


def test_shared_rules_match_the_jax_engine():
    """R9, R10 and C1-C6 on the JAX suite's fixtures of those rules (bad
    and good): the same (rule, line) pairs from both engines."""
    from raft_tpu.lint import engine as jengine
    checked = 0
    for rule_id, bad, good in _jax_fixtures():
        if rule_id not in SHARED:
            continue
        for src in (bad, good):
            want = {(f.rule_id, f.line) for f in jengine.scan_source(src)
                    if f.rule_id in SHARED}
            got = {(f.rule_id, f.line) for f in engine.scan_source(src)
                   if f.rule_id in SHARED}
            assert got == want, (rule_id, src)
            checked += bool(want)
    assert checked >= len(SHARED)


@pytest.mark.lint
def test_self_scan_clean_under_strict(capsys):
    assert raftlint.main(["--strict"]) == 0, capsys.readouterr().out
    doc = json.loads(raftlint.DEFAULT_BASELINE.read_text())
    for rec in doc["findings"]:
        assert rec.get("reason", "").strip(), rec
    # without the baseline, exactly the baselined findings remain
    assert raftlint.main(["--strict", "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert f"{len(doc['findings'])} error(s)" in out or \
        "error(s)" in out


def test_budget_default_passes_and_overflow_fails(capsys):
    assert raftlint.main(["--budget", "--strict", "--device-kind",
                          "h100-80gb", "--serve-args",
                          "--buckets 32x48 --max-sessions 4"]) == 0
    rc = raftlint.main(["--budget", "--strict", "--device-kind", "cpu",
                        "--serve-args", "--buckets 432x1024 --max-sessions "
                        "4096"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "does not fit" in err or "exceeds" in err
    assert raftlint.main(["--budget", "--serve-args", "--bogus 1"]) == 2


def test_budget_json_carries_pools_and_envelopes(capsys):
    assert raftlint.main(["--budget", "--json", "--serve-args",
                          "--small --iters 2 --buckets 32x48 --max-batch 2 "
                          "--max-sessions 2"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["grid"]["size"] == 9
    pools = rep["graph_pools"]["pools"]
    assert set(pools) == {"pair", "encode", "stream", "sbatch"}
    assert all(p["price"] > 0 for p in pools.values())
    kernels = {(e["kernel"], e["entry"]) for e in rep["kernels"]["entries"]}
    for kid in ("B1", "B2", "B3", "B4", "B5"):
        assert {e for k, e in kernels if k == kid} >= {
            e for k, e in kernels if k == kid and e.endswith(("f32", "bf16"))}
        assert any(k == kid and e.endswith("_f32") for k, e in kernels)
        assert any(k == kid and e.endswith("_bf16") for k, e in kernels)
    assert not rep["kernels"]["violations"]


def test_default_budget_baseline_matches_the_grid():
    base = json.loads(raftlint.DEFAULT_BUDGET_BASELINE.read_text())
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.lint.budget import enumerate_warmup_grid
    from raft_tpu_torch.serving import ServeConfig
    grid = enumerate_warmup_grid(RAFTConfig.full(), ServeConfig())
    assert base["grid"]["size"] == len(grid)
