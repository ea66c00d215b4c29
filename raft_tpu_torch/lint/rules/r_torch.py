"""R2, R3, R4, R5, R8, K1: the port's counterparts of the JAX package's
hazard rules, for the hazards PyTorch and CUDA graphs have.

* **R2** — a graph or a compiled function built again for each call:
  ``torch.compile``, ``torch.cuda.CUDAGraph()``, ``GraphedForward`` or
  ``torch.cuda.make_graphed_callables`` constructed in a loop body,
  invoked where it is built (``torch.compile(f)(x)``), or built and called
  in one function that neither returns nor keeps it.  Each build starts
  with an empty cache, so every call compiles or captures again.
* **R3** — global RNG in library code: ``torch.manual_seed`` (and its CUDA
  and numpy/Python twins) reseeds every caller's stream; ``torch.rand*`` /
  ``torch.normal`` / ``torch.bernoulli`` / ``torch.multinomial`` /
  ``torch.randperm`` and the in-place ``.uniform_()``/``.normal_()``/
  ``.bernoulli_()`` without ``generator=`` draw from that shared stream, so
  two call sites correlate and a result depends on what ran before.  Pass a
  ``torch.Generator``.  Entry points (scripts, ``cli.py``, ``main`` and
  ``*_cli`` functions) own the process and are exempt.
* **R4** — float64 creep (``torch.float64``/``torch.double``,
  ``.double()``, ``dtype=float`` in a torch call: half the rate and twice
  the bytes on the card) in modules that import torch, and TF32 switched
  on outside its one owner: an assignment to ``*.allow_tf32`` or a
  ``torch.set_float32_matmul_precision`` call anywhere but
  ``models/raft.py`` (``tf32_off``, which holds the float32 numerics and
  restores the caller's switches).
* **R5** — ``torch.where(cond, a, b)`` with an unsafe branch (a division,
  ``sqrt``/``rsqrt``/``log``/``reciprocal``/``pow``/``norm``): autograd
  differentiates both branches, so a NaN or inf of the untaken branch
  reaches the gradient (0 * NaN = NaN).  Sanitize the operand with an
  inner ``torch.where``/``clamp``/``maximum`` first.
* **R8** — a flow iterate not detached in the recurrent loop: a ``for``/
  ``while`` body (or a function passed to ``torch.utils.checkpoint``) that
  updates a ``coords*``/``flow*`` name additively with no ``.detach()`` in
  it.  Official RAFT detaches the coordinates each iteration; without it
  the backward runs through every iteration's coordinate chain.
* **K1** — a kernel wrapper without a plain twin.  A wrapper is a function
  that counts its own launches (``<name>.launches += 1``, the port's rule
  for every kernel entry); its module must register it beside a plain
  version in one call (the operator registration ``_operator(name,
  schema, plain, kernel)``: one function argument whose body reaches the
  wrapper, another that does not), so the CPU path, the tests and
  ``chip_smoke.py`` have the plain version to hold the kernel against.
"""

from __future__ import annotations

import ast
import re
from pathlib import PurePath
from typing import Dict, Iterable, Set

from ..engine import FileContext, Finding, Rule, register

_BUILDERS = {"torch.compile", "torch.cuda.CUDAGraph",
             "torch.cuda.make_graphed_callables"}
_BUILDER_TAILS = {"GraphedForward", "GraphedTrainStep"}


def _is_builder(ctx: FileContext, call: ast.Call) -> bool:
    name = ctx.call_name(call) or ""
    return name in _BUILDERS or name.rsplit(".", 1)[-1] in _BUILDER_TAILS


def _in_loop(ctx: FileContext, node: ast.AST) -> bool:
    cur = ctx.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        if isinstance(cur, (ast.For, ast.While, ast.comprehension)):
            return True
        cur = ctx.parent(cur)
    return False


@register
class GraphBuiltPerCall(Rule):
    rule_id = "R2"
    severity = "error"
    description = ("graph or torch.compile built again for each call (in a "
                   "loop, invoked where built, or built and called in one "
                   "function that keeps nothing): every call captures or "
                   "compiles anew")

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            if isinstance(call.func, ast.Call) and _is_builder(ctx,
                                                               call.func):
                yield self.finding(
                    ctx, call,
                    f"{ctx.call_name(call.func)}(...)(...) builds and "
                    f"calls in one expression: the build's cache dies "
                    f"with it, so every call compiles or captures again")
            elif _is_builder(ctx, call) and _in_loop(ctx, call):
                yield self.finding(
                    ctx, call,
                    f"{ctx.call_name(call)} built in a loop body: each "
                    f"iteration starts from an empty cache — build once, "
                    f"outside the loop")
        for fn in ctx.functions:
            built: Dict[str, ast.AST] = {}
            kept: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.value, ast.Call) \
                        and _is_builder(ctx, node.value):
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Name):
                        built[tgt.id] = node
                elif isinstance(node, ast.Return) and node.value is not None:
                    called = {id(c.func) for c in ast.walk(node.value)
                              if isinstance(c, ast.Call)}
                    kept |= {n.id for n in ast.walk(node.value)
                             if isinstance(n, ast.Name)
                             and id(n) not in called}
                elif isinstance(node, ast.Assign) and any(
                        not isinstance(t, ast.Name) for t in node.targets):
                    kept |= {n.id for n in ast.walk(node.value)
                             if isinstance(n, ast.Name)}
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    kept |= set(node.names)
            calls = [c for c in ctx.calls(fn) if isinstance(c.func, ast.Name)
                     and c.func.id in built]
            # called in a loop of the same function: built once, used
            # many times
            kept |= {c.func.id for c in calls if _in_loop(ctx, c)}
            for call in calls:
                f = call.func
                if f.id not in kept:
                    yield self.finding(
                        ctx, built[f.id],
                        f"{f.id!r} is built and called in {fn.name}() and "
                        f"not kept: every call of {fn.name}() compiles or "
                        f"captures again — build it once (a factory, a "
                        f"module-level cache or an attribute)")


_SEEDERS = {"torch.manual_seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "torch.seed", "numpy.random.seed",
            "random.seed"}
_DRAWS = {f"torch.{n}" for n in ("rand", "randn", "randint", "randperm",
                                  "normal", "bernoulli", "multinomial",
                                  "poisson", "rand_like", "randn_like",
                                  "randint_like")}
_DRAW_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _is_entry_point(ctx: FileContext) -> bool:
    if PurePath(ctx.path).name in ("cli.py", "__main__.py"):
        return True
    for node in ctx.tree.body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare) \
                and isinstance(node.test.left, ast.Name) \
                and node.test.left.id == "__name__":
            return True
    return False


def _in_entry_function(ctx: FileContext, node: ast.AST) -> bool:
    for fn in ctx.enclosing_functions(node):
        name = getattr(fn, "name", "")
        if name == "main" or name.endswith("_cli"):
            return True
    return False


@register
class GlobalRng(Rule):
    rule_id = "R3"
    severity = "error"
    description = ("global RNG in library code: torch.manual_seed, or a "
                   "torch.rand*/normal/bernoulli draw (or .uniform_()/"
                   ".normal_()) without generator= — pass a "
                   "torch.Generator")

    def check(self, ctx: FileContext):
        if _is_entry_point(ctx):
            return
        for call in ctx.calls():
            if _in_entry_function(ctx, call):
                continue
            name = ctx.call_name(call) or ""
            has_gen = any(k.arg == "generator" for k in call.keywords)
            if name in _SEEDERS:
                yield self.finding(
                    ctx, call,
                    f"{name}() in library code reseeds the process's "
                    f"global stream under every caller — take a "
                    f"torch.Generator (seeded by the caller) instead")
            elif name in _DRAWS and not has_gen:
                yield self.finding(
                    ctx, call,
                    f"{name}() without generator= draws from the global "
                    f"stream: the result depends on what ran before — "
                    f"pass a torch.Generator")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _DRAW_METHODS and not has_gen \
                    and ctx.imports_torch:
                yield self.finding(
                    ctx, call,
                    f".{call.func.attr}() without generator= draws from "
                    f"the global stream — pass a torch.Generator")


_F64 = {"torch.float64", "torch.double"}
_TF32_OWNER = "models/raft.py"


@register
class DtypeDiscipline(Rule):
    rule_id = "R4"
    severity = "error"
    description = ("float64 creep in torch code (torch.float64/.double()/"
                   "dtype=float), or TF32 switched outside its owner "
                   "(models/raft.py::tf32_off)")

    def check(self, ctx: FileContext):
        if not ctx.imports_torch:
            return
        owner = ctx.path.replace("\\", "/").endswith(_TF32_OWNER)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) \
                    and ctx.resolve(node) in _F64:
                yield self.finding(
                    ctx, node,
                    f"{ctx.resolve(node)} in torch code: float64 runs at a "
                    f"fraction of the card's float32 rate and doubles the "
                    f"bytes — keep tensors float32 (host numpy may use "
                    f"float64)")
            elif isinstance(node, ast.Call):
                name = ctx.call_name(node) or ""
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "double" and not node.args:
                    yield self.finding(
                        ctx, node, ".double() casts a tensor to float64 — "
                                   "keep it float32")
                elif name.startswith("torch.") and any(
                        k.arg == "dtype" and isinstance(k.value, ast.Name)
                        and k.value.id == "float" for k in node.keywords):
                    yield self.finding(
                        ctx, node, f"dtype=float in {name}() is float64 — "
                                   f"say torch.float32")
                elif name == "torch.set_float32_matmul_precision" \
                        and not owner:
                    yield self.finding(
                        ctx, node,
                        "torch.set_float32_matmul_precision outside "
                        "models/raft.py: TF32 has one owner (tf32_off)")
            elif isinstance(node, (ast.Assign, ast.AugAssign)) and not owner:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                        if isinstance(el, ast.Attribute) \
                                and el.attr == "allow_tf32":
                            yield self.finding(
                                ctx, node,
                                "an allow_tf32 switch set outside "
                                "models/raft.py: TF32 has one owner "
                                "(tf32_off, which holds float32 numerics "
                                "and restores the caller's switches)")


_WHERE = {"torch.where"}
_UNSAFE = {f"torch.{n}" for n in ("sqrt", "rsqrt", "log", "log2", "log10",
                                   "log1p", "reciprocal", "div", "divide",
                                   "true_divide", "pow", "asin", "acos",
                                   "atanh", "norm")} | {
    "torch.linalg.norm", "torch.linalg.vector_norm"}
_UNSAFE_METHODS = {"sqrt", "rsqrt", "log", "reciprocal", "pow", "norm"}
_SANITIZERS = {"torch.where", "torch.clamp", "torch.clip", "torch.maximum",
               "torch.minimum"}
_SANITIZER_METHODS = {"clamp", "clamp_min", "clip"}


def _sanitized(ctx: FileContext, node: ast.AST, names: Set[str]) -> bool:
    if isinstance(node, ast.Name) and node.id in names:
        return True
    if isinstance(node, ast.Call):
        if ctx.call_name(node) in _SANITIZERS:
            return True
        f = node.func
        return isinstance(f, ast.Attribute) and f.attr in _SANITIZER_METHODS
    if isinstance(node, ast.Constant):
        return True
    return False


def _unsafe_reason(ctx: FileContext, branch: ast.AST, names: Set[str]):
    for node in ast.walk(branch):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and not _sanitized(ctx, node.right, names):
            return "a division"
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow) \
                and not (isinstance(node.right, ast.Constant)
                         and isinstance(node.right.value, int)):
            return "a fractional power"
        if isinstance(node, ast.Call):
            name = ctx.call_name(node)
            if name in _UNSAFE and not (
                    node.args and _sanitized(ctx, node.args[0], names)):
                return f"{name.split('.')[-1]}()"
            f = node.func
            if name is None and isinstance(f, ast.Attribute) \
                    and f.attr in _UNSAFE_METHODS \
                    and not _sanitized(ctx, f.value, names):
                return f".{f.attr}()"
    return None


@register
class WhereGradTrap(Rule):
    rule_id = "R5"
    severity = "error"
    description = ("torch.where with an unsafe branch (division/sqrt/log/"
                   "norm): autograd differentiates both branches, 0*NaN "
                   "poisons the gradient — sanitize the operand first")

    def check(self, ctx: FileContext):
        sanitized: Dict[object, Set[str]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _sanitized(ctx, node.value, set()) \
                    and isinstance(node.value, ast.Call):
                scope = next(ctx.enclosing_functions(node), None)
                sanitized.setdefault(scope, set()).add(node.targets[0].id)
        for call in ctx.calls():
            if ctx.call_name(call) not in _WHERE or len(call.args) != 3:
                continue
            scope = next(ctx.enclosing_functions(call), None)
            names = sanitized.get(scope, set()) | sanitized.get(None, set())
            for branch in call.args[1:]:
                reason = _unsafe_reason(ctx, branch, names)
                if reason:
                    yield self.finding(
                        ctx, call,
                        f"torch.where branch contains {reason}: autograd "
                        f"differentiates both branches, so NaN/inf from "
                        f"the untaken one reaches the gradient — sanitize "
                        f"the operand with an inner torch.where/clamp "
                        f"first")
                    break


_ITERATE = re.compile(r"^(coords?|flow)\w*$")


def _additive_target(node: ast.AST):
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
            and isinstance(node.targets[0], ast.Name) \
            and isinstance(node.value, ast.BinOp) \
            and isinstance(node.value.op, ast.Add):
        t = node.targets[0].id
        if any(isinstance(o, ast.Name) and o.id == t
               for o in (node.value.left, node.value.right)):
            return t
    if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add) \
            and isinstance(node.target, ast.Name):
        return node.target.id
    return None


def _detaches(body) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in ("detach", "detach_")
               for st in body for n in ast.walk(st))


@register
class IterateNotDetached(Rule):
    rule_id = "R8"
    severity = "error"
    description = ("flow/coords iterate updated additively in a recurrent "
                   "loop with no .detach(): the backward runs through "
                   "every iteration's coordinate chain (official RAFT "
                   "detaches, RAFT.py:93)")

    def check(self, ctx: FileContext):
        if not ctx.imports_torch:
            return
        bodies = [(n, n.body) for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.For, ast.While))]
        bodies += [(fn, fn.body) for fn in ctx.functions
                   if ctx.traced.get(fn) == "torch.utils.checkpoint."
                                            "checkpoint"]
        for owner, body in bodies:
            if _detaches(body):
                continue
            for st in body:
                for node in ast.walk(st):
                    t = _additive_target(node)
                    if t and _ITERATE.match(t):
                        yield self.finding(
                            ctx, node,
                            f"recurrent loop updates {t!r} additively with "
                            f"no .detach() in its body: detach the flow "
                            f"iterate each iteration (coords1 = "
                            f"coords1.detach()), as official RAFT does")


def _calls_name(fn: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == name for n in ast.walk(fn))


@register
class KernelWrapperWithoutTwin(Rule):
    rule_id = "K1"
    severity = "error"
    description = ("kernel wrapper (a function counting its .launches) "
                   "not registered beside a plain twin — the CPU path, the "
                   "tests and chip_smoke have nothing to hold it against")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        defs = {fn.name: fn for fn in ctx.tree.body
                if isinstance(fn, ast.FunctionDef)}
        wrappers = []
        for fn in ctx.functions:
            for node in ast.walk(fn):
                if isinstance(node, ast.AugAssign) \
                        and isinstance(node.target, ast.Attribute) \
                        and node.target.attr == "launches" \
                        and isinstance(node.target.value, ast.Name):
                    wrappers.append((fn, node.target.value.id))
        for fn, counted in wrappers:
            # the counted name is the wrapper itself, or (a shared launch
            # helper) a parameter standing for each public wrapper
            names = ([counted] if counted in defs
                     else [w for w, d in defs.items()
                           if _calls_name(d, fn.name) and w != fn.name])
            for w in names:
                if not self._has_twin(ctx, defs, w):
                    yield self.finding(
                        ctx, defs.get(w, fn),
                        f"kernel wrapper {w}() is not registered beside a "
                        f"plain twin: register it with its plain version "
                        f"(an operator: _operator(name, schema, plain, "
                        f"kernel))")

    @staticmethod
    def _has_twin(ctx, defs, wrapper: str) -> bool:
        """True when calls naming one operator (the same leading string
        literal, e.g. ``LIB.impl("sep_conv_gru", plain, "CPU")`` and
        ``LIB.impl("sep_conv_gru", kernel, "CUDA")``, or one
        ``_operator("corr_lookup", schema, plain, kernel)``) pass both a
        function reaching the wrapper and one that does not."""
        reach = {wrapper} | {d for d, f in defs.items()
                             if _calls_name(f, wrapper)}
        groups: Dict[object, Set[str]] = {}
        for call in ctx.calls():
            head = call.args[0] if call.args else None
            key = (head.value if isinstance(head, ast.Constant)
                   and isinstance(head.value, str) else id(call))
            groups.setdefault(key, set()).update(
                a.id for a in call.args
                if isinstance(a, ast.Name) and a.id in defs)
        return any(args & reach and args - reach
                   for args in groups.values())
