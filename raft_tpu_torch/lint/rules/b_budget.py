"""B rules: serving-plane budget discipline, the port's copy.

The static capacity analyzer (``lint/budget.py``) makes the engine's
compile surface (its CUDA graph captures), device-memory footprint and the
kernels' shared-memory and register envelopes knowable before a replica
boots — these rules keep the code shaped so the analyzer stays TRUE.  The
JAX package's B1-B5, with "jitted entry" read as a captured factory and
"VMEM" as the kernels' shared memory (SMEM):

* B1 — a request-derived value reaching a captured entry point (a name
  bound to one of the model's factories, ``GraphedForward`` or
  ``torch.compile``) directly.  Every wire-derived shape must pass through
  bucket routing (or any normalizing call) first, or the graph cache keys
  on a shape the warmup grid never declared: one odd client resolution =
  one serve-time capture.
* B2 — an engine-cache ``kind`` that is dispatched on but never covered by
  warmup (the literals of every ``warmup()`` and ``export_cache()`` body,
  plus those of ``enumerate_warmup_grid`` when warmup consumes it).  A
  dispatched-but-unwarmed kind is a guaranteed serve-time capture.
* B3 — device-tensor allocation (a ``torch`` constructor given a
  non-CPU ``device=``, or ``.cuda()``) on a serving hot path outside the
  engine and the slot pool.  Per-request device allocation bypasses the
  budgeted resident set: stage on the host and let the warmed graphs own
  device memory.
* B4 — a hardcoded SMEM/HBM byte constant outside ``lint/budget.py``.
  The kernels' shared-memory figures are mirrored there, and only there,
  and ``chip_smoke.py`` holds them to each kernel source's own query; a
  local ``SMEM_LIMIT = 227 * 1024`` re-derives what the analyzer can then
  no longer see.
* B5 — the serialized engine-cache key schema
  (``serving/aot_cache.KEY_FIELDS``) drifting out of sync with the key
  tuples ``lint/budget.enumerate_warmup_grid`` builds.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence, Set

from ..engine import (FileContext, Finding, GlobalRule, Rule,
                      is_captured_factory, register)

#: Parameter names that mark a function as receiving wire/request data.
_REQUEST_PARAM_RE = re.compile(r"(?i)^(req|request|payload|body)s?$|request")

#: torch constructors that materialize a tensor where ``device=`` says.
_DEVICE_ALLOCS = frozenset(
    f"torch.{name}" for name in
    ("zeros", "ones", "empty", "full", "zeros_like", "ones_like",
     "full_like", "empty_like", "arange", "eye", "linspace", "tensor",
     "as_tensor", "randn", "rand"))

_VMEM_NAME_RE = re.compile(r"(?i)smem|shared_mem|hbm")

#: The shared budget model itself is the one place byte constants live.
_BUDGET_MODEL_SUFFIXES = ("lint/budget.py", "lint\\budget.py")


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name of a Name/Subscript/Attribute access chain."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _request_params(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = [a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)]
    return {n for n in names if _REQUEST_PARAM_RE.search(n)}


@register
class B1RequestShapeToJit(Rule):
    rule_id = "B1"
    severity = "error"
    description = ("request-derived value passed to a captured entry "
                   "without bucket routing/normalization — undeclared "
                   "shapes capture at serve time")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        # names bound to a jit/pmap-wrapped callable in this file
        jitted: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and is_captured_factory(ctx.call_name(node.value)):
                jitted.add(node.targets[0].id)
        if not jitted:
            return
        for fn in ctx.functions:
            tainted = _request_params(fn)
            if not tainted:
                continue
            # propagate through plain access/destructuring assignments;
            # any CALL on the right-hand side counts as normalization
            # (bucket routing, padding, host staging) and clears taint
            for _ in range(2):                       # tiny fixpoint
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign) \
                            or isinstance(node.value, ast.Call):
                        continue
                    if _root_name(node.value) not in tainted:
                        continue
                    for tgt in node.targets:
                        elts = tgt.elts if isinstance(
                            tgt, (ast.Tuple, ast.List)) else [tgt]
                        for e in elts:
                            if isinstance(e, ast.Name):
                                tainted.add(e.id)
            for call in ctx.calls(fn):
                if not (isinstance(call.func, ast.Name)
                        and call.func.id in jitted):
                    continue
                for arg in call.args:
                    if isinstance(arg, ast.Call):
                        continue
                    root = _root_name(arg)
                    if root in tainted:
                        yield self.finding(
                            ctx, call,
                            f"request-derived value {root!r} flows into "
                            f"captured {call.func.id!r} without bucket "
                            f"routing — its shape keys the graph cache, "
                            f"so undeclared client shapes capture at "
                            f"serve time (route + pad first)")
                        break


def _string_constants(node: ast.AST) -> Set[str]:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _dispatched_kinds(node: ast.AST):
    """Yield (constant_node, literal) for ``kind == "..."`` /
    ``kind in ("...", ...)`` comparisons under ``node``."""
    for cmp in ast.walk(node):
        if not isinstance(cmp, ast.Compare):
            continue
        sides = [cmp.left] + list(cmp.comparators)
        if not any((isinstance(s, ast.Name) and s.id == "kind")
                   or (isinstance(s, ast.Attribute) and s.attr == "kind")
                   for s in sides):
            continue
        for op, side in zip(cmp.ops, cmp.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)) \
                    and isinstance(side, ast.Constant) \
                    and isinstance(side.value, str):
                yield side, side.value
            elif isinstance(op, (ast.In, ast.NotIn)) \
                    and isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                for e in side.elts:
                    if isinstance(e, ast.Constant) \
                            and isinstance(e.value, str):
                        yield e, e.value


@register
class B2UnwarmedKind(GlobalRule):
    rule_id = "B2"
    severity = "error"
    description = ("engine-cache kind dispatched on but absent from warmup "
                   "coverage — a guaranteed serve-time capture")

    def check_all(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        # warmup coverage: literals in every warmup() body; when warmup
        # consumes the analyzer's enumeration, the literals of every
        # enumerate_warmup_grid definition in the scan set count too
        provider: Set[str] = set()
        for ctx in ctxs:
            for fn in ctx.functions:
                if fn.name == "enumerate_warmup_grid":
                    provider |= _string_constants(fn)
        coverage: Set[str] = set()
        warmups: List[ast.AST] = []
        for ctx in ctxs:
            for fn in ctx.functions:
                # export_cache serializes warmed executables for the AOT
                # cache: a kind it covers is warmed-on-load at next boot
                if fn.name not in ("warmup", "export_cache"):
                    continue
                warmups.append(fn)
                coverage |= _string_constants(fn)
                for call in ctx.calls(fn):
                    name = ctx.call_name(call)
                    if name and name.endswith("enumerate_warmup_grid"):
                        coverage |= provider
        if not warmups:
            # nothing declares a warmup surface in this scan set — the
            # rule has no coverage baseline to check dispatches against
            return
        # a function counts as an ENGINE-kind dispatcher only when it
        # compares ``kind`` against at least one covered literal — "kind"
        # is a common local (the lint engine's own AST code uses it), so
        # the anchor literal keeps unrelated dispatch tables silent; the
        # hazard caught is the real one: a NEW kind added to a dispatcher
        # that the warmup grid doesn't know about yet
        for ctx in ctxs:
            groups = {}
            for node, kind in _dispatched_kinds(ctx.tree):
                fn = next(ctx.enclosing_functions(node), None)
                groups.setdefault(fn, []).append((node, kind))
            for hits in groups.values():
                if not any(kind in coverage for _, kind in hits):
                    continue
                for node, kind in hits:
                    if kind not in coverage:
                        yield self.finding(
                            ctx, node,
                            f"engine-cache kind {kind!r} is dispatched "
                            f"here but no warmup covers it — add it to "
                            f"the warmup grid (lint/budget."
                            f"enumerate_warmup_grid) or it captures "
                            f"at serve time")


@register
class B3HotPathDeviceAlloc(Rule):
    rule_id = "B3"
    severity = "warning"
    description = ("device-tensor allocation on a serving hot path outside "
                   "the engine/SlotPool — per-request HBM the budget never "
                   "accounted for")

    def _serving_path(self, ctx: FileContext) -> bool:
        norm = ctx.path.replace("\\", "/")
        if "/serving/" not in norm:
            return False
        base = norm.rsplit("/", 1)[-1]
        # the engine and the slot pool are WHERE device memory is
        # supposed to be owned; everything else in serving/ is host-side
        return base not in ("engine.py", "session.py")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        serving_file = self._serving_path(ctx)
        for call in ctx.calls():
            name = ctx.call_name(call)
            if name in _DEVICE_ALLOCS:
                dev = next((k.value for k in call.keywords
                            if k.arg == "device"), None)
                if dev is None or (isinstance(dev, ast.Constant)
                                   and dev.value == "cpu"):
                    continue        # a host tensor: staging, not HBM
            elif not (isinstance(call.func, ast.Attribute)
                      and call.func.attr == "cuda" and not call.args):
                continue
            else:
                name = ".cuda"
            if ctx.in_traced(call):
                continue    # captured: part of a graph's own pool
            hot = serving_file
            for fn in ctx.enclosing_functions(call):
                if isinstance(fn, ast.Lambda):
                    continue
                if fn.name.startswith("handle") or _request_params(fn):
                    hot = True
                break
            if hot:
                yield self.finding(
                    ctx, call,
                    f"{name} allocates a device tensor per request on a "
                    f"serving hot path — stage on the host and let the "
                    f"warmed graphs / SlotPool own device memory")


def _is_numeric_literal(node: ast.AST) -> bool:
    """A constant-folded byte count: int/float literals combined with
    arithmetic only (16 * 1024 * 1024, 1 << 24, ...)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.BinOp):
        return _is_numeric_literal(node.left) \
            and _is_numeric_literal(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    return False


@register
class B4HardcodedSmemBudget(Rule):
    rule_id = "B4"
    severity = "error"
    description = ("hardcoded SMEM/HBM byte constant bypasses the shared "
                   "budget model (lint/budget.py)")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        norm = ctx.path.replace("\\", "/")
        if norm.endswith(_BUDGET_MODEL_SUFFIXES[0]) \
                or norm.endswith(_BUDGET_MODEL_SUFFIXES[1]):
            return      # the model itself is where the numbers live
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if not _is_numeric_literal(value):
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name) \
                        and _VMEM_NAME_RE.search(tgt.id):
                    yield self.finding(
                        ctx, node,
                        f"{tgt.id!r} hardcodes a device-memory budget — "
                        f"import it from raft_tpu_torch.lint.budget "
                        f"(H100_LIMITS / DEVICE_BUDGETS) so the static "
                        f"analyzer and the code agree on one number")


@register
class B5CacheKeySchemaDrift(GlobalRule):
    rule_id = "B5"
    severity = "error"
    description = ("serialized engine-cache key schema (aot_cache."
                   "KEY_FIELDS) out of sync with the key tuple "
                   "lint/budget.enumerate_warmup_grid builds")

    def check_all(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        # side 1: the persisted schema — KEY_FIELDS = ("kind", ...) in the
        # cache module (a module-level tuple of string literals)
        fields = None
        f_ctx = f_node = None
        # side 2: the live key — ``key = (kind, h, w, b, policy)`` inside
        # enumerate_warmup_grid (a tuple of plain names)
        names = None
        n_ctx = n_node = None
        for ctx in ctxs:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == "KEY_FIELDS" \
                        and isinstance(node.value, ast.Tuple):
                    vals = [e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
                    if len(vals) == len(node.value.elts):
                        fields, f_ctx, f_node = tuple(vals), ctx, node
            for fn in ctx.functions:
                if fn.name != "enumerate_warmup_grid":
                    continue
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name) \
                            and node.targets[0].id == "key" \
                            and isinstance(node.value, ast.Tuple):
                        names = tuple(
                            e.id if isinstance(e, ast.Name) else "<expr>"
                            for e in node.value.elts)
                        n_ctx, n_node = ctx, node
        if fields is None or names is None:
            return      # one side absent from the scan set: no baseline
        if fields != names:
            yield self.finding(
                f_ctx, f_node,
                f"aot_cache.KEY_FIELDS {fields!r} no longer matches the "
                f"key tuple enumerate_warmup_grid builds {names!r} "
                f"({n_ctx.path}:{n_node.lineno}) — every persisted cache "
                f"manifest pins this schema, so the two definitions must "
                f"agree name-for-name, in order")
