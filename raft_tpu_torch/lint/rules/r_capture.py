"""R1, R6, R7: what a captured region may not do.

A captured region (``engine.FileContext.in_traced``: a function handed to
``GraphedForward``, ``torch.cuda.make_graphed_callables``,
``torch.compile`` or a ``torch.func`` transform, or a statement inside
``with torch.cuda.graph(...):``) is recorded once and replayed without
Python:

* **R1** — a Python side effect there (``print``, a clock read, Python's or
  numpy's RNG, a log call) runs once, at capture, and never in a replay:
  the replay prints nothing, times nothing and draws nothing.
* **R6** — a host sync there (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor,
  ``torch.cuda.synchronize``, an event's or stream's ``.synchronize()``)
  fails the capture (a copy to the host is not capturable) or, in
  ``torch.compile``, breaks the graph and syncs the stream on every call.
* **R7** — the port's counterpart of the JAX package's donation rule: a
  CUDA graph writes its outputs into the same static tensors on every
  replay, so a name bound to a static output (assigned inside a ``with
  torch.cuda.graph(...):`` block, or aliased from one without
  ``.clone()``) and read after the next ``.replay()`` reads the NEXT
  call's values.  Clone the outputs out, as ``models/capture.py`` does.
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from ..engine import CAPTURE_CONTEXTS, FileContext, Rule, register

_SIDE_EFFECT_PREFIXES = ("time.", "random.", "numpy.random.", "logging.")
_LOG_METHODS = {"debug", "info", "warning", "error", "exception"}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_CAST_BUILTINS = {"float", "int", "bool"}


@register
class SideEffectsInCapturedCode(Rule):
    rule_id = "R1"
    severity = "error"
    description = ("Python side effect in captured code: print / a clock / "
                   "Python or numpy RNG / a log call inside a CUDA graph "
                   "capture, torch.compile or torch.func region runs once, "
                   "never in a replay")

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            why = ctx.in_traced(call)
            if not why:
                continue
            name = ctx.call_name(call) or ""
            fn = call.func
            if name == "print":
                what = "print()"
            elif name.startswith(_SIDE_EFFECT_PREFIXES):
                what = f"{name}()"
            elif isinstance(fn, ast.Attribute) and fn.attr in _LOG_METHODS \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id.lstrip("_") in ("log", "logger"):
                what = f"a log call (.{fn.attr}())"
            else:
                continue
            yield self.finding(
                ctx, call,
                f"{what} inside code captured by {why}: it runs once at "
                f"capture and never in a replay — move it out of the "
                f"captured region")


@register
class HostSyncInCapturedCode(Rule):
    rule_id = "R6"
    severity = "error"
    description = ("host sync inside captured code: .item()/.cpu()/"
                   ".tolist()/.numpy()/float(tensor)/torch.cuda."
                   "synchronize fails a CUDA graph capture or breaks a "
                   "compiled graph")

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            why = ctx.in_traced(call)
            if not why:
                continue
            fn = call.func
            name = ctx.call_name(call)
            if name == "torch.cuda.synchronize" or (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "synchronize"):
                what = f"{name or '.synchronize'}()"
            elif isinstance(fn, ast.Attribute) \
                    and fn.attr in _SYNC_METHODS and not call.args:
                what = f".{fn.attr}()"
            elif name in _CAST_BUILTINS and call.args \
                    and not isinstance(call.args[0], ast.Constant):
                what = f"{name}() of a value"
            else:
                continue
            yield self.finding(
                ctx, call,
                f"{what} inside code captured by {why}: a device-to-host "
                f"sync cannot be captured (and breaks a compiled graph) — "
                f"return the tensor and read it after the replay")


def _capture_block(ctx: FileContext, node: ast.With) -> bool:
    for item in node.items:
        expr = item.context_expr
        name = ctx.resolve(expr.func if isinstance(expr, ast.Call)
                           else expr)
        if name in CAPTURE_CONTEXTS:
            return True
    return False


def _names_bound(stmts) -> Set[str]:
    out: Set[str] = set()
    for st in stmts:
        for node in ast.walk(st):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                out.add(node.id)
    return out


@register
class StaticOutputReadAfterReplay(Rule):
    rule_id = "R7"
    severity = "error"
    description = ("a captured graph's static output read after the next "
                   ".replay(): the replay overwrote it — clone outputs out "
                   "before replaying again")

    def check(self, ctx: FileContext):
        for fn in ctx.functions:
            static: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.With) and _capture_block(ctx, node):
                    static |= _names_bound(node.body)
            if not static:
                continue
            # statements in order: aliases of static outputs (no call on
            # the right-hand side), then a replay, then a read of an alias
            aliases: Dict[str, int] = {}
            replays = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in static:
                    aliases[node.targets[0].id] = node.lineno
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "replay":
                    replays.append(node.lineno)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)
                        and node.id in aliases):
                    continue
                bound = aliases[node.id]
                after = [r for r in replays if bound < r < node.lineno]
                if after:
                    yield self.finding(
                        ctx, node,
                        f"{node.id!r} aliases a static output of a "
                        f"captured graph (line {bound}) and is read after "
                        f"the replay at line {after[-1]}, which overwrote "
                        f"it — take .clone() of the output before the "
                        f"next replay")
