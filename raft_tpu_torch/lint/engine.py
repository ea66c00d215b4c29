"""raftlint engine for the port: AST-based hazard analysis with a rule
registry.

The port's copy of the JAX package's ``lint/engine.py``.  Pure stdlib —
scanned modules are parsed, never imported.  Rules live in
``raft_tpu_torch/lint/rules/`` and self-register via ``@register``; each
receives a :class:`FileContext` (parsed tree + import-alias resolution +
captured-region analysis) and yields :class:`Finding`s.

Suppression: append ``# raftlint: disable=R3`` (comma list, or ``all``) to
the offending line, or put ``# raftlint: disable-file=R3`` on its own line
anywhere in the file to silence a rule file-wide.

The captured-region analysis is the port's counterpart of the JAX
engine's traced-function analysis: a function counts as *captured* when
it is passed (by name, or through ``functools.partial``) to, or decorated
by, something that records it rather than running it as Python each call
— a CUDA graph capture (``GraphedForward``, ``torch.cuda.
make_graphed_callables``), ``torch.compile``, ``torch.jit``, the
``torch.func`` transforms, or ``torch.utils.checkpoint`` (whose body runs
again in the backward) — and every statement lexically inside a ``with
torch.cuda.graph(...):`` block is captured too.  There, a host sync
raises (or breaks the capture) and a Python side effect runs once at
capture and never in a replay.  The JAX engine's attribute names
(``traced``, ``in_traced``) are kept so rules port unchanged.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

SUPPRESS_RE = re.compile(
    r"#\s*raftlint:\s*(?P<kind>disable|disable-file)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*|all)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule_id: str
    severity: str            # "error" | "warning"
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule_id} "
                f"[{self.severity}] {self.message}")


class Rule:
    """Base class: subclasses set rule_id/severity/description and implement
    ``check(ctx) -> iterable of Finding``."""

    rule_id: str = ""
    severity: str = "error"
    description: str = ""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str,
                severity: Optional[str] = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), self.rule_id,
                       severity or self.severity, message)


class GlobalRule(Rule):
    """A rule over the whole scan set, for analyses that cross file
    boundaries (the C3 lock-order graph: the batcher acquires in one file
    what the session store acquires in another).  Implement ``check_all``;
    single-file scans (``scan_source``) fall back to it with a one-file
    set, so fixtures and tests exercise the same code path."""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        return self.check_all([ctx])

    def check_all(self, ctxs: Sequence["FileContext"]) -> Iterable[Finding]:
        raise NotImplementedError


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    inst = cls()
    assert inst.rule_id and inst.rule_id not in RULES, inst.rule_id
    RULES[inst.rule_id] = inst
    return cls


# Callables whose function-valued arguments run captured (recorded once,
# replayed without Python) or re-run by a transform.  Value = indices of
# the function-valued positional args.  The port's own capture classes
# are listed under every import spelling, since names resolve to the
# module tail of a relative import.
TRACE_ENTRIES: Dict[str, Sequence[int]] = {
    "torch.compile": (0,), "torch.jit.script": (0,), "torch.jit.trace": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.func.grad": (0,), "torch.func.grad_and_value": (0,),
    "torch.func.vmap": (0,), "torch.vmap": (0,), "torch.func.jacrev": (0,),
    "torch.func.jacfwd": (0,),
    "torch.utils.checkpoint.checkpoint": (0,),
    "raft_tpu_torch.models.capture.GraphedForward": (0,),
    "models.capture.GraphedForward": (0,),
    "capture.GraphedForward": (0,),
    "GraphedForward": (0,),
}

# The context manager whose body is recorded into a CUDA graph.
CAPTURE_CONTEXTS = ("torch.cuda.graph",)

# Factories whose product is a captured entry point on the card (the
# counterpart of the JAX engine's jit wrappers, rule B1): the model's
# factories and GraphedForward matched on the last component of the
# resolved call name (they are imported under many spellings), and
# torch.compile by its full name.
JIT_WRAPPERS = ("make_inference_fn", "make_ragged_inference_fn",
                "make_counted_inference_fn",
                "make_ragged_counted_inference_fn", "make_encode_fn",
                "make_stream_step_fn", "make_stream_batch_step_fn",
                "make_ragged_stream_step_fn",
                "make_ragged_stream_batch_step_fn", "GraphedForward",
                "torch.compile")


def is_captured_factory(name: Optional[str]) -> bool:
    """True when a resolved call name builds a captured entry point."""
    return bool(name) and (name == "torch.compile"
                           or name.rsplit(".", 1)[-1] in JIT_WRAPPERS)


class FileContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self._calls: Optional[List[ast.Call]] = None
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self.aliases = self._collect_aliases()
        self.imports_torch = any(a.split(".")[0] == "torch"
                                 for a in self.aliases.values())
        self._line_suppress, self._file_suppress = self._collect_suppressions()
        self.functions = [n for n in ast.walk(self.tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        self.traced: Dict[ast.AST, str] = self._find_traced()

    # ---------------- imports / name resolution ----------------

    def _collect_aliases(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[(a.asname or a.name.split(".")[0])] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                # level > 0 (relative) maps to the module TAIL — consumers
                # match full canonical names or ".suffix" endings, so a
                # tail like "lint.contracts.contract" still resolves
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain, e.g.
        ``F.relu`` -> ``torch.nn.functional.relu``; None if not a plain
        chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.resolve(call.func)

    # ---------------- structure helpers ----------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_functions(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                yield cur
            cur = self._parents.get(cur)

    def in_traced(self, node: ast.AST) -> Optional[str]:
        """Reason string if ``node`` sits inside a captured function or a
        ``with torch.cuda.graph(...):`` block."""
        for fn in self.enclosing_functions(node):
            if fn in self.traced:
                return self.traced[fn]
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    expr = item.context_expr
                    name = self.resolve(expr.func if isinstance(
                        expr, ast.Call) else expr)
                    if name in CAPTURE_CONTEXTS:
                        return f"`with {name}(...)`"
            cur = self._parents.get(cur)
        return None

    def calls(self, root: Optional[ast.AST] = None) -> Iterator[ast.Call]:
        if root is None:
            # the whole file's calls, listed once: every rule asks
            if self._calls is None:
                self._calls = [n for n in ast.walk(self.tree)
                               if isinstance(n, ast.Call)]
            return iter(self._calls)
        return (n for n in ast.walk(root) if isinstance(n, ast.Call))

    # ---------------- traced-function analysis ----------------

    def _decorator_traces(self, dec: ast.AST) -> Optional[str]:
        name = self.resolve(dec)
        if name in TRACE_ENTRIES:
            return name
        if isinstance(dec, ast.Call):
            fname = self.resolve(dec.func)
            if fname in TRACE_ENTRIES:
                return fname
            # @functools.partial(torch.compile, ...) and friends
            if fname in ("functools.partial", "partial") and dec.args:
                inner = self.resolve(dec.args[0])
                if inner in TRACE_ENTRIES:
                    return inner
        return None

    def _find_traced(self) -> Dict[ast.AST, str]:
        by_name: Dict[str, List[ast.AST]] = {}
        for fn in self.functions:
            by_name.setdefault(fn.name, []).append(fn)
        traced: Dict[ast.AST, str] = {}
        for fn in self.functions:
            for dec in fn.decorator_list:
                why = self._decorator_traces(dec)
                if why:
                    traced[fn] = f"@{why}"
        for call in self.calls():
            cname = self.call_name(call)
            if cname not in TRACE_ENTRIES:
                continue
            for idx in TRACE_ENTRIES[cname]:
                if idx >= len(call.args):
                    continue
                arg = call.args[idx]
                # f passed by name, or functools.partial(f, ...)
                names: List[str] = []
                if isinstance(arg, ast.Name):
                    names.append(arg.id)
                elif isinstance(arg, ast.Call):
                    inner = self.resolve(arg.func)
                    if inner in ("functools.partial", "partial") and arg.args \
                            and isinstance(arg.args[0], ast.Name):
                        names.append(arg.args[0].id)
                for n in names:
                    for fn in by_name.get(n, []):
                        traced.setdefault(fn, cname)
        return traced

    # ---------------- suppression ----------------

    def _collect_suppressions(self):
        """Only real COMMENT tokens count: a directive spelled inside a
        docstring or string literal (e.g. documentation examples) must not
        disable anything — otherwise any scanned file could defeat the CI
        gate from inside a string.  Rides :func:`iter_suppressions` (the
        same parser behind the CLI's --list-suppressions audit), so what
        the engine honors and what the audit reports can never drift."""
        line_sup: Dict[int, Set[str]] = {}
        file_sup: Set[str] = set()
        for lineno, kind, ids, _text in iter_suppressions(self.source):
            if kind == "disable-file":
                file_sup |= set(ids)
            else:
                line_sup.setdefault(lineno, set()).update(ids)
        return line_sup, file_sup

    def is_suppressed(self, finding: Finding) -> bool:
        if "all" in self._file_suppress or \
                finding.rule_id in self._file_suppress:
            return True
        ids = self._line_suppress.get(finding.line, ())
        return "all" in ids or finding.rule_id in ids


def contract_decorator_specs(ctx: FileContext, fn: ast.AST):
    """Yield (decorator_call, {spec_name: value_node}) for every
    ``@contract(...)`` decorator on ``fn`` — kwargs and dict-form alike,
    aliased imports included.  Shared by rule R9 and the CLI's
    ``--contracts`` listing so the two can never drift apart."""
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        name = ctx.resolve(dec.func)
        if name is None or not (name == "contract"
                                or name.endswith(".contract")):
            continue
        specs: Dict[str, ast.AST] = {}
        for kw in dec.keywords:
            if kw.arg is not None:
                specs[kw.arg] = kw.value
        if dec.args and isinstance(dec.args[0], ast.Dict):
            for k, v in zip(dec.args[0].keys, dec.args[0].values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    specs[k.value] = v
        yield dec, specs


def _ensure_rules_loaded() -> None:
    if not RULES:
        from . import rules  # noqa: F401 — registers on import
    assert RULES, "no lint rules registered"


def active_rules(select: Optional[Sequence[str]] = None,
                 ignore: Optional[Sequence[str]] = None) -> List[Rule]:
    _ensure_rules_loaded()
    chosen = [RULES[r] for r in sorted(RULES)]
    if select:
        unknown = set(select) - set(RULES)
        if unknown:
            raise KeyError(f"unknown rule id(s) {sorted(unknown)}; "
                           f"known: {sorted(RULES)}")
        chosen = [r for r in chosen if r.rule_id in select]
    if ignore:
        chosen = [r for r in chosen if r.rule_id not in ignore]
    return chosen


def scan_source(source: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source string; returns unsuppressed findings, sorted."""
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, e.offset or 0, "E999", "error",
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in active_rules(select, ignore):
        for f in rule.check(ctx):
            if not ctx.is_suppressed(f):
                findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule_id))


def iter_python_files(paths: Sequence[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in sorted(path.rglob("*.py")):
                if not any(part.startswith(".") or part == "__pycache__"
                           for part in f.parts):
                    yield f
        elif path.suffix == ".py":
            yield path


def scan_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every .py file under ``paths`` (files or directories).
    Per-file rules run per context; :class:`GlobalRule`s run once over the
    whole context set (cross-file analysis sees every file of the scan)."""
    findings: List[Finding] = []
    ctxs: List[FileContext] = []
    for f in iter_python_files(paths):
        try:
            ctxs.append(FileContext(str(f), f.read_text(encoding="utf-8")))
        except SyntaxError as e:
            findings.append(Finding(str(f), e.lineno or 1, e.offset or 0,
                                    "E999", "error",
                                    f"syntax error: {e.msg}"))
    by_path = {ctx.path: ctx for ctx in ctxs}
    for rule in active_rules(select, ignore):
        if isinstance(rule, GlobalRule):
            produced = rule.check_all(ctxs)
        else:
            produced = (f for ctx in ctxs for f in rule.check(ctx))
        for f in produced:
            ctx = by_path.get(f.path)
            if ctx is None or not ctx.is_suppressed(f):
                findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule_id))


def iter_suppressions(source: str):
    """Yield ``(lineno, kind, rule_ids, comment_text)`` for every raftlint
    suppression directive in ``source`` — real comment tokens only (same
    contract as the engine's own suppression pass).  Backs the CLI's
    ``--list-suppressions`` audit report."""
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for lineno, text in comments:
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = ("all",) if m.group("rules") == "all" else \
            tuple(sorted(r.strip() for r in m.group("rules").split(",")))
        yield lineno, m.group("kind"), ids, text.strip()
