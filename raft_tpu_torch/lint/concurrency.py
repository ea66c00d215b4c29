"""Concurrency guard annotations + the shared AST backbone of the C rules.

The port's copy of the JAX package's ``lint/concurrency.py``: the
:func:`guarded_by` annotation layer, the serving plane's declared lock
hierarchy and the class/lock analysis that rules C1-C6
(``lint/rules/c_concurrency.py``) and the runtime lock-order validator
(``telemetry/watchdogs.py``, ``RAFT_TPU_LOCK_WATCH=1``) agree on.

* **Annotations** (runtime, zero-cost): ``guarded_by("_lock")`` marks which
  lock protects an attribute (class-attribute form) or a whole method
  body (decorator form).  Neither costs anything at run time.
* **Analysis** (pure stdlib AST, never imports the scanned code): per
  class, the locks it declares, the attribute -> lock guard map
  (annotated, plus inferred from writes under ``with self._lock:``),
  every attribute write and increment with the locks held there, blocking
  calls and ``Condition.wait`` sites inside critical sections,
  check-then-act lazy inits, and the lock-acquisition edges of the
  cross-class lock-order graph.

The hierarchy gains the engine's device lock
(``InferenceEngine._device_lock``): a captured CUDA graph is not
re-entrant, so every device call of the engine (warmup's captures, the
batcher's replays, a reload's probe and weight copy) runs under it.  The
JAX engine's ``_spec_lock`` has no counterpart here.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["guarded_by", "SERVING_LOCK_HIERARCHY", "analyze_classes",
           "ClassConc", "AttrEvent", "render_threading_table"]


class _GuardSpec:
    """Sentinel returned by :func:`guarded_by` — usable both as a
    class-attribute value and as a method decorator."""

    __slots__ = ("lock",)

    def __init__(self, lock: str):
        self.lock = lock

    def __call__(self, fn):
        fn.__guarded_by__ = self.lock
        return fn

    def __repr__(self) -> str:
        return f"guarded_by({self.lock!r})"


def guarded_by(lock: str) -> _GuardSpec:
    """Declare that an attribute (class-attr form) or a whole method body
    (decorator form) is protected by ``self.<lock>``.  Pure metadata: at
    runtime the decorator returns the function unchanged and the class
    attribute is shadowed by the instance attribute ``__init__`` assigns."""
    return _GuardSpec(lock)


# The intended lock hierarchy of the serving plane, most-outer first: an
# acquisition edge that goes RIGHT → LEFT (e.g. taking the store lock while
# holding a session lock) is an inversion, flagged at runtime by
# telemetry/watchdogs.LockOrderValidator (armed via RAFT_TPU_LOCK_WATCH=1).
SERVING_LOCK_HIERARCHY: Tuple[str, ...] = (
    "FleetSessionMap._lock",      # router session table (lookup only; the
                                  # per-session lock is taken after release)
    "FleetSession.lock",          # held across a whole routed advance —
                                  # migration picks a replica under it
    "ReplicaManager._lock",       # replica table; a migrating advance asks
                                  # for a healthy replica while pinned
    "FleetRouter._lock",          # leaf of the fleet plane: in-flight
                                  # counters (taken after the manager view)
    "CircuitBreaker._lock",       # record() may demote ALL sessions (open)
    "SessionStore._lock",         # probes Session.lock.locked(), never takes
    "Session.lock",               # handler holds it across a whole advance
    "RequestQueue._lock",         # submit() runs under the session lock
    "InferenceEngine._device_lock",  # held across a whole device call (a
                                  # capture or a replay, a commit, a reload);
                                  # the locks below are taken inside it
    "InferenceEngine._lock",      # leaf: key-set bookkeeping and counters
    "FaultInjector._lock",        # leaf: chaos roll state
    "SlotPool._lock",             # leaf: slot free-list + buffer refs,
                                  # taken under the store lock on the
                                  # promote/demote/sweep paths
)


# ---------------------------------------------------------------------------
# AST analysis
# ---------------------------------------------------------------------------

_LOCK_FACTORIES = ("threading.Lock", "threading.RLock")
_COND_FACTORIES = ("threading.Condition",)

# Mutating container methods: a call like ``self._by_bucket.setdefault(...)``
# writes the attribute just as surely as ``self._by_bucket[k] = v``.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "update", "setdefault", "add", "sort",
    "move_to_end", "rotate",
})

# Calls that block (sleep, I/O, subprocess) — holding a lock across one
# serializes every other thread behind it (rule C2).
_BLOCKING_CALLS = frozenset({
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.request",
    "torch.cuda.synchronize",
})
# ``.block_until_ready()`` (the JAX spelling, kept so the two analyses
# agree on shared sources) and the port's CUDA event/stream waits
_BLOCKING_METHODS = frozenset({"block_until_ready", "synchronize"})

# Method names too generic to resolve a call receiver to one class (they
# collide with builtin container/IO methods); the cross-class lock graph
# only follows calls whose name maps to exactly one scanned class.
_AMBIGUOUS_METHODS = frozenset({
    "get", "pop", "clear", "update", "items", "keys", "values", "append",
    "add", "remove", "discard", "copy", "setdefault", "split", "join",
    "strip", "read", "write", "close", "open", "wait", "set", "acquire",
    "release", "locked", "put", "start", "run", "send",
})


@dataclasses.dataclass(frozen=True)
class AttrEvent:
    """One analysed site inside a method of a lock-holding class."""

    kind: str                 # write | aug | lazy | call | wait | method_call
    node: ast.AST
    fn_name: str
    held: FrozenSet[str]      # canonical lock names held at this point
    attr: Optional[str] = None        # self attribute written / waited on
    call_name: Optional[str] = None   # resolved dotted name (kind=call)
    method: Optional[str] = None      # receiver method name (method_call)


@dataclasses.dataclass
class ClassConc:
    """Concurrency view of one class: its locks, guard annotations, and
    every lock-relevant event in its method bodies."""

    name: str
    node: ast.ClassDef
    locks: Set[str] = dataclasses.field(default_factory=set)
    cond_alias: Dict[str, str] = dataclasses.field(default_factory=dict)
    conds: Set[str] = dataclasses.field(default_factory=set)
    annotated: Dict[str, str] = dataclasses.field(default_factory=dict)
    method_guard: Dict[str, str] = dataclasses.field(default_factory=dict)
    events: List[AttrEvent] = dataclasses.field(default_factory=list)

    def canonical(self, lock: str) -> str:
        """Condition attrs alias the lock they wrap (``Condition(self._lock)``
        acquires ``_lock``)."""
        return self.cond_alias.get(lock, lock)

    @property
    def lock_names(self) -> Set[str]:
        return {self.canonical(n) for n in self.locks}

    def guard_map(self) -> Dict[str, str]:
        """attr -> lock: explicit annotations win; otherwise an attribute
        written at least once while a lock is held is inferred guarded by
        it (the common ``with self._lock:`` idiom)."""
        inferred: Dict[str, str] = {}
        for ev in self.events:
            if ev.kind in ("write", "aug") and ev.attr and ev.held \
                    and ev.fn_name != "__init__":
                inferred.setdefault(ev.attr, sorted(ev.held)[0])
        inferred.update(self.annotated)
        return inferred


def _is_guarded_by_call(ctx, node: ast.AST) -> Optional[str]:
    """``guarded_by("_lock")`` (any import spelling) -> the lock name."""
    if not (isinstance(node, ast.Call) and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return None
    name = ctx.resolve(node.func)
    if name == "guarded_by" or (name or "").endswith(".guarded_by"):
        return node.args[0].value
    return None


def _lock_factory_kind(ctx, node: ast.AST) -> Optional[str]:
    """'lock' / 'cond' when ``node`` constructs one, else None.  The
    telemetry ``watched_lock(...)`` wrapper counts as a lock — the
    validator-instrumented serving locks must stay visible to the rules."""
    if not isinstance(node, ast.Call):
        return None
    name = ctx.resolve(node.func)
    if name in _LOCK_FACTORIES or (name or "").endswith(".watched_lock") \
            or name == "watched_lock":
        return "lock"
    if name in _COND_FACTORIES:
        return "cond"
    return None


def _self_attr(node: ast.AST, cls_name: str) -> Optional[str]:
    """``self.X`` (or ``ClassName.X`` for class-level locks) -> ``X``."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", cls_name):
        return node.attr
    return None


def _write_targets(node: ast.AST, cls_name: str) -> Iterable[str]:
    """Self attributes written by an assignment target (plain, subscript,
    starred, tuple)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _write_targets(elt, cls_name)
        return
    if isinstance(node, ast.Starred):
        yield from _write_targets(node.value, cls_name)
        return
    attr = _self_attr(node, cls_name)
    if attr is not None:
        yield attr
        return
    if isinstance(node, ast.Subscript):
        attr = _self_attr(node.value, cls_name)
        if attr is not None:
            yield attr


class _MethodWalker:
    """Walks one method body tracking the set of held locks (``with
    self._lock:`` blocks plus a ``@guarded_by`` seed), emitting AttrEvents.
    Nested function/lambda bodies are skipped: they execute later, when the
    lock is no longer (necessarily) held."""

    def __init__(self, ctx, cls: ClassConc, fn: ast.AST):
        self.ctx = ctx
        self.cls = cls
        self.fn = fn

    def run(self) -> None:
        held = frozenset()
        guard = self.cls.method_guard.get(self.fn.name)
        if guard:
            held = frozenset({self.cls.canonical(guard)})
        self._stmts(self.fn.body, held)

    # -- statement dispatch -------------------------------------------------

    def _stmts(self, stmts, held: FrozenSet[str]) -> None:
        for st in stmts:
            self._stmt(st, held)

    def _stmt(self, st: ast.AST, held: FrozenSet[str]) -> None:
        cls = self.cls
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                       # executes later; lock not held
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in st.items:
                attr = _self_attr(item.context_expr, cls.name)
                if attr is not None and (attr in cls.locks
                                         or attr in cls.cond_alias):
                    canon = cls.canonical(attr)
                    if held:
                        # nested acquisition: a lock-order-graph edge (or,
                        # when canon is already held, a self-deadlock — C3)
                        self._emit("acquire", st, held, attr=canon)
                    inner.add(canon)
                else:
                    self._expr(item.context_expr, held)
            self._stmts(st.body, frozenset(inner))
            return
        if isinstance(st, ast.If):
            self._lazy_init(st, held)
            self._expr(st.test, held)
            self._stmts(st.body, held)
            self._stmts(st.orelse, held)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter, held)
            for a in _write_targets(st.target, cls.name):
                self._emit("write", st, held, attr=a)
            self._stmts(st.body, held)
            self._stmts(st.orelse, held)
            return
        if isinstance(st, ast.While):
            self._expr(st.test, held)
            self._stmts(st.body, held)
            self._stmts(st.orelse, held)
            return
        if isinstance(st, ast.Try) or st.__class__.__name__ == "TryStar":
            self._stmts(st.body, held)
            for h in st.handlers:
                self._stmts(h.body, held)
            self._stmts(st.orelse, held)
            self._stmts(st.finalbody, held)
            return
        if isinstance(st, ast.Assign):
            for t in st.targets:
                for a in _write_targets(t, cls.name):
                    self._emit("write", st, held, attr=a)
            self._expr(st.value, held)
            return
        if isinstance(st, (ast.AnnAssign, ast.AugAssign)):
            kind = "aug" if isinstance(st, ast.AugAssign) else "write"
            for a in _write_targets(st.target, cls.name):
                self._emit(kind, st, held, attr=a)
            if st.value is not None:
                self._expr(st.value, held)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                for a in _write_targets(t, cls.name):
                    self._emit("write", st, held, attr=a)
            return
        # Expr / Return / Raise / Assert / ...: scan expressions for calls
        for child in ast.iter_child_nodes(st):
            self._expr(child, held)

    # -- expressions: calls (blocking / graph / mutators) -------------------

    def _expr(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if node is None or isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            self._call(node, held)
            for child in ast.iter_child_nodes(node):
                self._expr(child, held)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, held)

    def _call(self, call: ast.Call, held: FrozenSet[str]) -> None:
        cls = self.cls
        name = self.ctx.resolve(call.func)
        if name is not None:
            self._emit("call", call, held, call_name=name)
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            recv_attr = _self_attr(call.func.value, cls.name)
            # mutating container method on a self attribute = a write
            if recv_attr is not None and meth in _MUTATORS:
                self._emit("write", call, held, attr=recv_attr)
            # Condition.wait on one of OUR condition attributes
            if recv_attr is not None and meth == "wait" \
                    and recv_attr in cls.conds:
                self._emit("wait", call, held, attr=recv_attr)
            if meth in _BLOCKING_METHODS:
                self._emit("call", call, held, call_name=f".{meth}")
            # receiver-method call: raw material for the lock-order graph
            self._emit("method_call", call, held, method=meth)

    def _emit(self, kind, node, held, attr=None, call_name=None,
              method=None) -> None:
        self.cls.events.append(AttrEvent(
            kind=kind, node=node, fn_name=self.fn.name, held=held,
            attr=attr, call_name=call_name, method=method))

    # -- check-then-act lazy init -------------------------------------------

    def _lazy_init(self, st: ast.If, held: FrozenSet[str]) -> None:
        """``if self.X is None: self.X = ...`` and ``if k not in self.X:
        self.X[k] = ...`` outside any lock — two threads can interleave the
        check and the act (rule C5)."""
        attr = self._lazy_test_attr(st.test)
        if attr is None:
            return
        for sub in ast.walk(ast.Module(body=st.body, type_ignores=[])):
            if isinstance(sub, ast.Assign):
                targets = [a for t in sub.targets
                           for a in _write_targets(t, self.cls.name)]
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATORS:
                recv = _self_attr(sub.func.value, self.cls.name)
                targets = [recv] if recv else []
            else:
                continue
            if attr in targets:
                self._emit("lazy", st, held, attr=attr)
                return

    def _lazy_test_attr(self, test: ast.AST) -> Optional[str]:
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return None
        op = test.ops[0]
        if isinstance(op, ast.Is) and isinstance(test.comparators[0],
                                                 ast.Constant) \
                and test.comparators[0].value is None:
            return _self_attr(test.left, self.cls.name)
        if isinstance(op, ast.NotIn):
            return _self_attr(test.comparators[0], self.cls.name)
        return None


def analyze_classes(ctx) -> List[ClassConc]:
    """Concurrency analysis of every lock-holding class in ``ctx`` (a
    ``lint.engine.FileContext``).  Cached on the context — C1–C6 and the
    doc check share one pass."""
    cached = getattr(ctx, "_concurrency_classes", None)
    if cached is not None:
        return cached
    out: List[ClassConc] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cls = ClassConc(name=node.name, node=node)
        methods = []
        for st in node.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods.append(st)
                for dec in st.decorator_list:
                    lock = _is_guarded_by_call(ctx, dec)
                    if lock:
                        cls.method_guard[st.name] = lock
                continue
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                attr = st.targets[0].id
                lock = _is_guarded_by_call(ctx, st.value)
                if lock:
                    cls.annotated[attr] = lock
                    continue
                kind = _lock_factory_kind(ctx, st.value)
                if kind == "lock":          # class-level lock (shared)
                    cls.locks.add(attr)
        # instance locks: assignments anywhere in method bodies
        for fn in methods:
            for st in ast.walk(fn):
                if not isinstance(st, ast.Assign):
                    continue
                for t in st.targets:
                    attr = _self_attr(t, node.name)
                    if attr is None:
                        continue
                    kind = _lock_factory_kind(ctx, st.value)
                    if kind == "lock":
                        cls.locks.add(attr)
                    elif kind == "cond":
                        cls.conds.add(attr)
                        wrapped = (st.value.args
                                   and _self_attr(st.value.args[0],
                                                  node.name))
                        if wrapped:
                            cls.cond_alias[attr] = wrapped
                        else:
                            cls.locks.add(attr)   # bare Condition owns one
                    lock = _is_guarded_by_call(ctx, st.value)
                    if lock and fn.name == "__init__":
                        cls.annotated[attr] = lock
        if not (cls.locks or cls.cond_alias):
            continue                         # no declared shared state
        for fn in methods:
            _MethodWalker(ctx, cls, fn).run()
        out.append(cls)
    ctx._concurrency_classes = out
    return out


# ---------------------------------------------------------------------------
# cross-class lock-order graph (rule C3 + the runtime validator's static twin)
# ---------------------------------------------------------------------------

def build_lock_graph(all_classes: Sequence[Tuple["object", ClassConc]]):
    """(ctx, class) pairs -> (edges, acquirers).

    ``edges`` is a list of ``(src, dst, node, path)`` where src/dst are
    ``"Class.lock"`` node names: either a nested ``with`` inside an already
    held region, or a call — made while holding src — to a method that
    (unambiguously, by name across the scan set) acquires dst.  Methods
    tagged ``@guarded_by`` are not acquirers: they *require* the lock.
    """
    acquirers: Dict[str, Set[Tuple[str, str]]] = {}
    for _ctx, cls in all_classes:
        for ev in cls.events:
            if not ev.held:
                continue
            if cls.method_guard.get(ev.fn_name):
                continue                  # requires the lock, not acquires
            for lock in ev.held:
                acquirers.setdefault(ev.fn_name, set()).add(
                    (cls.name, f"{cls.name}.{lock}"))
    unique = {m: next(iter(v)) for m, v in acquirers.items()
              if len(v) == 1 and m not in _AMBIGUOUS_METHODS
              and not m.startswith("__")}

    edges = []
    for ctx, cls in all_classes:
        for ev in cls.events:
            if not ev.held:
                continue
            held_nodes = {f"{cls.name}.{n}" for n in ev.held}
            target = None
            if ev.kind == "acquire":           # nested ``with self.B:``
                target = f"{cls.name}.{ev.attr}"
            elif ev.kind == "method_call" and ev.method in unique:
                _tcls, target = unique[ev.method]
            if target is None:
                continue
            for src in sorted(held_nodes):
                if src != target:
                    edges.append((src, target, ev.node, ctx.path))
    return edges, unique


def find_cycles(edges) -> List[Tuple[Tuple[str, ...], ast.AST, str]]:
    """Unique cycles in the edge list -> (cycle node path, witness AST node,
    file path) — the witness is the edge that closes the cycle."""
    graph: Dict[str, Set[str]] = {}
    for src, dst, _n, _p in edges:
        graph.setdefault(src, set()).add(dst)

    def path_to(src: str, dst: str) -> Optional[List[str]]:
        stack, seen = [(src, [src])], set()
        while stack:
            cur, path = stack.pop()
            if cur == dst:
                return path
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in sorted(graph.get(cur, ())):
                stack.append((nxt, path + [nxt]))
        return None

    cycles, reported = [], set()
    for src, dst, node, path in sorted(
            edges, key=lambda e: (e[3], getattr(e[2], "lineno", 0))):
        back = path_to(dst, src)
        if back is None:
            continue
        cycle = (src,) + tuple(back)          # src -> dst -> ... -> src
        key = frozenset(back)
        if key in reported:
            continue
        reported.add(key)
        cycles.append((cycle, node, path))
    return cycles


def hierarchy_rank(name: str) -> Optional[int]:
    """Rank of a ``Class.lock`` node in the declared serving hierarchy."""
    try:
        return SERVING_LOCK_HIERARCHY.index(name)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# SERVING.md "Threading model" generated table
# ---------------------------------------------------------------------------

def render_threading_table(paths: Sequence[str]) -> str:
    """Markdown table of every lock in the scanned tree and the attributes
    it guards (annotated ∪ inferred) — pasted between the
    ``<!-- lock-table:start/end -->`` markers in SERVING.md and
    regenerated by the doc test, so the doc can never drift from the
    annotations."""
    from .engine import FileContext, iter_python_files
    rows = []
    for f in iter_python_files(paths):
        ctx = FileContext(str(f), f.read_text(encoding="utf-8"))
        for cls in analyze_classes(ctx):
            guards: Dict[str, List[str]] = {}
            for attr, lock in sorted(cls.guard_map().items()):
                guards.setdefault(cls.canonical(lock), []).append(attr)
            for lock in sorted(cls.lock_names):
                attrs = guards.get(lock, [])
                rows.append((f"{cls.name}.{lock}", attrs))
    lines = ["| lock | guards |", "|---|---|"]
    for name, attrs in sorted(rows):
        lines.append("| `%s` | %s |" % (
            name, ", ".join(f"`{a}`" for a in attrs) or "—"))
    return "\n".join(lines)
