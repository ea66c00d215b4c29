"""C1–C6: lock-discipline static analysis for threaded classes.

The serving plane (SERVING.md "Threading model") shares mutable state
between HTTP handler threads, the device-owning batcher thread and the
supervisor; a missed lock there is a dropped metric increment, a torn
cache entry, or a deadlock that only fires under a fault storm.  These
rules are scoped to **lock-holding classes** — declaring a
``threading.Lock``/``Condition`` (or the watchdog-wrapped
``watched_lock``) is the class's own statement that its state is shared —
so single-threaded code never pays a false positive.

All six share one analysis backbone (:mod:`raft_tpu_torch.lint.concurrency`):
per-class locks, the attribute → lock guard map (``guarded_by``
annotations plus inference from ``with self._lock:`` bodies), and every
attribute write / blocking call / wait / lazy init with the set of locks
held at that point.  The runtime counterpart — the lock-order validator
in ``telemetry/watchdogs.py`` (``RAFT_TPU_LOCK_WATCH=1``) — catches the
dynamic edges (callbacks, cross-object locks) this static pass cannot.

* **C1** — write to a guarded attribute without its lock held.
* **C2** — blocking call (sleep, subprocess, HTTP/socket I/O, device
  ``.block_until_ready()``, ``torch.cuda.synchronize``, an event or stream
  ``.synchronize()``) inside a critical section.
* **C3** — lock-order-graph cycle across classes (GlobalRule: edges are
  extracted repo-wide), plus inversions of the declared serving
  hierarchy and self-deadlocks (re-acquiring a held non-reentrant lock).
* **C4** — ``Condition.wait`` outside a predicate ``while`` loop
  (wakeups are spurious and racy; an ``if`` re-checks nothing).
* **C5** — non-atomic check-then-act lazy init (``if self.x is None:
  self.x = ...`` outside the lock).
* **C6** — unsynchronized ``+=`` on an attribute of a lock-holding class
  (increments are read-modify-write: concurrent ones drop counts).
"""

from __future__ import annotations

import ast
from typing import Sequence

from .. import concurrency as conc
from ..engine import FileContext, Finding, GlobalRule, Rule, register


def _lock_classes(ctx: FileContext):
    return conc.analyze_classes(ctx)


@register
class UnguardedSharedWrite(Rule):
    rule_id = "C1"
    severity = "error"
    description = ("write to a lock-guarded attribute without holding its "
                   "lock (guard map: guarded_by annotations + inference "
                   "from `with self._lock:` bodies)")

    def check(self, ctx: FileContext):
        for cls in _lock_classes(ctx):
            guards = cls.guard_map()
            for ev in cls.events:
                if ev.kind not in ("write", "aug") or ev.attr not in guards:
                    continue
                if ev.fn_name == "__init__":
                    continue        # construction happens-before publication
                lock = cls.canonical(guards[ev.attr])
                if lock in ev.held:
                    continue
                how = ("annotated guarded_by"
                       if ev.attr in cls.annotated else
                       "written elsewhere under")
                yield self.finding(
                    ctx, ev.node,
                    f"{cls.name}.{ev.attr} is {how} `{lock}` but this "
                    f"write in {ev.fn_name}() does not hold it — wrap in "
                    f"`with self.{lock}:` (or @guarded_by({lock!r}) the "
                    f"method if callers always hold it)")


@register
class BlockingCallUnderLock(Rule):
    rule_id = "C2"
    severity = "error"
    description = ("blocking call (sleep / subprocess / HTTP / socket / "
                   ".block_until_ready()) while holding a lock serializes "
                   "every other thread behind the slow operation")

    def check(self, ctx: FileContext):
        for cls in _lock_classes(ctx):
            for ev in cls.events:
                if not ev.held:
                    continue
                if ev.kind == "call" and ev.call_name and (
                        ev.call_name in conc._BLOCKING_CALLS
                        or ev.call_name.startswith(".")):
                    yield self.finding(
                        ctx, ev.node,
                        f"blocking call {ev.call_name.lstrip('.')} in "
                        f"{cls.name}.{ev.fn_name}() while holding "
                        f"{sorted(ev.held)} — move it outside the critical "
                        f"section (compute, then publish under the lock)")
                elif ev.kind == "wait":
                    # waiting on OUR condition is the protocol — but only
                    # with exactly its own lock held; a second held lock
                    # stays held for the whole wait
                    own = cls.canonical(ev.attr)
                    others = set(ev.held) - {own}
                    if others:
                        yield self.finding(
                            ctx, ev.node,
                            f"{cls.name}.{ev.fn_name}() waits on "
                            f"self.{ev.attr} while also holding "
                            f"{sorted(others)} — the extra lock blocks "
                            f"every other thread for the full wait")


@register
class LockOrderCycle(GlobalRule):
    rule_id = "C3"
    severity = "error"
    description = ("lock-order hazard: acquisition cycle across classes, "
                   "an inversion of the declared serving hierarchy "
                   "(lint.concurrency.SERVING_LOCK_HIERARCHY), or "
                   "re-acquiring a held non-reentrant lock")

    def check_all(self, ctxs: Sequence[FileContext]):
        all_classes = [(ctx, cls) for ctx in ctxs
                       for cls in _lock_classes(ctx)]
        edges, _ = conc.build_lock_graph(all_classes)
        # self-deadlock: taking a lock this thread already holds
        for ctx, cls in all_classes:
            for ev in cls.events:
                if ev.kind == "acquire" and ev.attr in ev.held:
                    yield self.finding(
                        ctx, ev.node,
                        f"{cls.name}.{ev.fn_name}() re-acquires "
                        f"self.{ev.attr} while already holding it — a "
                        f"non-reentrant Lock deadlocks here")
        # declared-hierarchy inversions (cheap, catches the cycle BEFORE
        # the second edge lands in a later PR)
        for src, dst, node, path in edges:
            rs, rd = conc.hierarchy_rank(src), conc.hierarchy_rank(dst)
            if rs is not None and rd is not None and rd < rs:
                yield Finding(
                    path, getattr(node, "lineno", 1),
                    getattr(node, "col_offset", 0), self.rule_id,
                    self.severity,
                    f"lock-order inversion: {dst} acquired while holding "
                    f"{src}, but the declared serving hierarchy "
                    f"(SERVING.md threading model) orders {dst} before "
                    f"{src}")
        for cycle, node, path in conc.find_cycles(edges):
            yield Finding(
                path, getattr(node, "lineno", 1),
                getattr(node, "col_offset", 0), self.rule_id, self.severity,
                f"lock-order cycle: {' -> '.join(cycle)} — two threads "
                f"entering from different ends deadlock; acquire in one "
                f"global order (see SERVING.md threading model)")


@register
class WaitWithoutPredicateLoop(Rule):
    rule_id = "C4"
    severity = "error"
    description = ("Condition.wait outside a `while <predicate>` loop: "
                   "wakeups are spurious and racy — an `if` (or no check) "
                   "proceeds on stale state")

    def check(self, ctx: FileContext):
        for cls in _lock_classes(ctx):
            for ev in cls.events:
                if ev.kind != "wait":
                    continue
                if self._in_while(ctx, ev.node):
                    continue
                yield self.finding(
                    ctx, ev.node,
                    f"self.{ev.attr}.wait() in {cls.name}.{ev.fn_name}() "
                    f"is not inside a `while` predicate loop — re-check "
                    f"the condition after every wakeup: "
                    f"`while not <ready>: self.{ev.attr}.wait()`")

    @staticmethod
    def _in_while(ctx: FileContext, node: ast.AST) -> bool:
        cur = ctx.parent(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if isinstance(cur, ast.While):
                return True
            cur = ctx.parent(cur)
        return False


@register
class CheckThenActLazyInit(Rule):
    rule_id = "C5"
    severity = "error"
    description = ("non-atomic check-then-act lazy init on a lock-holding "
                   "class: two threads pass the check, both act — torn "
                   "caches, duplicate construction")

    def check(self, ctx: FileContext):
        for cls in _lock_classes(ctx):
            for ev in cls.events:
                if ev.kind != "lazy" or ev.held:
                    continue
                if ev.fn_name == "__init__":
                    continue
                yield self.finding(
                    ctx, ev.node,
                    f"check-then-act init of {cls.name}.{ev.attr} in "
                    f"{ev.fn_name}() without a lock: two threads can both "
                    f"pass the check and both insert — take the lock "
                    f"around check+act, or use a setdefault/get_or_* "
                    f"atomic (telemetry.registry.Registry.get_or_counter "
                    f"is the house pattern)")


@register
class UnsynchronizedIncrement(Rule):
    rule_id = "C6"
    severity = "error"
    description = ("unsynchronized `+=` on an attribute of a lock-holding "
                   "class: read-modify-write races drop increments (the "
                   "metrics-bearing counters back acceptance observables)")

    def check(self, ctx: FileContext):
        for cls in _lock_classes(ctx):
            guards = cls.guard_map()
            for ev in cls.events:
                if ev.kind != "aug" or ev.held or ev.fn_name == "__init__":
                    continue
                if ev.attr in guards:
                    continue         # C1 already reports guarded attrs
                yield self.finding(
                    ctx, ev.node,
                    f"unsynchronized increment of {cls.name}.{ev.attr} in "
                    f"{ev.fn_name}(): `+=` is a read-modify-write; under "
                    f"threads increments are lost — move it under the "
                    f"class lock or count on a telemetry Counter "
                    f"(lock-guarded inc)")
