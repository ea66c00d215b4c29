"""R10: bare ``print()`` in library modules.

Library code under ``raft_tpu_torch/`` prints from serving threads,
data-loader workers and training loops — output that callers cannot
redirect, capture or silence, and that corrupts machine-readable stdout
(the bench tools print JSON lines another program parses).  Library
messages must route through a ``log_fn`` parameter or
:func:`raft_tpu_torch.telemetry.log.get_logger`.

CLI surfaces keep printing — stdout is their product.  A call site is
exempt when any of these hold:

* the file is a script (has a top-level ``if __name__ == "__main__"``
  guard) or is named ``cli.py`` — covers ``raft_tpu_torch/cli.py`` and every
  ``tools/`` entry point (``python -m`` modules with a main guard);
* an enclosing function is named ``main`` or ends with ``_cli`` (the CLI
  handler convention: ``train_cli``, ``evaluate_cli``, ``serve_cli``);
* the call is inside traced code — that hazard class belongs to R1
  (trace-time side effect), not to this rule.
"""

from __future__ import annotations

import ast
from pathlib import PurePath

from ..engine import FileContext, Rule, register


def _is_script(ctx: FileContext) -> bool:
    """Top-level ``if __name__ == "__main__":`` marks an entry-point file."""
    for node in ctx.tree.body:
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if isinstance(test, ast.Compare) and \
                isinstance(test.left, ast.Name) and \
                test.left.id == "__name__":
            return True
    return False


def _in_cli_function(ctx: FileContext, node: ast.AST) -> bool:
    for fn in ctx.enclosing_functions(node):
        name = getattr(fn, "name", "")
        if name == "main" or name.endswith("_cli"):
            return True
    return False


@register
class BarePrintInLibraryCode(Rule):
    rule_id = "R10"
    severity = "error"
    description = ("bare print() in library code: route through a log_fn "
                   "parameter or raft_tpu_torch.telemetry.log (cli/tools "
                   "entry points exempt)")

    def check(self, ctx: FileContext):
        if PurePath(ctx.path).name == "cli.py" or _is_script(ctx):
            return
        for call in ctx.calls():
            if ctx.resolve(call.func) != "print":
                continue
            if ctx.in_traced(call):      # R1's domain: trace-time effect
                continue
            if _in_cli_function(ctx, call):
                continue
            yield self.finding(
                ctx, call,
                "bare print() in library code: callers cannot redirect or "
                "silence it, and it corrupts machine-readable stdout — "
                "take a log_fn parameter or use "
                "raft_tpu_torch.telemetry.log.get_logger")
