"""R9: contract-spec validity (the static half of lint/contracts.py).

``@contract(...)`` specs are strings; a typo'd spec or a spec naming a
parameter that was since renamed would otherwise rot silently until the
(optional, off-by-default) call-time checker is enabled.  This rule parses
every spec at lint time and cross-checks spec'd names against the actual
function signature — so contract drift fails CI, not a debugging session.
"""

from __future__ import annotations

import ast

from ..contracts import ContractError, parse_spec
from ..engine import FileContext, Rule, contract_decorator_specs, register


@register
class ContractSpecValidity(Rule):
    rule_id = "R9"
    severity = "error"
    description = ("invalid @contract: spec string fails to parse, or "
                   "names a parameter missing from the signature")

    def check(self, ctx: FileContext):
        for fn in ctx.functions:
            params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)}
            if fn.args.vararg or fn.args.kwarg:
                params = None            # can't enumerate — skip name check
            for _dec, specs in contract_decorator_specs(ctx, fn):
                for pname, vnode in specs.items():
                    if not (isinstance(vnode, ast.Constant)
                            and isinstance(vnode.value, str)):
                        continue         # computed spec — runtime's problem
                    try:
                        parse_spec(vnode.value)
                    except ContractError as e:
                        yield self.finding(ctx, vnode, str(e))
                        continue
                    base = pname.split(".")[0]
                    if pname != "_returns" and params is not None \
                            and base not in params:
                        yield self.finding(
                            ctx, vnode,
                            f"@contract on {fn.name}() specs parameter "
                            f"{base!r}, but the signature has "
                            f"{sorted(params)} — the contract drifted from "
                            f"the code")
