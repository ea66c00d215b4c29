"""Shape/dtype contracts for tensor-function signatures.

The port's copy of the JAX package's ``lint/contracts.py``: the same spec
grammar, the same errors, the same ``RAFT_TPU_CHECK_CONTRACTS`` switch.
A contract is a compact spec string attached to a parameter (or the
return value) of a tensor function:

    @contract(fmap1="f32[B,H,W,C]", coords="*[B,H,W,2]",
              _returns="f32[B,H,W,_]")
    def lookup(fmap1, coords): ...

Spec grammar: ``dtype[dim, dim, ...]`` where

* ``dtype`` is one of f16/bf16/f32/f64/i8/i32/i64/u8/u16/u32/bool, a
  ``|``-union of those, or ``*`` (any dtype); omitting it means any.  A
  ``torch.dtype`` and a numpy dtype of the same name both match.
* each ``dim`` is an uppercase symbol (bound consistently across every
  spec'd argument of ONE call — ``B`` must be the same batch everywhere),
  an integer literal (exact match), ``_`` (any single dim), or ``...``
  (any run of dims, at most once per spec).
* dotted names (``{"batch.image1": "..."}`` via the dict form) reach into
  attribute fields, e.g. a NamedTuple batch.

Specs are written in the port's own layouts (NHWC where the function
takes NHWC, as the port's public entry points do).  The decorator is
metadata-only by default — specs land on ``fn.__raftlint_contracts__``
where the static checker (lint rule R9) and ``python -m
raft_tpu_torch.tools.raftlint --contracts`` read them, and calls pass
straight through (one module-global test a call).  Call-time verification
switches on process-wide via ``enable_checking()`` /
``RAFT_TPU_CHECK_CONTRACTS=1``.  It reads only ``.shape`` and ``.dtype``,
never a value, so it adds no host sync; under CUDA graph capture it runs
when the graph is captured (and in its eager warm-up) and never in a
replay, which runs no Python — as the JAX package checks once per trace.

Pure stdlib at module scope: the linter can run the parser anywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import re
from typing import Dict, Optional, Tuple

_DTYPES = {"f16": "float16", "bf16": "bfloat16", "f32": "float32",
           "f64": "float64", "i8": "int8", "i32": "int32", "i64": "int64",
           "u8": "uint8", "u16": "uint16", "u32": "uint32", "bool": "bool"}

_SPEC_RE = re.compile(r"^\s*(?P<dtype>[A-Za-z0-9|*]+)?\s*"
                      r"\[(?P<dims>[^\]]*)\]\s*$")
_SYM_RE = re.compile(r"^[A-Z][A-Za-z0-9]*$")


class ContractError(ValueError):
    """A spec failed to parse, or a checked value violated its contract."""


@dataclasses.dataclass(frozen=True)
class Spec:
    dtypes: Optional[Tuple[str, ...]]    # canonical names, None = any
    dims: Tuple[object, ...]             # str symbol | int | "_" | "..."
    raw: str


def parse_spec(spec: str) -> Spec:
    """Parse ``"f32[B,H,W,2]"`` -> Spec; raise ContractError on bad syntax."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ContractError(f"bad contract spec {spec!r}: expected "
                            f"'dtype[dims]' like 'f32[B,H,W,2]'")
    dt = m.group("dtype")
    if dt is None or dt == "*":
        dtypes = None
    else:
        names = []
        for part in dt.split("|"):
            if part not in _DTYPES:
                raise ContractError(f"bad contract spec {spec!r}: unknown "
                                    f"dtype {part!r} (use {sorted(_DTYPES)})")
            names.append(_DTYPES[part])
        dtypes = tuple(names)
    dims = []
    body = m.group("dims").strip()
    for tok in ([t.strip() for t in body.split(",")] if body else []):
        if tok == "...":
            if "..." in dims:
                raise ContractError(f"bad contract spec {spec!r}: at most "
                                    f"one '...' per spec")
            dims.append("...")
        elif tok == "_":
            dims.append("_")
        elif tok.isdigit():
            dims.append(int(tok))
        elif _SYM_RE.match(tok):
            dims.append(tok)
        else:
            raise ContractError(f"bad contract spec {spec!r}: bad dim "
                                f"token {tok!r}")
    return Spec(dtypes, tuple(dims), spec)


_enabled = (os.environ.get("RAFT_TPU_CHECK_CONTRACTS", "").strip().lower()
            in ("1", "true", "yes", "on"))


def enable_checking(on: bool = True) -> None:
    """Turn trace-time contract verification on/off process-wide."""
    global _enabled
    _enabled = on


def checking_enabled() -> bool:
    return _enabled


def _dtype_name(dtype) -> str:
    """``torch.float32`` and numpy's ``float32`` alike -> ``"float32"``."""
    name = str(dtype)
    return name[6:] if name.startswith("torch.") else name


def _check_value(label: str, spec: Spec, val, bindings: Dict[str, int],
                 where: str) -> None:
    if val is None:
        return                      # optional args opt out via None
    shape = getattr(val, "shape", None)
    dtype = getattr(val, "dtype", None)
    if dtype is not None:
        dtype = _dtype_name(dtype)
    if shape is None:
        raise ContractError(f"{where}: {label} expected an array "
                            f"({spec.raw}), got {type(val).__name__}")
    if spec.dtypes is not None and str(dtype) not in spec.dtypes:
        raise ContractError(f"{where}: {label} dtype {dtype} violates "
                            f"{spec.raw}")
    dims = list(spec.dims)
    if "..." in dims:
        i = dims.index("...")
        head, tail = dims[:i], dims[i + 1:]
        if len(shape) < len(head) + len(tail):
            raise ContractError(f"{where}: {label} rank {len(shape)} too "
                                f"small for {spec.raw}")
        pairs = list(zip(head, shape[:len(head)])) + \
            list(zip(tail, shape[len(shape) - len(tail):]))
    else:
        if len(shape) != len(dims):
            raise ContractError(f"{where}: {label} rank {len(shape)} != "
                                f"{len(dims)} required by {spec.raw}")
        pairs = list(zip(dims, shape))
    for dim, size in pairs:
        size = int(size)
        if dim == "_":
            continue
        if isinstance(dim, int):
            if size != dim:
                raise ContractError(f"{where}: {label} shape {tuple(shape)} "
                                    f"violates {spec.raw} (dim {dim} != "
                                    f"{size})")
        elif dim in bindings:
            if bindings[dim] != size:
                raise ContractError(
                    f"{where}: {label} shape {tuple(shape)} violates "
                    f"{spec.raw}: {dim}={bindings[dim]} bound by an earlier "
                    f"argument, got {size}")
        else:
            bindings[dim] = size


_MISSING = object()


def _resolve_dotted(bound: Dict[str, object], name: str, where: str):
    parts = name.split(".")
    val = bound.get(parts[0], None)
    for p in parts[1:]:
        if val is None:
            return None                  # optional whole object (e.g. =None)
        nxt = getattr(val, p, _MISSING)
        if nxt is _MISSING:
            # a typo'd/renamed field must FAIL, not silently skip the check
            raise ContractError(
                f"{where}: contract {name!r} names attribute {p!r}, but "
                f"{type(val).__name__} has no such field — the contract "
                f"drifted from the code")
        val = nxt
    return val


def contract(_specs: Optional[Dict[str, str]] = None, **kw_specs):
    """Attach (and optionally enforce) shape/dtype specs to a function.

    Accepts specs as keyword arguments and/or a dict first argument (the
    dict form allows dotted names like ``"batch.image1"``).  The special
    key ``_returns`` specs the return value.
    """
    specs = {**(_specs or {}), **kw_specs}
    ret_spec = specs.pop("_returns", None)
    parsed = {k: parse_spec(v) for k, v in specs.items()}
    parsed_ret = parse_spec(ret_spec) if ret_spec is not None else None

    def deco(fn):
        sig = inspect.signature(fn)
        for name in parsed:
            base = name.split(".")[0]
            if base not in sig.parameters:
                raise ContractError(
                    f"contract on {fn.__qualname__}: no parameter {base!r} "
                    f"(has {list(sig.parameters)})")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            where = fn.__qualname__
            ba = sig.bind(*args, **kwargs)
            ba.apply_defaults()
            bindings: Dict[str, int] = {}
            for name, spec in parsed.items():
                _check_value(name, spec,
                             _resolve_dotted(ba.arguments, name, where),
                             bindings, where)
            out = fn(*args, **kwargs)
            if parsed_ret is not None:
                _check_value("return value", parsed_ret, out, bindings, where)
            return out

        wrapper.__raftlint_contracts__ = dict(specs)
        if ret_spec is not None:
            wrapper.__raftlint_contracts__["_returns"] = ret_spec
        return wrapper

    return deco
