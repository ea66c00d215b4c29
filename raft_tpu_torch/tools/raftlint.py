"""raftlint for the port: scan ``raft_tpu_torch/`` for its hazards, and its
static capacity report (lint/RULES.md).

    python -m raft_tpu_torch.tools.raftlint                # scan, report
    python -m raft_tpu_torch.tools.raftlint --strict       # exit 1 on a new finding
    python -m raft_tpu_torch.tools.raftlint path/to/file.py --select R3,C1
    python -m raft_tpu_torch.tools.raftlint --list-rules
    python -m raft_tpu_torch.tools.raftlint --contracts    # @contract'd signatures
    python -m raft_tpu_torch.tools.raftlint --diff [REV]   # changed files only
    python -m raft_tpu_torch.tools.raftlint --write-baseline
    python -m raft_tpu_torch.tools.raftlint --list-suppressions
    python -m raft_tpu_torch.tools.raftlint --budget [--strict] [--json] \\
        [--device-kind h100-80gb] [--serve-args "--buckets 432x1024"]

The port's copy of the JAX package's ``tools/raftlint.py``.  The scan is
pure stdlib + AST: nothing of the scanned tree is imported.  The committed
baseline (``raft_tpu_torch/lint/LINT_BASELINE.json``), whose every entry
carries the reason it is accepted, applies in every scan mode
(``--no-baseline`` turns it off); fingerprints are (path, rule, stripped
source line).  ``--budget`` imports torch and the port (no device, no
compile): the warmup grid, the device memory from the factories on fake
tensors, the graph pools, and the kernels' shared-memory, thread and
register envelopes against the H100's limits; ``--strict`` fails on a
violation or when the grid grew past the committed
``raft_tpu_torch/lint/BUDGET.json`` for the same configuration.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from ..lint import engine

PORT_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PORT_ROOT.parent
DEFAULT_BASELINE = PORT_ROOT / "lint" / "LINT_BASELINE.json"
DEFAULT_BUDGET_BASELINE = PORT_ROOT / "lint" / "BUDGET.json"


def _list_rules() -> None:
    engine.active_rules()
    for rid in sorted(engine.RULES):
        rule = engine.RULES[rid]
        print(f"{rid}  [{rule.severity}]  {rule.description}")


def _dump_contracts(paths) -> None:
    # rides the same FileContext + contract_decorator_specs helper as lint
    # rule R9, so the listing and the validity check can never disagree on
    # what counts as a contract (aliased imports included)
    for f in engine.iter_python_files(paths):
        ctx = engine.FileContext(str(f), f.read_text(encoding="utf-8"))
        for node in ctx.functions:
            for _dec, specs in engine.contract_decorator_specs(ctx, node):
                rendered = {k: getattr(v, "value", "?")
                            for k, v in specs.items()}
                print(f"{f}:{node.lineno}: {node.name}  "
                      + "  ".join(f"{k}={v!r}"
                                  for k, v in rendered.items()))


def _git(*argv: str):
    """Run git in the repo root; (returncode, stdout)."""
    r = subprocess.run(["git", *argv], capture_output=True, text=True,
                       cwd=str(REPO_ROOT))
    return r.returncode, r.stdout


def _changed_files(rev: str, paths) -> list:
    """.py files changed vs ``rev`` (deletions excluded) plus untracked
    ones, intersected with the requested scan paths."""
    rc, diff = _git("diff", "--name-only", "--diff-filter=d", rev, "--")
    if rc != 0:
        raise RuntimeError(f"git diff {rev} failed — is {rev!r} a valid "
                           f"revision of this repo?")
    _, untracked = _git("ls-files", "--others", "--exclude-standard")
    roots = [Path(p).resolve() for p in paths]
    out = []
    for name in sorted(set(diff.splitlines() + untracked.splitlines())):
        f = (REPO_ROOT / name).resolve()
        if f.suffix != ".py" or not f.exists():
            continue
        if any(r == f or r in f.parents for r in roots):
            out.append(str(f))
    return out


def _fingerprint(finding, source_lines: dict) -> tuple:
    """Line-number-independent identity of a finding: (relative path,
    rule, stripped source text of the flagged line)."""
    try:
        rel = str(Path(finding.path).resolve().relative_to(REPO_ROOT))
    except ValueError:
        rel = finding.path
    lines = source_lines.get(finding.path)
    text = ""
    if lines and 1 <= finding.line <= len(lines):
        text = lines[finding.line - 1].strip()
    return (rel, finding.rule_id, text)


def _load_source_lines(findings) -> dict:
    lines = {}
    for f in findings:
        if f.path not in lines:
            try:
                lines[f.path] = Path(f.path).read_text(
                    encoding="utf-8").splitlines()
            except OSError:
                lines[f.path] = []
    return lines


def _apply_baseline(findings, baseline_path: Path):
    """Split findings into (new, known) against the committed baseline."""
    try:
        doc = json.loads(baseline_path.read_text())
    except OSError:
        return findings, []
    except ValueError as e:
        raise RuntimeError(f"unreadable baseline {baseline_path}: {e}")
    known = {}
    for rec in doc.get("findings", []):
        key = (rec["path"], rec["rule"], rec["line_text"])
        known[key] = known.get(key, 0) + 1
    lines = _load_source_lines(findings)
    new, matched = [], []
    for f in findings:
        key = _fingerprint(f, lines)
        if known.get(key, 0) > 0:
            known[key] -= 1
            matched.append(f)
        else:
            new.append(f)
    return new, matched


def _write_baseline(findings, baseline_path: Path) -> None:
    """Write the current findings as the baseline, keeping the reason of
    each one the file already held; a new finding gets an empty reason,
    which the self-scan's test refuses until someone writes why it is
    accepted."""
    reasons = {}
    try:
        for rec in json.loads(baseline_path.read_text()).get("findings", []):
            reasons[(rec["path"], rec["rule"], rec["line_text"])] = \
                rec.get("reason", "")
    except (OSError, ValueError):
        pass
    lines = _load_source_lines(findings)
    recs = [{"path": k[0], "rule": k[1], "line_text": k[2],
             "reason": reasons.get(k, "")}
            for k in sorted(_fingerprint(f, lines) for f in findings)]
    baseline_path.write_text(json.dumps(
        {"version": 1,
         "comment": "raftlint findings accepted in raft_tpu_torch/, each "
                    "with its reason: known findings listed here do not "
                    "fail --strict; new ones do. Regenerate with python -m "
                    "raft_tpu_torch.tools.raftlint --write-baseline and "
                    "write each new entry's reason.",
         "findings": recs}, indent=2) + "\n")
    print(f"raftlint: wrote {len(recs)} finding(s) to {baseline_path}")


def _blame_age(path: Path, line: int) -> str:
    """Committer date of a line via git blame, or '?' (untracked/no git)."""
    rc, out = _git("blame", "-L", f"{line},{line}", "--porcelain",
                   "--", str(path))
    if rc != 0:
        return "?"
    for ln in out.splitlines():
        if ln.startswith("committer-time "):
            import datetime
            ts = int(ln.split()[1])
            return datetime.date.fromtimestamp(ts).isoformat()
    return "?"


def _list_suppressions(paths) -> int:
    """Audit report of every ``# raftlint: disable[-file]=`` escape: rule,
    file:line, age (git blame), and the comment text — deliberate escapes
    stay reviewable as the count grows (lint/RULES.md)."""
    n = 0
    for f in engine.iter_python_files(paths):
        src = f.read_text(encoding="utf-8")
        for lineno, kind, ids, text in engine.iter_suppressions(src):
            n += 1
            try:
                rel = f.resolve().relative_to(REPO_ROOT)
            except ValueError:
                rel = f
            print(f"{','.join(ids):<10} {rel}:{lineno}  "
                  f"[{kind}, since {_blame_age(f, lineno)}]  {text}")
    print(f"raftlint: {n} suppression(s)")
    return 0


def _parse_serve_args(spec: str):
    """A serve-style flag string -> (RAFTConfig, ServeConfig) of the port.

    Understood tokens (the port's ``-m serve`` flags that shape the warm
    grid or the footprint): --small, --buckets HxW[,HxW...], --max-batch N,
    --batch-steps a,b,..., --max-sessions N, --iters-policy SPEC, --iters N,
    --chaos SPEC, --dp-devices N, --compute-dtype D, --corr-impl I,
    --gru-impl I, --quant Q, --ragged."""
    import shlex

    from ..config import RAFTConfig
    from ..serving.config import ServeConfig, parse_buckets

    toks = shlex.split(spec or "")
    model, serve, small = {}, {}, False
    i = 0

    def value(flag):
        nonlocal i
        if i + 1 >= len(toks):
            raise ValueError(f"{flag} needs a value")
        i += 1
        return toks[i]

    setters = {
        "--buckets": lambda v: serve.__setitem__("buckets", parse_buckets(v)),
        "--max-batch": lambda v: serve.__setitem__("max_batch", int(v)),
        "--batch-steps": lambda v: serve.__setitem__(
            "batch_steps", tuple(int(s) for s in v.split(","))),
        "--max-sessions": lambda v: serve.__setitem__("max_sessions", int(v)),
        "--iters-policy": lambda v: serve.__setitem__("iters_policy", v),
        "--chaos": lambda v: serve.__setitem__("chaos", v),
        "--dp-devices": lambda v: serve.__setitem__("dp_devices", int(v)),
        "--iters": lambda v: model.__setitem__("iters", int(v)),
        "--compute-dtype": lambda v: model.__setitem__("compute_dtype", v),
        "--corr-impl": lambda v: model.__setitem__("corr_impl", v),
        "--gru-impl": lambda v: model.__setitem__("gru_impl", v),
        "--quant": lambda v: model.__setitem__("quant", v),
    }
    while i < len(toks):
        t = toks[i]
        if t == "--small":
            small = True
        elif t == "--ragged":
            serve["ragged"] = True
        elif t in setters:
            setters[t](value(t))
        else:
            raise ValueError(f"unknown --serve-args token {t!r}")
        i += 1
    config = (RAFTConfig.small_model(**model) if small
              else RAFTConfig.full(**model))
    return config, ServeConfig(**serve)


def _budget_summary(report: dict) -> str:
    mb = 1024.0 ** 2
    t = report["totals"]
    lines = [
        f"budget [{report['device_kind']}] grid={report['grid']['size']} "
        + " ".join(f"{k}:{n}" for k, n in
                   sorted(report["grid"]["by_kind"].items())),
        f"  params {report['params_bytes'] / mb:.1f} MB, resident "
        f"{t['resident_bytes'] / mb:.1f} MB, peak {t['peak_bytes'] / mb:.1f}"
        f" MB of {t['hbm_budget_bytes'] / mb:.0f} MB "
        f"(headroom {t['headroom_bytes'] / mb:.1f} MB), graph pools "
        f"{t['graph_pool_bytes'] / mb:.1f} MB",
    ]
    for b in report["buckets"]:
        bh, bw = b["bucket"]
        lines.append(
            f"  bucket {bh}x{bw}: pool {b['pool_bytes'] / mb:.1f} MB "
            f"({b['per_session_bytes'] / 1024.0:.0f} KB/session), peak "
            f"call {b['peak_transient_bytes'] / mb:.1f} MB")
    for name, p in sorted(report["graph_pools"]["pools"].items()):
        lines.append(f"  graph pool {name}: {p['price'] / mb:.1f} MB over "
                     f"{p['keys']} key(s)")
    for e in report["kernels"]["entries"]:
        regs = (e["registers"] if e["registers"] is not None
                else "<=128 (launch bounds)")
        lines.append(
            f"  kernel {e['kernel']} {e['entry']}#{e['launch']}: "
            f"{e['block_smem']} B shared a block, {e['threads']} threads, "
            f"registers {regs}, {e['blocks_per_sm']} block(s) an SM "
            f"({e['limited_by']})")
    if t["max_sessions_fit"] is not None:
        configured = report["config_signature"]["max_sessions"]
        lines.append(f"  max sessions that fit: {t['max_sessions_fit']} "
                     f"(configured {configured})")
    for v in report["violations"]:
        lines.append(f"  VIOLATION: {v}")
    return "\n".join(lines)


def budget_report(config, sconfig, device_kind: str = "h100-80gb",
                  regs=None) -> dict:
    """``lint/budget.py::analyze`` with the graph pools priced into the
    peak and the kernels' envelopes (their violations joined)."""
    from ..lint import budget
    report = budget.analyze(config, sconfig, device_kind=device_kind)
    pools = budget.serving_pool_prices(config, sconfig)
    kernels = budget.kernel_envelopes(config, regs)
    t = report["totals"]
    t["graph_pool_bytes"] = pools["total_bytes"]
    t["peak_bytes"] += pools["total_bytes"]
    t["headroom_bytes"] = t["hbm_budget_bytes"] - t["peak_bytes"]
    if t["headroom_bytes"] < 0:
        report["violations"].append(
            f"estimated peak with the graph pools {t['peak_bytes']} B "
            f"exceeds the {device_kind} memory budget "
            f"{t['hbm_budget_bytes']} B by {-t['headroom_bytes']} B")
    report["graph_pools"] = pools
    report["kernels"] = kernels
    report["violations"] += kernels["violations"]
    return report


def _run_budget(args) -> int:
    """``--budget`` mode: static capacity report + strict gating."""
    try:
        config, sconfig = _parse_serve_args(args.serve_args)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    report = budget_report(config, sconfig, device_kind=args.device_kind)
    failures = list(report["violations"])
    baseline_path = (Path(args.budget_baseline) if args.budget_baseline
                     else DEFAULT_BUDGET_BASELINE)
    if not args.no_baseline and baseline_path.exists():
        try:
            base = json.loads(baseline_path.read_text())
        except (OSError, ValueError) as e:
            print(f"ERROR: unreadable budget baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        # like with like: another config signature has another surface
        if base.get("config_signature") == report["config_signature"] \
                and report["grid"]["size"] > base["grid"]["size"]:
            failures.append(
                f"compile surface grew: {report['grid']['size']} captured "
                f"keys vs {base['grid']['size']} in {baseline_path.name} — "
                f"every extra key is warmup time; regenerate the baseline "
                f"deliberately with --budget --budget-out {baseline_path}")
    report["strict_failures"] = failures
    out = json.dumps(report, indent=2, default=str) + "\n"
    if args.budget_out:
        Path(args.budget_out).write_text(out)
    if args.format == "json":
        print(out, end="")
    else:
        print(_budget_summary(report))
        if args.budget_out:
            print(f"  wrote {args.budget_out}")
    if args.strict and failures:
        for f in failures:
            print(f"raftlint budget: FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.raftlint",
        description="hazard analysis and capacity report for the port")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to scan (default: "
                        "raft_tpu_torch/)")
    p.add_argument("--strict", action="store_true",
                   help="exit non-zero on any finding not in the baseline "
                        "(CI gate); default mode is report-only")
    p.add_argument("--select", default=None, metavar="R1,R2",
                   help="run only these rule ids")
    p.add_argument("--ignore", default=None, metavar="R4",
                   help="skip these rule ids")
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.add_argument("--json", action="store_true",
                   help="alias for --format json")
    p.add_argument("--budget", action="store_true",
                   help="static capacity mode: the warm grid, device "
                        "memory, graph pools and kernel envelopes for a "
                        "serve config (no device, no compile)")
    p.add_argument("--device-kind", default="h100-80gb",
                   choices=["h100-80gb", "cpu"],
                   help="device budget to solve headroom against")
    p.add_argument("--serve-args", default="", metavar="ARGS",
                   help="serve-style flag string of the config to analyze, "
                        "e.g. \"--buckets 432x1024 --max-sessions 64\"")
    p.add_argument("--budget-out", default=None, metavar="FILE",
                   help="write the full report here (--budget mode)")
    p.add_argument("--budget-baseline", default=None, metavar="FILE",
                   help=f"budget baseline for --strict grid-growth checks "
                        f"(default {DEFAULT_BUDGET_BASELINE.name} in the "
                        f"port's lint/)")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--contracts", action="store_true",
                   help="list every @contract'd signature instead of linting")
    p.add_argument("--diff", nargs="?", const="HEAD", default=None,
                   metavar="REV",
                   help="scan only .py files changed vs REV (default HEAD) "
                        "plus untracked ones")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"findings baseline (default the port's "
                        f"lint/{DEFAULT_BASELINE.name})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline file "
                        "(reasons kept) and exit 0")
    p.add_argument("--list-suppressions", action="store_true",
                   help="audit report of every '# raftlint: disable=' "
                        "escape (rule, file:line, age via git blame)")
    args = p.parse_args(argv)

    if args.json:
        args.format = "json"
    if args.list_rules:
        _list_rules()
        return 0
    if args.budget:
        return _run_budget(args)
    paths = args.paths or [str(PORT_ROOT)]
    if args.contracts:
        _dump_contracts(paths)
        return 0
    if args.list_suppressions:
        return _list_suppressions(paths)
    if args.diff is not None:
        try:
            paths = _changed_files(args.diff, paths)
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
        if not paths:
            print(f"raftlint: no .py files changed vs {args.diff}"
                  + (" [strict]" if args.strict else ""))
            return 0
    select = args.select.split(",") if args.select else None
    ignore = args.ignore.split(",") if args.ignore else None
    try:
        findings = engine.scan_paths(paths, select=select, ignore=ignore)
    except KeyError as e:
        print(f"ERROR: {e.args[0]}", file=sys.stderr)
        return 2
    baseline = Path(args.baseline) if args.baseline else DEFAULT_BASELINE
    if args.write_baseline:
        _write_baseline(findings, baseline)
        return 0
    known = []
    if not args.no_baseline:
        try:
            findings, known = _apply_baseline(findings, baseline)
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
    if args.format == "json":
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        errors = sum(f.severity == "error" for f in findings)
        warnings = len(findings) - errors
        n_files = len(list(engine.iter_python_files(paths)))
        print(f"raftlint: {n_files} files scanned, {errors} error(s), "
              f"{warnings} warning(s)"
              + (f", {len(known)} baselined" if known else "")
              + (" [strict]" if args.strict else ""))
    if args.strict and findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
