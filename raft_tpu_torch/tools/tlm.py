"""tlm — tail / summarize / compare telemetry run logs (OBSERVABILITY.md),
the port's copy of the JAX package's ``tools/tlm.py``:
``python -m raft_tpu_torch.tools.tlm``.  It reads the JAX package's
artifacts and the port's alike; ``top`` derives its panels with
``raft_tpu_torch.telemetry.timeseries``.

Works on every artifact the stack stamps a manifest into:

* run-event logs — ``events.jsonl`` written by every CLI mode (a directory
  containing one, or the file itself);
* training ``metrics.jsonl`` streams (manifest record + per-step records +
  the end-of-run registry snapshot);
* ``BENCH_*.json`` / ``BENCH_serving.json`` — single JSON objects or
  JSONL appends with a ``"manifest"`` key.

Usage:
    python -m raft_tpu_torch.tools.tlm tail PATH [-n N]
    python -m raft_tpu_torch.tools.tlm summary PATH
    python -m raft_tpu_torch.tools.tlm compare A B
    python -m raft_tpu_torch.tools.tlm trace PATH [TRACE_ID]
    python -m raft_tpu_torch.tools.tlm top URL_OR_PATH [--window S] [--interval S] [--once]

``top`` is the live terminal dashboard over the time-series plane
(OBSERVABILITY.md "Time-series & anomaly detection"): pointed at a
serving URL it polls ``GET /debug/history`` — a replica shows its
derived panels (pairs/s, p50/p95, occupancy, queue, burn, cache-miss
rates) as sparklines plus any firing anomaly sentinels; a fleet router
shows one block per replica plus the skew-drained list.  Pointed at a
``metrics_ts.jsonl`` spill (or a run dir holding one — fleet dirs show
every replica) it REPLAYS the run offline through the exact same
derivation path, no server required.  ``--once`` prints a single frame
and exits (CI / piping); without it the screen redraws every
``--interval`` seconds until Ctrl-C.

``summary`` prints the manifest (provenance: git sha, the framework's
versions, device and power limit, config hash), per-event-kind counts, and whatever run result the log holds
(final metric snapshot, step trajectory, bench headline) — plus, when the
log carries request traces, a latency-attribution table (queue_wait vs
execute vs respond p50/p95 and their share of e2e).  ``compare`` diffs two
runs field-by-field: manifest provenance first (did the commit / config /
device change?), then the numeric results.  ``trace`` works on any stream
holding ``{"event": "trace", ...}`` records — a serve run's
``events.jsonl`` or a flight-recorder dump (``flightrec.jsonl``,
``GET /debug/traces`` saved to a file): without an id it lists the traces
(slowest / non-ok first); with one (a prefix is enough) it renders the
span tree as a waterfall.  Pointed at a FLEET run dir (router log at the
top, ``replica-N/`` subdirs below), records sharing a trace id — the
router's route/forward/retry/migrate view and the replica's
admit/queue/execute view of the same request, joined by the propagated
``X-Raft-Trace-Id`` — merge into one cross-process waterfall, aligned
on the wall-clock stamps both sides record.

Pure stdlib and importable — no torch needed except for ``top`` (which
imports the port's time-series module), so it runs on a laptop without the
training environment.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple



def load_records(path) -> List[dict]:
    """Tolerant loader: a directory (events.jsonl, else metrics.jsonl
    inside), a .jsonl stream, or a file holding one JSON object.  Partial
    trailing lines (crash mid-append) are dropped, never fatal."""
    p = Path(path)
    if p.is_dir():
        # a run output dir (--out): merge the event log with the training
        # metrics stream(s) one level down — and any flight-recorder dump
        # (serve runs) — so one `tlm summary <out>` sees everything
        # one level down also covers a fleet run dir: the router's log at
        # the top, each replica's events.jsonl/flightrec.jsonl in its
        # replica-N/ subdir — `tlm summary <fleet-out>` sees the whole
        # fleet, and `tlm trace` can join router + replica spans
        streams = [q for q in
                   [p / "events.jsonl", p / "metrics.jsonl",
                    p / "flightrec.jsonl"]
                   + sorted(p.glob("*/events.jsonl"))
                   + sorted(p.glob("*/metrics.jsonl"))
                   + sorted(p.glob("*/flightrec.jsonl")) if q.exists()]
        if not streams:
            raise FileNotFoundError(
                f"{path}: no events.jsonl or */metrics.jsonl inside")
        records = []
        for q in streams:
            records.extend(load_records(q))
        return records
    text = p.read_text()
    records = []
    try:
        one = json.loads(text)
        return one if isinstance(one, list) else [one]
    except json.JSONDecodeError:
        pass
    for ln in text.splitlines():
        if not ln.strip():
            continue
        try:
            records.append(json.loads(ln))
        except json.JSONDecodeError:
            pass
    return records


# the JAX package's manifest fields, then the port's (a manifest shows the
# fields it holds)
MANIFEST_FIELDS = ("git_sha", "mode", "time", "config_hash", "backend",
                   "device_kind", "device_count", "jax_version",
                   "jaxlib_version", "python", "torch_version",
                   "cuda_version", "power_limit")


def manifest_of(records: List[dict]) -> Optional[dict]:
    """The LAST manifest in the stream (append-only logs carry one per
    session; the latest describes the segment the results belong to).
    Accepts both the event form ({"event": "manifest", ...fields}) and the
    embedded form ({"manifest": {...}} — bench JSONs)."""
    found = None
    for rec in records:
        if rec.get("event") == "manifest":
            found = rec
        elif isinstance(rec.get("manifest"), dict):
            found = rec["manifest"]
    return found


def _step_records(records: List[dict]) -> List[dict]:
    return [r for r in records if "step" in r and "event" not in r]


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _fmt_metric(v) -> str:
    """Compact one-line rendering for registry-snapshot values: histogram
    dicts as count/mean (the bucket map is for derivation, not reading),
    labeled families as k=v pairs, scalars via :func:`_fmt_val`."""
    if isinstance(v, dict):
        if "count" in v:
            return f"count {v.get('count')}  mean {_fmt_val(v.get('mean', 0.0))}"
        pairs = [f"{k}={_fmt_val(sv)}" for k, sv in sorted(v.items())
                 if isinstance(sv, (int, float))]
        return "  ".join(pairs) if pairs else str(v)
    return _fmt_val(v)


def summary_lines(path) -> List[str]:
    records = load_records(path)
    out = [f"== {path} ({len(records)} record(s))"]
    man = manifest_of(records)
    if man is None:
        out.append("  manifest: MISSING (pre-telemetry artifact?)")
    else:
        for k in MANIFEST_FIELDS:
            if k in man:
                out.append(f"  {k:<14} {man.get(k)}")
    kinds = {}
    seen_trace_ids = set()
    for rec in records:
        kind = rec.get("event", "record")
        if kind == "trace" and isinstance(rec.get("spans"), list):
            # a run-dir load merges events.jsonl with the flightrec dump;
            # count each trace once (same dedup as trace_records)
            tid = rec.get("trace_id")
            if tid is not None:
                if tid in seen_trace_ids:
                    continue
                seen_trace_ids.add(tid)
        kinds[kind] = kinds.get(kind, 0) + 1
    out.append("  events: " + ", ".join(f"{k}={n}"
                                        for k, n in sorted(kinds.items())))
    # training-resilience events (OBSERVABILITY.md "Training resilience"):
    # surfaced the same way data starvation is, so a preempted or
    # rolled-back run is obvious from one `tlm summary`
    if kinds.get("preempted"):
        out.append("  PREEMPTED: run stopped on SIGTERM/SIGINT after an "
                   "emergency checkpoint (exit code 17) — rerun the same "
                   "command to resume")
    if kinds.get("ckpt_queue_saturated"):
        out.append(f"  ASYNC-CKPT QUEUE SATURATED "
                   f"{kinds['ckpt_queue_saturated']}x: the step loop "
                   f"blocked on the checkpoint writer — the disk is slower "
                   f"than --ckpt-every")
    if kinds.get("fault_injected"):
        out.append(f"  chaos: {kinds['fault_injected']} fault(s) injected "
                   f"(--chaos / --chaos-train drill)")
    # fleet-plane events (OBSERVABILITY.md "Fleet"): replica lifecycle,
    # session migrations, hot-swaps — the one-line health of a fleet run
    if any(k.startswith("fleet_") for k in kinds):
        parts = [f"{kinds.get('fleet_replica_ready', 0)} replica "
                 f"spawn(s)"]
        deaths = kinds.get("fleet_replica_dead", 0)
        if deaths:
            parts.append(
                f"{deaths} death(s) "
                f"({kinds.get('fleet_replica_restarting', 0)} respawned)")
        if kinds.get("fleet_session_migrated"):
            parts.append(f"{kinds['fleet_session_migrated']} session "
                         f"migration(s)")
        if kinds.get("fleet_hot_swap"):
            parts.append(f"{kinds['fleet_hot_swap']} weight hot-swap(s)")
        if kinds.get("fleet_scaled"):
            parts.append(f"{kinds['fleet_scaled']} scale event(s)")
        out.append("  fleet: " + ", ".join(parts))
    steps = _step_records(records)
    if steps:
        first, last = steps[0], steps[-1]
        keys = [k for k in ("loss", "epe", "it_per_s") if k in last]
        out.append(f"  steps {first['step']} -> {last['step']}: " + "  ".join(
            f"{k} {_fmt_val(first.get(k))} -> {_fmt_val(last.get(k))}"
            for k in keys))
    if kinds.get("anomaly"):
        fires = sum(1 for r in records if r.get("event") == "anomaly"
                    and r.get("edge") == "fire")
        rules = sorted({r.get("rule") for r in records
                        if r.get("event") == "anomaly"
                        and r.get("edge") == "fire"})
        out.append(f"  ANOMALIES: {fires} sentinel fire(s) "
                   f"[{', '.join(str(r) for r in rules)}] — see `anomaly` "
                   f"events for reasons; /debug/history for the window")
    for rec in records:
        if rec.get("event") == "run_end" and isinstance(rec.get("metrics"),
                                                        dict):
            for name, val in sorted(rec["metrics"].items()):
                if name.startswith("_"):
                    continue          # private snapshot fields (_scrape_time)
                out.append(f"  {name:<32} {_fmt_metric(val)}")
            wait = rec["metrics"].get("raft_data_wait_seconds")
            if isinstance(wait, dict) and wait.get("count"):
                out.append(
                    f"  input-pipeline wait: {wait['mean'] * 1000:.1f} "
                    f"ms/batch over {wait['count']} get(s) — the train-step "
                    f"starvation signal (raise --workers/--prefetch-depth "
                    f"if it rivals the step time)")
            iu = rec["metrics"].get("raft_iters_used")
            if isinstance(iu, dict) and iu.get("count"):
                out.append(
                    f"  adaptive iters: mean {iu['mean']:.2f} GRU "
                    f"iteration(s) over {iu['count']} sample(s) — the "
                    f"converge early-exit saving vs the declared max "
                    f"(--iters-policy, OBSERVABILITY.md)")
            rb = rec["metrics"].get("raft_train_rollbacks_total")
            if rb:
                out.append(
                    f"  DIVERGENCE ROLLBACKS: {int(rb)} — non-finite "
                    f"steps restored from the last good checkpoint "
                    f"snapshot (aborts after --max-rollbacks consecutive; "
                    f"see `rollback` events for the step windows)")
            rsp = rec["metrics"].get("raft_data_worker_respawns_total")
            if rsp:
                out.append(
                    f"  data-worker respawns: {int(rsp)} — dead/stalled "
                    f"worker pools healed in place (`worker_respawn` "
                    f"events carry per-worker exitcodes + shm free-list "
                    f"depth)")
            cw = rec["metrics"].get("raft_ckpt_write_seconds")
            if isinstance(cw, dict) and cw.get("count"):
                out.append(
                    f"  checkpoint writer: {cw['count']} write(s), mean "
                    f"{cw['mean'] * 1000:.0f} ms each kept off the step "
                    f"path (async; --sync-ckpt restores inline saves)")
            ec_hits = rec["metrics"].get("raft_engine_cache_hits_total")
            ec_miss = rec["metrics"].get("raft_engine_cache_misses_total")
            if isinstance(ec_hits, (int, float)) \
                    or isinstance(ec_miss, (int, float)):
                out.append(
                    f"  engine cache: {int(ec_hits or 0)} AOT deserialize "
                    f"hit(s), {int(ec_miss or 0)} compile miss(es) — a "
                    f"warm cache boots compile-free "
                    f"(--engine-cache-dir, SERVING.md)")
            fleet_nums = {k[len("raft_fleet_"):]: v
                          for k, v in rec["metrics"].items()
                          if k.startswith("raft_fleet_")
                          and isinstance(v, (int, float)) and v}
            if fleet_nums:
                out.append("  fleet: " + "  ".join(
                    f"{k}={_fmt_val(v)}"
                    for k, v in sorted(fleet_nums.items())))
            af = rec["metrics"].get("raft_anomaly_fires_total")
            if isinstance(af, dict):
                fired = {k: v for k, v in af.items()
                         if isinstance(v, (int, float)) and v}
                if fired:
                    out.append("  anomaly sentinels fired: " + ", ".join(
                        f"{k} x{int(v)}"
                        for k, v in sorted(fired.items())))
        if rec.get("event") == "nonfinite":
            out.append(f"  NONFINITE at stage {rec.get('stage')!r} "
                       f"({rec.get('bad_values')} value(s))")
        if rec.get("event") == "recompile":
            out.append(f"  RECOMPILE #{rec.get('n')} at stage "
                       f"{rec.get('stage')!r} ({rec.get('duration_s')}s)")
    out.extend(attribution_lines(records))
    # bench-style single objects: surface the headline numbers
    for rec in records:
        if "value" in rec and "metric" in rec:
            out.append(f"  {rec['metric']}: {rec['value']} "
                       f"{rec.get('unit', '')}".rstrip())
            conv = rec.get("converge")
            if isinstance(conv, dict):
                for row in conv.get("rows", []):
                    out.append(
                        f"    {row['policy']}: "
                        f"{row['pairs_per_sec']} pairs/s  "
                        f"mean_iters {row['mean_iters']} "
                        f"(fixed {conv.get('baseline_mean_iters')})")
            quant = rec.get("quant")
            if isinstance(quant, dict):
                for row in quant.get("rows", []):
                    if "pairs_per_sec" in row:
                        out.append(
                            f"    quant:{row['quant']}: "
                            f"{row['pairs_per_sec']} pairs/s  encoder HBM "
                            f"x{row.get('encoder_hbm_ratio')} smaller")
                    else:
                        out.append(
                            f"    quant:{row['quant']}: "
                            f"x{row.get('compression')} slot-row "
                            f"compression  max_rel_err "
                            f"{row.get('max_rel_err')}")
    return out


# ------------------------------------------------------- request traces --

SPAN_ORDER = ("route", "forward", "retry", "migrate",
              "admit", "queue_wait", "batch_form", "pad", "execute",
              "execute_dispatch", "execute_block", "respond")


def _join_traces(recs: List[dict]) -> dict:
    """Merge several trace records sharing one trace id into a single
    waterfall.  A fleet request produces one record per hop — the router
    (route/forward/retry/migrate spans) and the replica it forwarded to
    (admit/queue_wait/execute/...) — joined by the propagated
    ``X-Raft-Trace-Id``.  Hops are aligned on the wall-clock finish
    stamp each record carries (``t`` minus its duration; same-host
    clocks, so good to well under a millisecond — enough to place the
    replica's spans inside the router's forward window).  Exact
    duplicates (events.jsonl + flightrec carry the same record) collapse
    first, keyed by the root span id."""
    uniq: dict = {}
    for r in recs:
        root = r["spans"][0].get("span") if r.get("spans") else id(r)
        uniq.setdefault(root, r)

    def t0_wall(r):
        return (r.get("t") or 0.0) - (r.get("dur_ms") or 0.0) / 1000.0

    hops = sorted(uniq.values(), key=t0_wall)
    if len(hops) == 1:
        return hops[0]
    base = hops[0]
    base_t0 = t0_wall(base)
    spans = [dict(s) for s in base["spans"]]
    for hop in hops[1:]:
        off_ms = (t0_wall(hop) - base_t0) * 1000.0
        for s in hop["spans"]:
            s2 = dict(s)
            s2["start_ms"] = round(s.get("start_ms", 0.0) + off_ms, 3)
            if s2.get("name") == "request":
                s2["name"] = "replica:request"
            spans.append(s2)
    joined = dict(base, spans=spans)
    joined["hops"] = len(hops)
    return joined


def trace_records(records: List[dict]) -> List[dict]:
    """The request-trace records in a stream (events.jsonl `trace` events
    and flight-recorder dumps share one shape), one record per trace id:
    duplicates (a default serve run writes each trace to BOTH
    events.jsonl and the flightrec dump) collapse, and multi-hop fleet
    traces (router + replica views of one request) join into a single
    waterfall."""
    by_id: dict = {}
    for r in records:
        if r.get("event") == "trace" and isinstance(r.get("spans"), list):
            by_id.setdefault(r.get("trace_id") or id(r), []).append(r)
    return [rs[0] if len(rs) == 1 else _join_traces(rs)
            for rs in by_id.values()]


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def attribution_lines(records: List[dict]) -> List[str]:
    """The latency-attribution table: per span name, p50/p95 of the
    per-trace total and its share of mean e2e — where the time went,
    fleet-wide (`tlm trace <id>` for one request's waterfall)."""
    traces = trace_records(records)
    if not traces:
        return []
    per: dict = {}
    e2e = []
    for rec in traces:
        e2e.append(float(rec.get("dur_ms") or 0.0))
        sums: dict = {}
        for s in rec["spans"]:
            # roots, including a joined hop's re-rooted "replica:request",
            # are e2e covers, not attribution buckets
            if str(s.get("name", "")).endswith("request"):
                continue
            sums[s["name"]] = sums.get(s["name"], 0.0) + s.get("dur_ms", 0.0)
        for k, v in sums.items():
            per.setdefault(k, []).append(v)
    mean_e2e = sum(e2e) / len(e2e) if e2e else 0.0
    by_status: dict = {}
    for rec in traces:
        st = rec.get("status", "?")
        by_status[st] = by_status.get(st, 0) + 1
    out = [f"  latency attribution over {len(traces)} trace(s) "
           f"(" + ", ".join(f"{k}={n}" for k, n in sorted(by_status.items()))
           + f"), mean e2e {mean_e2e:.2f}ms:"]
    names = [n for n in SPAN_ORDER if n in per]
    names += sorted(set(per) - set(SPAN_ORDER))
    for name in names:
        vals = sorted(per[name])
        share = (sum(vals) / len(traces)) / mean_e2e * 100 if mean_e2e else 0
        nested = name in ("execute_dispatch", "execute_block")
        out.append(f"    {name:<18} p50 {_pctl(vals, 0.50):9.2f}ms  "
                   f"p95 {_pctl(vals, 0.95):9.2f}ms  "
                   f"{share:5.1f}% of e2e"
                   + ("  (inside execute)" if nested else ""))
    return out


def trace_list_lines(records: List[dict]) -> List[str]:
    traces = trace_records(records)
    if not traces:
        return ["no trace records found (serve with --trace-sample > 0, "
                "or point at a flightrec.jsonl dump)"]
    # non-ok first, then slowest: the ones worth looking at
    traces.sort(key=lambda r: (r.get("status") == "ok",
                               -(r.get("dur_ms") or 0.0)))
    out = [f"{len(traces)} trace(s)  (tlm trace PATH <id-prefix> for the "
           f"waterfall)"]
    for r in traces:
        out.append(f"  {r.get('trace_id', '?')[:16]:<16} "
                   f"[{r.get('kind', '?'):<6}] "
                   f"{r.get('status', '?'):<9} "
                   f"{r.get('dur_ms', 0.0):9.2f}ms  "
                   f"{len(r.get('spans', [])):3d} span(s)"
                   + (f"  joined x{r['hops']}" if r.get("hops") else ""))
    return out


def render_trace(rec: dict, width: int = 36) -> List[str]:
    """One trace as an indented span tree + waterfall (start offsets and
    durations in ms; co-batched requests share the execute span id)."""
    spans = rec.get("spans", [])
    total = max([rec.get("dur_ms") or 0.0]
                + [s.get("start_ms", 0.0) + s.get("dur_ms", 0.0)
                   for s in spans]) or 1e-9
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.get("parent"), []).append(s)
    out = [f"trace {rec.get('trace_id')} [{rec.get('kind')}] "
           f"status={rec.get('status')} {rec.get('dur_ms')}ms "
           f"({len(spans)} span(s))"]

    def emit(s: dict, depth: int) -> None:
        start, dur = s.get("start_ms", 0.0), s.get("dur_ms", 0.0)
        a = int(start / total * width)
        b = max(a + 1, int((start + dur) / total * width))
        bar = "·" * a + "█" * (b - a)
        flag = ("" if s.get("status") in ("ok", None)
                else f"  !{s['status']}")
        label = "  " * depth + s.get("name", "?")
        out.append(f"  {label:<22} {start:9.2f} {dur:9.2f}ms  "
                   f"|{bar:<{width}}|{flag}")
        kids = sorted(by_parent.get(s.get("span"), []),
                      key=lambda c: c.get("start_ms", 0.0))
        for c in kids:
            emit(c, depth + 1)

    for root in sorted(by_parent.get(None, []),
                       key=lambda c: c.get("start_ms", 0.0)):
        emit(root, 0)
    return out


def _final_numbers(records: List[dict]) -> dict:
    """Flat {name: number} view of a run's results, for compare."""
    out = {}
    steps = _step_records(records)
    if steps:
        for k, v in steps[-1].items():
            if isinstance(v, (int, float)) and k != "step":
                out[f"final.{k}"] = v
        out["final.step"] = steps[-1]["step"]
    for rec in records:
        if rec.get("event") == "run_end" and isinstance(rec.get("metrics"),
                                                        dict):
            for name, val in rec["metrics"].items():
                if name.startswith("_"):
                    continue          # private snapshot fields (_scrape_time)
                if isinstance(val, (int, float)):
                    out[name] = val
                elif isinstance(val, dict):
                    for sub, sv in val.items():
                        if isinstance(sv, (int, float)):
                            out[f"{name}.{sub}"] = sv
        if "value" in rec and isinstance(rec.get("value"), (int, float)):
            out["value"] = rec["value"]
            for k in ("vs_baseline", "mfu"):
                if isinstance(rec.get(k), (int, float)):
                    out[k] = rec[k]
    return out


# ------------------------------------------------------------- tlm top --

SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 40) -> str:
    """Unicode sparkline of the trailing ``width`` points, scaled to the
    visible min..max; a None point renders as a gap (a quiet interval has
    no value, not a zero value)."""
    tail = list(vals)[-width:]
    nums = [v for v in tail if isinstance(v, (int, float))]
    if not nums:
        return " " * len(tail)
    lo, hi = min(nums), max(nums)
    span = (hi - lo) or 1.0
    out = []
    for v in tail:
        if not isinstance(v, (int, float)):
            out.append(" ")
        else:
            out.append(SPARK_CHARS[int((v - lo) / span
                                       * (len(SPARK_CHARS) - 1))])
    return "".join(out)


def _last_value(vals):
    for v in reversed(vals):
        if v is not None:
            return v
    return None


def _panel_order() -> List[str]:
    from ..telemetry.timeseries import DEFAULT_PANELS
    return [name for name, *_ in DEFAULT_PANELS]


def _series_block(series: dict, width: int = 40) -> List[str]:
    """Sparkline rows for one columnar series dict ({'t': [...], name:
    [...]}), in the DEFAULT_PANELS order (unknown names last)."""
    order = _panel_order()
    names = [n for n in series if n != "t"]
    names.sort(key=lambda n: (order.index(n) if n in order else len(order),
                              n))
    out = []
    for name in names:
        vals = series.get(name, [])
        last = _last_value(vals)
        disp = "—" if last is None else _fmt_val(float(last))
        out.append(f"    {name:<24} {disp:>10}  {sparkline(vals, width)}")
    return out


def top_frame(payload: dict, source: str, width: int = 40) -> List[str]:
    """One dashboard frame from a ``/debug/history`` payload — the
    replica form ({"series": ...} + anomalies_active) or the fleet-router
    form ({"sources": {idx: series}} + skewed) — or a replay-derived
    payload of either shape."""
    out = [f"== tlm top — {source}"]
    if "series" in payload:
        out.append(f"  interval {payload.get('interval_s', '?')}s   "
                   f"retained {payload.get('retained', '?')} sample(s)   "
                   f"span {payload.get('span_s', '?')}s")
        out.extend(_series_block(payload["series"], width))
        active = payload.get("anomalies_active")
        if active:
            for rule, reason in sorted(active.items()):
                out.append(f"  ANOMALY {rule}: {reason}")
        elif "anomalies_active" in payload:
            out.append("  anomalies: none active")
    if "sources" in payload:
        skewed = {str(s) for s in payload.get("skewed", [])}
        def _src_key(item):
            src = item[0]
            return (0, int(src)) if src.isdigit() else (1, src)
        for src, series in sorted(payload["sources"].items(), key=_src_key):
            tag = "  [SKEWED — picks steered away]" if src in skewed else ""
            out.append(f"  replica {src}{tag}")
            out.extend(_series_block(series, width))
        if not payload["sources"]:
            out.append("  (no replica scrapes ingested yet)")
    return out


def _replay_payload(path, window: Optional[float] = None) -> dict:
    """Rebuild a /debug/history-shaped payload from ``metrics_ts.jsonl``
    spills: a file replays as one replica's series; a run dir merges
    every ``*/metrics_ts.jsonl`` below it as fleet sources (replica-N
    subdir name = source)."""
    from ..telemetry.timeseries import derive_series, load_metrics_ts

    def clipped(samples):
        if window is not None and samples:
            cutoff = samples[-1]["t"] - window
            samples = [s for s in samples if s["t"] >= cutoff]
        return samples

    p = Path(path)
    if p.is_file():
        manifest, samples = load_metrics_ts(p)
        samples = clipped(samples)
        span = (samples[-1]["t"] - samples[0]["t"]
                if len(samples) > 1 else 0.0)
        payload = {"retained": len(samples), "span_s": round(span, 3),
                   "interval_s": round(span / (len(samples) - 1), 3)
                   if len(samples) > 1 else "?",
                   "series": derive_series(samples)}
        if manifest:
            payload["manifest"] = manifest
        return payload
    files = [q for q in [p / "metrics_ts.jsonl"]
             + sorted(p.glob("*/metrics_ts.jsonl")) if q.exists()]
    if not files:
        raise FileNotFoundError(f"{path}: no metrics_ts.jsonl inside")
    if len(files) == 1:
        return _replay_payload(files[0], window)
    return {"sources": {
        q.parent.name: derive_series(clipped(load_metrics_ts(q)[1]))
        for q in files}}


def top_lines(target: str, window: Optional[float] = None,
              width: int = 40) -> List[str]:
    """One ``tlm top`` frame: live (``http(s)://`` target → GET
    /debug/history) or replay (a metrics_ts.jsonl / run dir)."""
    if target.startswith(("http://", "https://")):
        import urllib.request
        url = target.rstrip("/") + "/debug/history"
        if window is not None:
            url += f"?window={window:g}"
        with urllib.request.urlopen(url, timeout=10) as r:
            payload = json.loads(r.read())
        return top_frame(payload, target, width)
    return top_frame(_replay_payload(target, window),
                     f"{target} (replay)", width)


def compare_lines(path_a, path_b) -> Tuple[List[str], bool]:
    """Returns (report lines, comparable) — comparable is False when either
    side has no manifest (provenance unknown)."""
    ra, rb = load_records(path_a), load_records(path_b)
    ma, mb = manifest_of(ra), manifest_of(rb)
    out = [f"== compare A={path_a}  B={path_b}"]
    comparable = ma is not None and mb is not None
    if not comparable:
        out.append("  manifest missing on "
                   + ("both sides" if ma is None and mb is None
                      else ("A" if ma is None else "B"))
                   + " — provenance unknown")
    ma, mb = ma or {}, mb or {}
    same, diff = [], []
    for k in MANIFEST_FIELDS:
        va, vb = ma.get(k), mb.get(k)
        (same if va == vb else diff).append((k, va, vb))
    for k, va, vb in diff:
        out.append(f"  {k:<14} A={va}  B={vb}")
    if not diff:
        out.append("  manifests identical on "
                   + ",".join(k for k, *_ in same))
    na, nb = _final_numbers(ra), _final_numbers(rb)
    for k in sorted(set(na) | set(nb)):
        va, vb = na.get(k), nb.get(k)
        if va is None or vb is None:
            out.append(f"  {k:<32} A={_fmt_val(va)}  B={_fmt_val(vb)}")
        elif va != vb:
            delta = vb - va
            pct = f" ({delta / va * 100:+.1f}%)" if va else ""
            out.append(f"  {k:<32} A={_fmt_val(va)}  B={_fmt_val(vb)}"
                       f"{pct}")
        else:
            out.append(f"  {k:<32} {_fmt_val(va)}  (same)")
    return out, comparable


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.tlm", description="tail/summarize/compare telemetry run logs")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("tail", help="print the last N records")
    pt.add_argument("path")
    pt.add_argument("-n", type=int, default=10)
    ps = sub.add_parser("summary", help="manifest + event counts + results")
    ps.add_argument("path")
    pc = sub.add_parser("compare", help="diff two runs with provenance")
    pc.add_argument("a")
    pc.add_argument("b")
    pr = sub.add_parser("trace", help="list request traces / render one "
                                      "as a span-tree waterfall")
    pr.add_argument("path", help="events.jsonl, flightrec.jsonl, or a "
                                 "run dir holding one")
    pr.add_argument("trace_id", nargs="?", default=None,
                    help="trace id (prefix ok); omit to list")
    pp = sub.add_parser("top", help="live dashboard over /debug/history "
                                    "(URL) or replay a metrics_ts.jsonl")
    pp.add_argument("path", help="serving/router URL (http://host:port) "
                                 "or a metrics_ts.jsonl / run dir")
    pp.add_argument("--window", type=float, default=None,
                    help="trailing seconds to show (default: whole ring)")
    pp.add_argument("--interval", type=float, default=2.0,
                    help="redraw period for live mode (seconds)")
    pp.add_argument("--once", action="store_true",
                    help="print one frame and exit (CI / piping)")
    args = p.parse_args(argv)

    try:
        if args.cmd == "tail":
            for rec in load_records(args.path)[-args.n:]:
                print(json.dumps(rec))
        elif args.cmd == "summary":
            print("\n".join(summary_lines(args.path)))
        elif args.cmd == "trace":
            records = load_records(args.path)
            if args.trace_id is None:
                print("\n".join(trace_list_lines(records)))
                return 0 if trace_records(records) else 1
            # stored ids are lowercase; accept the prefix in any case
            want = args.trace_id.lower()
            hits = [r for r in trace_records(records)
                    if str(r.get("trace_id", "")).startswith(want)]
            if not hits:
                print(f"tlm: no trace matching {args.trace_id!r} in "
                      f"{args.path}", file=sys.stderr)
                return 1
            for rec in hits:
                print("\n".join(render_trace(rec)))
        elif args.cmd == "top":
            import time as _time
            try:
                while True:
                    lines = top_lines(args.path, args.window)
                    if args.once:
                        print("\n".join(lines))
                        break
                    # full-screen redraw (clear + home), the classic top(1)
                    sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines)
                                     + "\n")
                    sys.stdout.flush()
                    _time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
        else:
            lines, comparable = compare_lines(args.a, args.b)
            print("\n".join(lines))
            return 0 if comparable else 1
    except BrokenPipeError:       # `tlm trace ... | head` is a normal use
        return 0
    except OSError as e:          # missing file, or `top` URL unreachable
        print(f"tlm: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
