"""The port's telemetry and lint copies (``raft_tpu_torch/telemetry``,
``raft_tpu_torch/lint``) against the JAX package's: the same metric
operations give the same ``/metrics`` exposition text, the serving metric
sets have the same families, spans and the flight recorder round-trip,
the lock-order validator flags an inversion of the hierarchy (which now
holds the engine's device lock), the time-series derivations and anomaly
rules agree on synthetic histories, ``stage()`` and the profiler captures
work on the CPU, and run manifests carry torch's device fields.  All of it
runs on the CPU with no subprocess and no sleep over 1 s.
"""

import json
import threading

import pytest

from raft_tpu.serving import ServeConfig as JaxServeConfig
from raft_tpu.serving.metrics import make_serving_metrics as jax_serving
from raft_tpu.telemetry import registry as jax_registry
from raft_tpu.telemetry import anomaly as jax_anomaly
from raft_tpu.telemetry import spans as jax_spans
from raft_tpu.telemetry import timeseries as jax_ts
from raft_tpu.lint.concurrency import \
    SERVING_LOCK_HIERARCHY as JAX_HIERARCHY
from raft_tpu_torch.lint.concurrency import (SERVING_LOCK_HIERARCHY,
                                             guarded_by)
from raft_tpu_torch.serving import ServeConfig
from raft_tpu_torch.serving.metrics import make_serving_metrics
from raft_tpu_torch.telemetry import anomaly, events, registry, spans
from raft_tpu_torch.telemetry import timeseries, trace, watchdogs

import torch

torch.set_num_threads(2)   # several test workers share the host's cores


def _drive(reg_mod):
    """One fixed sequence of metric operations on a fresh registry of
    ``reg_mod``; returns its exposition text."""
    reg = reg_mod.Registry()
    c = reg.counter("t_requests_total", "requests", labelnames=("status",))
    c.labels("ok").inc()
    c.labels("ok").inc(2)
    c.labels("shed").inc()
    reg.gauge("t_depth", "depth").set(7)
    reg.gauge("t_live", "callback", fn=lambda: 42)
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    lh = reg.histogram("t_step", "steps", labelnames=("kind",),
                       buckets=(1.0, 2.0, 4.0))
    lh.labels("pair").observe(2.0)
    lh.labels("stream").observe(3.0)
    reg.get_or_counter("t_made_total", "get-or-create").inc(5)
    reg.get_or_gauge("t_made", "get-or-create").set(0.25)
    return reg.render()


def test_registry_exposition_text_equals_jax():
    assert _drive(registry) == _drive(jax_registry)
    assert "t_lat_seconds_bucket{le=\"+Inf\"} 3" in _drive(registry)


@pytest.mark.parametrize("kw", [dict(), dict(max_batch=2, ragged=True,
                                             buckets=((16, 24), (32, 48)))],
                         ids=["default", "ragged"])
def test_serving_metric_set_renders_as_jax(kw):
    """The serving metric set after the same observations: equal text
    (the process-start gauge, a wall-clock value, aside)."""
    texts = []
    for make, sc, reg_mod in ((jax_serving, JaxServeConfig(**kw),
                               jax_registry),
                              (make_serving_metrics, ServeConfig(**kw),
                               registry)):
        reg = reg_mod.Registry()
        m = make(reg, sc, queue_depth_fn=lambda: 3)
        m["requests"].labels("ok").inc(4)
        m["pairs"].inc(4)
        m["request_latency"].observe(0.04)
        m["batch_size"].observe(2)
        m["batch_occupancy"].observe(0.5)
        m["padding_waste"].observe(0.25)
        m["compile_hits"].inc(2)
        texts.append("\n".join(
            line for line in reg.render().splitlines()
            if not line.startswith("raft_process_start_time_seconds ")))
    assert texts[0] == texts[1]


def test_span_and_flight_recorder_round_trip(tmp_path):
    out = []
    for mod in (jax_spans, spans):
        path = tmp_path / f"{mod.__name__}.jsonl"
        rec = mod.FlightRecorder(capacity=4, path=str(path))
        slo = mod.SLOTracker(objectives={"pair": 1.0, "stream": 0.5},
                             budget=0.01, window=16)
        tracer = mod.Tracer(sample=1.0, recorder=rec, slo=slo)
        tr = tracer.start("pair", "ABCDEF0123")
        tr.span("admit", 0.0, 0.001)
        tr.span("execute", 0.002, 0.012, batch=2)
        tr.finish()
        bad = tracer.start("pair")
        bad.finish(mod.TIMEOUT)
        assert tracer.open_traces == 0 and rec.counts() == (1, 1)
        dumped = rec.dump("shutdown")
        lines = [json.loads(x) for x in open(dumped).read().splitlines()]
        snap = rec.snapshot()
        out.append((sorted(snap[0]), [s["name"] for s in
                                      next(t for t in snap if t["trace_id"]
                                           == "abcdef0123")["spans"]],
                    sorted({t["status"] for t in snap}), len(lines) >= 2,
                    round(slo.burn_rate("pair"), 6)))
    assert out[0] == out[1]
    assert "execute" in out[1][1] and out[1][3]


def test_record_device_call_fills_the_execute_split():
    slot = []
    spans.set_device_slot(slot)
    try:
        spans.record_device_call("pair", 1.0, 1.25, 2.0)
    finally:
        spans.set_device_slot(None)
    assert slot and slot[0][0] == "pair"


def test_lock_hierarchy_holds_the_device_lock_between_queue_and_engine():
    h = list(SERVING_LOCK_HIERARCHY)
    i = h.index("InferenceEngine._device_lock")
    assert h[i - 1] == "RequestQueue._lock" and h[i + 1] == "InferenceEngine._lock"
    assert [n for n in h if n != "InferenceEngine._device_lock"] == [
        n for n in JAX_HIERARCHY if n != "InferenceEngine._spec_lock"]
    assert repr(guarded_by("_lock")) == "guarded_by('_lock')"


def test_watched_lock_order_check_flags_an_inversion():
    v = watchdogs.LockOrderValidator(hold_budget_s=None, log_fn=lambda m: None)
    v.declare_order(SERVING_LOCK_HIERARCHY)
    dev = watchdogs.watched_lock("InferenceEngine._device_lock", validator=v)
    eng = watchdogs.watched_lock("InferenceEngine._lock", validator=v)
    pool = watchdogs.watched_lock("SlotPool._lock", validator=v)
    with dev, eng:
        pass
    with dev, pool:
        pass
    assert v.counts()["order_violations"] == 0
    done = threading.Event()

    def inverted():
        with eng, dev:                 # the device lock under the leaf
            done.set()
    t = threading.Thread(target=inverted)
    t.start()
    t.join(30)
    assert not t.is_alive() and done.is_set()
    assert v.counts()["order_violations"] == 1
    assert "hierarchy inversion" in v.violations[0]["msg"]


def test_recompile_watch_counts_captures_after_arm():
    fired = []
    reg = registry.Registry()
    w = watchdogs.RecompileWatch(counter=reg.counter("t_cap_total", "c"),
                                 log_fn=lambda m: None,
                                 on_recompile=lambda: fired.append(1))
    w.install()
    try:
        watchdogs.RecompileWatch.notify(0.5, captures=2)   # warmup
        w.arm()
        with trace.stage("serve/batch"):
            watchdogs.RecompileWatch.notify(0.25)
    finally:
        w.remove()
    watchdogs.RecompileWatch.notify(0.1)                   # removed: unseen
    assert (w.compiles, w.warmup_compiles, w.recompiles) == (3, 2, 1)
    assert w.events[0]["stage"] == "serve/batch" and fired == [1]
    assert "t_cap_total 1" in reg.render()


def test_hbm_gauges_read_zero_without_a_device():
    reg = registry.Registry()
    g = watchdogs.hbm_gauges(reg, prefix="raft_serving")
    import torch
    if not torch.cuda.is_available():
        assert g["bytes_in_use"].value == 0 == g["bytes_limit"].value
    assert "raft_serving_hbm_bytes_limit" in reg.render()


def _series(mod, *pairs):
    return [{"t": t, "snap": {"_scrape_time": t, **snap}} for t, snap in pairs]


def test_timeseries_derivations_and_rules_agree_with_jax():
    lat = "raft_serving_request_latency_seconds"

    def hist(count, total, buckets):
        return {"buckets": buckets, "count": count, "sum": total}
    pairs = [(90.0, {"raft_serving_pairs_total": 0.0,
                     "raft_serving_compile_cache_misses_total": 5.0,
                     lat: hist(100, 1.0, {"0.01": 100, "0.1": 100, "1": 100,
                                          "+Inf": 100})}),
             (95.0, {"raft_serving_pairs_total": 40.0,
                     "raft_serving_compile_cache_misses_total": 5.0,
                     lat: hist(150, 2.0, {"0.01": 100, "0.1": 140, "1": 150,
                                          "+Inf": 150})}),
             (100.0, {"raft_serving_pairs_total": 100.0,
                      "raft_serving_compile_cache_misses_total": 6.0,
                      lat: hist(200, 9.0, {"0.01": 100, "0.1": 140, "1": 200,
                                           "+Inf": 200})})]
    results = []
    for ts, an in ((jax_ts, jax_anomaly), (timeseries, anomaly)):
        samples = _series(ts, *pairs)
        cfg = an.AnomalyConfig()
        results.append((ts.derive_series(samples),
                        {name: rule(samples, cfg)
                         for name, rule in an.RULES.items()}))
    assert results[0] == results[1]
    assert results[1][1]["miss_trickle"] is not None
    assert results[1][0]["pairs_per_s"] == [8.0, 12.0]


def test_metric_history_and_monitor_on_a_synthetic_registry(tmp_path):
    reg = registry.Registry()
    pairs = reg.counter("raft_serving_pairs_total", "pairs")
    hist = timeseries.MetricHistory(reg, interval_s=0.0, window=8,
                                    path=str(tmp_path / "ts.jsonl"),
                                    manifest={"mode": "test"})
    state = {"reason": None}
    mon = anomaly.AnomalyMonitor(hist, reg, rules={
        "test_rule": lambda samples, cfg: state["reason"]})
    mon.arm()
    hist.sample()
    pairs.inc(10)
    state["reason"] = "storm"
    hist.sample()
    assert mon.active() == {"test_rule": "storm"}
    state["reason"] = None
    hist.sample()
    assert mon.active() == {} and mon.total_fires == 1
    assert hist.window_json()["retained"] == 3
    hist.stop()
    manifest, samples = timeseries.load_metrics_ts(str(tmp_path / "ts.jsonl"))
    assert manifest["mode"] == "test" and len(samples) >= 3


def test_stage_provenance_and_profiler_captures(tmp_path):
    assert trace.current_stage() is None
    with trace.stage("serve/batch"):
        with trace.stage("serve/inner"):
            assert trace.current_stage() == "serve/inner"
        assert trace.current_stage() == "serve/batch"
    assert trace.current_stage() is None
    win = trace.TraceWindow(str(tmp_path / "win"), first=1, steps=1)
    assert win.on_step(0) is False and win.on_step(1) is True
    with trace.stage("serve/step"):
        sum(range(100))
    assert win.on_step(2) is False
    data = json.load(open(tmp_path / "win" / trace.TRACE_FILE))
    assert any(e.get("name") == "serve/step" for e in data["traceEvents"])
    info = trace.capture_profile(str(tmp_path / "prof"), 20.0)
    assert info["trace_file"].startswith(str(tmp_path / "prof"))
    with pytest.raises(ValueError):
        trace.capture_profile(None, 0.0)
    assert trace._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(trace.CaptureBusy):
            trace.capture_profile(None, 10.0)
    finally:
        trace._capture_lock.release()


def test_first_profiler_session_opens_on_the_hosting_thread(monkeypatch,
                                                            tmp_path):
    """A capture asked for on a handler thread has its first session
    opened by the thread waiting in ``host_profiler_warmup`` (a server's
    foreground thread); later captures open none; nothing opens one before
    a capture is asked for."""
    opened = []

    class Prof:
        def stop(self):
            pass

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    def start():
        opened.append(threading.get_ident())
        return Prof()

    monkeypatch.setattr(trace, "_start_profiler", start)
    monkeypatch.setattr(trace, "_profiler_warm", False)
    stopped = threading.Event()
    host = threading.Thread(target=trace.host_profiler_warmup,
                            args=(stopped, 0.05), daemon=True)
    host.start()
    for _ in range(200):
        if trace._warm_host == host.ident:
            break
        stopped.wait(0.01)
    assert trace._warm_host == host.ident and opened == []
    me = threading.get_ident()
    trace.capture_profile(str(tmp_path / "a"), 5.0)
    assert opened == [host.ident, me]
    trace.capture_profile(str(tmp_path / "b"), 5.0)
    assert opened == [host.ident, me, me]
    stopped.set()
    host.join(timeout=10)
    assert not host.is_alive() and trace._warm_host is None


def test_run_manifest_carries_torch_device_fields(tmp_path):
    m = events.run_manifest(config=ServeConfig(), mode="serve")
    for key in ("torch_version", "cuda_version", "device_kind",
                "device_count", "backend", "power_limit"):
        assert key in m
    assert not any(k.startswith(("jax", "jaxlib")) for k in m)
    assert m["torch_version"] and m["config_hash"]
    quiet = events.run_manifest(mode="serve", probe_device=False)
    assert quiet["device_kind"] is None and quiet["backend"] is None
    log = events.start_run(tmp_path, mode="serve")
    log.event("probe", n=1)
    log.close()
    recs = events.read_events(tmp_path)
    assert [r["event"] for r in recs] == ["manifest", "probe"]
