"""The port's tools (``raft_tpu_torch/tools``) against the JAX package's
(``tools/*.py``, loaded through importlib as tests/test_serving.py and
tests/test_telemetry.py load them), on the same inputs:

* serve_bench's Prometheus helpers (``parse_prom``, ``hist_percentile``,
  ``diff_prom``) on the same scrape text, ``make_session_frames`` for the
  same seeds, and the open loop's arrival schedule for the same seed —
  equal, exactly;
* tlm's ``summary_lines``, ``compare_lines``, ``sparkline``, ``top_frame``
  and the replayed ``top`` on tests/test_telemetry.py's fixtures — equal;
* the budget analyzer's HBM half (``lint/budget.py::analyze``) against
  ``raft_tpu.lint.budget.analyze(..., device_kind="cpu")`` for f32 and int8
  serving configurations: the grid, the parameter bytes, each key's output
  bytes, the resident bytes and the slot bytes per session equal; one
  difference by design, named below (the slot indices of the in-place
  commit and poison are int64 in the port), priced exactly;
* make_qualitative's flow columns against the JAX model on the same npz
  (``raft_tpu.convert.weights.save_params_npz``), within the full-model
  bound ``1e-3 + 1e-3 * max|flow|`` of tests/test_torch_golden.py.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)   # several test workers share the host's cores

REPO = Path(__file__).resolve().parent.parent


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sb():
    return _load_tool("serve_bench")


@pytest.fixture(scope="module")
def jax_tlm():
    return _load_tool("tlm")


# ------------------------------------------------------ serve_bench -------

def _scrape_text(seed):
    """A /metrics text of the port's registry: counters with labels, a
    gauge, histograms with integer and fractional buckets."""
    from raft_tpu_torch.serving import Registry
    rng = np.random.RandomState(seed)
    reg = Registry()
    req = reg.counter("raft_serving_requests_total", "requests",
                      labelnames=("status",))
    for st in ("ok", "shed", "timeout"):
        req.labels(st).inc(int(rng.randint(0, 50)))
    reg.gauge("raft_serving_queue_depth", "depth").set(float(rng.rand()))
    it = reg.histogram("raft_iters_used", "iters",
                       buckets=tuple(float(i) for i in range(1, 13)))
    for v in rng.randint(1, 13, size=40):
        it.observe(float(v))
    lat = reg.histogram("raft_stream_step_seconds", "step")
    for v in rng.exponential(0.05, size=30):
        lat.observe(float(v))
    return reg.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prom_helpers_equal(jax_sb, seed):
    from raft_tpu_torch.tools import serve_bench as port_sb
    before, after = _scrape_text(seed), _scrape_text(seed + 10)
    pa, ja = port_sb.parse_prom(after), jax_sb.parse_prom(after)
    assert pa == ja and len(pa) > 20
    pb, jb = port_sb.parse_prom(before), jax_sb.parse_prom(before)
    assert port_sb.diff_prom(pb, pa) == jax_sb.diff_prom(jb, ja)
    for name in ("raft_iters_used", "raft_stream_step_seconds", "missing"):
        for q in (0.05, 0.5, 0.95, 1.0):
            assert port_sb.hist_percentile(pa, name, q) == \
                jax_sb.hist_percentile(ja, name, q), (name, q)


@pytest.mark.parametrize("seed", [100, 101, 7])
def test_session_frames_bitwise(jax_sb, seed):
    """At the smoke's 32x48 the two synthetic datasets' textures agree
    bitwise (at 432x1024 they differ by one level of 255 in places)."""
    from raft_tpu_torch.tools import serve_bench as port_sb
    got = port_sb.make_session_frames(32, 48, 4, seed=seed, shift=6)
    want = jax_sb.make_session_frames(32, 48, 4, seed=seed, shift=6)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


class _VirtualClock:
    """A module's ``time`` with a virtual clock: ``sleep(d)`` records the
    instant it sleeps until and advances the clock there."""

    def __init__(self):
        self.now = 1000.0
        self.wakes = []

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, d):
        self.now += d
        self.wakes.append(self.now)


class _NullClient:
    def __init__(self, *args, **kwargs):
        pass

    def one(self, *args, **kwargs):
        pass


@pytest.mark.parametrize("seed,rate", [(0, 20.0), (3, 5.5)])
def test_open_loop_arrival_schedule_equal(jax_sb, monkeypatch, seed, rate):
    """Both run_open loops, on a virtual clock with the HTTP client
    stubbed, wake at the same instants, and those are the port's
    ``arrival_gaps`` summed."""
    from raft_tpu_torch.tools import serve_bench as port_sb
    wakes = []
    for mod in (jax_sb, port_sb):
        clock = _VirtualClock()
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "Client", _NullClient)
        mod.run_open("h", 0, b"", 2, 25, rate, seed=seed)
        wakes.append(np.asarray(clock.wakes) - 1000.0)
    assert len(wakes[0]) == 25 and np.array_equal(wakes[0], wakes[1])
    sched = np.cumsum(port_sb.arrival_gaps(25, rate, seed))
    np.testing.assert_allclose(wakes[1], sched, rtol=0, atol=1e-9)


# ------------------------------------------------------------- tlm -------

def _fake_run(tmp_path, name, sha, epe):
    """tests/test_telemetry.py's fixture run."""
    from raft_tpu.telemetry import run_manifest
    d = tmp_path / name
    d.mkdir()
    man = run_manifest(mode="train", probe_device=False)
    man["git_sha"] = sha
    man["config_hash"] = "cafe" * 4
    lines = [
        {"t": 1.0, "event": "manifest", **man},
        {"step": 0, "loss": 10.0, "epe": epe + 1.0},
        {"step": 1, "loss": 5.0, "epe": epe},
        {"t": 2.0, "event": "run_end", "final_step": 2,
         "metrics": {"raft_train_steps_total": 2.0}},
    ]
    (d / "events.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in lines))
    return d


def test_tlm_summary_and_compare_equal(jax_tlm, tmp_path):
    from raft_tpu_torch.tools import tlm as port_tlm
    a = _fake_run(tmp_path, "a", "a" * 40, epe=2.0)
    b = _fake_run(tmp_path, "b", "b" * 40, epe=1.0)
    assert port_tlm.summary_lines(a) == jax_tlm.summary_lines(a)
    assert port_tlm.compare_lines(a, b) == jax_tlm.compare_lines(a, b)
    bench = tmp_path / "BENCH_test.json"
    from raft_tpu.telemetry import run_manifest
    bench.write_text(json.dumps({
        "metric": "inference throughput", "value": 3.25,
        "unit": "pairs/sec/chip",
        "manifest": run_manifest(mode="bench", probe_device=False)}))
    legacy = tmp_path / "BENCH_old.json"
    legacy.write_text(json.dumps({"metric": "x", "value": 1.0}))
    assert port_tlm.summary_lines(bench) == jax_tlm.summary_lines(bench)
    assert port_tlm.compare_lines(bench, legacy) == \
        jax_tlm.compare_lines(bench, legacy)


@pytest.mark.parametrize("vals", [[], [None, None], [0.0, None, 10.0],
                                  list(range(100)), [3.0, 3.0, 3.0],
                                  [5.0, 7.0, 1e6, -2.0]])
def test_tlm_sparkline_equal(jax_tlm, vals):
    from raft_tpu_torch.tools import tlm as port_tlm
    for width in (40, 7):
        assert port_tlm.sparkline(vals, width=width) == \
            jax_tlm.sparkline(vals, width=width)


def test_tlm_top_frames_equal(jax_tlm, tmp_path):
    from raft_tpu_torch.tools import tlm as port_tlm
    series = {"t": [1.0, 2.0], "pairs_per_s": [5.0, 7.0],
              "p95_ms": [None, None]}
    clean = {"interval_s": 1.0, "retained": 3, "span_s": 2.0,
             "series": series, "anomalies_active": {}}
    firing = dict(clean, anomalies_active={"p95_drift": "p95 900ms > 2x"})
    fleet = {"sources": {"0": series, "10": series, "2": series},
             "skewed": [2]}
    for payload, source in ((clean, "replica"), (firing, "replica"),
                            (fleet, "router"), ({"sources": {}}, "router")):
        assert port_tlm.top_frame(payload, source) == \
            jax_tlm.top_frame(payload, source)
    spill = tmp_path / "metrics_ts.jsonl"
    recs = [{"kind": "manifest", "mode": "serve"}]
    for i in range(4):
        t = 100.0 + 10.0 * i
        recs.append({"kind": "sample", "t": t,
                     "snap": {"_scrape_time": t,
                              "raft_serving_pairs_total": 70.0 * i}})
    spill.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert port_tlm._replay_payload(str(spill)) == \
        jax_tlm._replay_payload(str(spill))
    assert port_tlm.top_lines(str(spill)) == jax_tlm.top_lines(str(spill))


# --------------------------------------------------------- budget ---------

BUDGET_CASES = {
    "small_f32": dict(small=True, quant="none", buckets="32x48",
                      max_batch=2, sessions=2),
    "small_int8": dict(small=True, quant="int8", buckets="32x48",
                       max_batch=2, sessions=2),
    "full_f32_two_buckets": dict(small=False, quant="none",
                                 buckets="32x48,48x64", max_batch=2,
                                 sessions=3),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_budget_analyze_byte_totals_equal(case):
    """By design the port's commit (``scommit``) and poison (``spoison``)
    take int64 slot indices (``index_copy_``), where the JAX executables
    take int32: their input bytes are 4 per row more, and nothing else
    differs.  The port's commit writes the pool in place on every device,
    so the JAX side is priced with ``donation=True``, its in-place
    model."""
    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.lint import budget as jax_budget
    from raft_tpu.serving import ServeConfig as JaxServe
    from raft_tpu.serving import parse_buckets as jax_buckets
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.lint import budget as port_budget
    from raft_tpu_torch.serving import ServeConfig, parse_buckets

    c = BUDGET_CASES[case]

    def cfg(cls):
        base = cls.small_model(iters=2) if c["small"] else cls.full(iters=2)
        return dataclasses.replace(base, quant=c["quant"])
    jrep = jax_budget.analyze(
        cfg(JaxConfig), JaxServe(buckets=jax_buckets(c["buckets"]),
                                 max_batch=c["max_batch"],
                                 max_sessions=c["sessions"], port=0),
        device_kind="cpu", donation=True)
    prep = port_budget.analyze(
        cfg(RAFTConfig), ServeConfig(buckets=parse_buckets(c["buckets"]),
                                     max_batch=c["max_batch"],
                                     max_sessions=c["sessions"], port=0),
        device_kind="cpu")
    assert prep["grid"] == jrep["grid"]
    assert prep["params_bytes"] == jrep["params_bytes"]
    assert prep["config_signature"] == jrep["config_signature"]
    jt, pt = jrep["totals"], prep["totals"]
    for k in ("resident_bytes", "per_session_bytes", "max_sessions_fit",
              "hbm_budget_bytes"):
        assert pt[k] == jt[k], k
    want_peak = 0
    for jb, pb in zip(jrep["buckets"], prep["buckets"]):
        assert pb["bucket"] == jb["bucket"]
        assert pb["pool_bytes"] == jb["pool_bytes"]
        assert pb["per_session_bytes"] == jb["per_session_bytes"]
        for jk, pk in zip(jb["kinds"], pb["kinds"]):
            kind, b = jk["key"][0], jk["key"][3]
            extra = 4 * b if kind in ("scommit", "spoison") else 0
            assert pk["key"] == jk["key"]
            assert pk["input_bytes"] == jk["input_bytes"] + extra, jk["key"]
            assert pk["output_bytes"] == jk["output_bytes"], jk["key"]
            assert pk["transient_bytes"] == jk["transient_bytes"] + extra
            want_peak = max(want_peak, pk["transient_bytes"])
    assert pt["peak_transient_bytes"] == want_peak
    assert pt["peak_bytes"] == jt["resident_bytes"] + want_peak
    assert pt["peak_bytes"] - jt["peak_bytes"] in (0, 4 * c["max_batch"])


def test_budget_h100_budget_and_in_place_commit():
    """On the card the commit is in place: its output aliases the pool, so
    a donated commit holds only its inputs live."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.lint import budget as port_budget
    from raft_tpu_torch.serving import ServeConfig
    rep = port_budget.analyze(RAFTConfig.small_model(iters=2),
                              ServeConfig(buckets=((32, 48),), max_batch=2,
                                          max_sessions=2, port=0))
    assert rep["device_kind"] == "h100-80gb"
    assert rep["totals"]["hbm_budget_bytes"] == 80 * 1024 ** 3
    for k in rep["buckets"][0]["kinds"]:
        if k["key"][0] == "scommit":
            assert k["transient_bytes"] == k["input_bytes"]
    with pytest.raises(ValueError, match="unknown device kind"):
        port_budget.analyze(RAFTConfig.small_model(iters=2),
                            ServeConfig(buckets=((32, 48),), port=0),
                            device_kind="tpu-v4")


# --------------------------------------------------- make_qualitative -----

def test_qualitative_flows_match_jax_model(tmp_path):
    import jax
    import jax.numpy as jnp
    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.convert.weights import save_params_npz
    from raft_tpu.models.raft import make_inference_fn
    from raft_tpu_torch.tools import make_qualitative as mq
    from test_torch_port_pack import seeded_jax_params

    jcfg = JaxConfig.small_model(iters=2)
    params = seeded_jax_params(jcfg, seed=4)
    ckpt = tmp_path / "small.npz"
    save_params_npz(params, str(ckpt))
    cfg = mq.model_config(False, 2)
    model = mq.load_model(ckpt, cfg, torch.device("cpu"))
    rows = mq.panel_flows(model, cfg, (32, 48), 2, torch.device("cpu"))
    fn = jax.jit(make_inference_fn(jcfg))
    from raft_tpu_torch.data.synthetic import SyntheticFlowDataset
    ds = SyntheticFlowDataset(size=(32, 48), length=64, seed=9001)
    for idx, (im1, gt, pred) in enumerate(rows):
        im2 = ds[idx][1]
        want = np.asarray(fn(params, jnp.asarray(im1[None]),
                             jnp.asarray(im2[None])))[0]
        bound = 1e-3 + 1e-3 * float(np.abs(want).max())
        err = float(np.abs(pred - want).max())
        assert err <= bound, f"sample {idx}: {err:.3g} > {bound:.3g}"
    panel, epes = mq.render_panel(rows)
    assert panel.shape == (2 * 32 + 4, 4 * 48, 3) and len(epes) == 2
