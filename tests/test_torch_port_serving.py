"""The port's serving stack (``raft_tpu_torch/serving``) against the JAX
package's: the warmup grid, the engine's device calls and the HTTP surface
on the same seeded inputs and weights, and the port-only behaviour of the
stack (backpressure, deadlines, the breaker, the batcher's coalescing and
supervisor, the non-finite sentinel, reload, the values ServeConfig
rejects) on stub engines.

The port side runs on the CPU, on the kernels' plain versions; the JAX side
is ``InferenceEngine`` / ``FlowServer`` as the JAX package's own serving
tests run them (warmup off for the engine parity, so JAX compiles only the
keys a test calls).  Flows are held to the full-model bound of
tests/test_torch_golden.py, ``1e-3 + 1e-3 * max|flow|``, at 32x48 with 2
iterations.  No subprocess; every server starts in a fixture that stops it
in ``finally``; every HTTP call and join has a timeout of 30 s or less.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.lint.budget import enumerate_warmup_grid as jax_grid
from raft_tpu.serving import FlowServer as JaxFlowServer
from raft_tpu.serving import InferenceEngine as JaxEngine
from raft_tpu.serving import ServeConfig as JaxServeConfig
import raft_tpu_torch as rt
from raft_tpu_torch.convert.weights import save_params_npz, to_jax_params
from raft_tpu_torch.lint.budget import enumerate_warmup_grid as port_grid
from raft_tpu_torch.serving import (BatcherCrashed, BreakerOpen, Draining,
                                    FlowServer, InferenceEngine, MicroBatcher,
                                    NonFiniteOutput, QueueFull, Registry,
                                    Request, RequestQueue, ServeConfig,
                                    DeadlineExceeded, default_batch_steps)
from raft_tpu_torch.serving.engine import ReloadMismatch
from raft_tpu_torch.serving.metrics import (make_robustness_metrics,
                                            make_serving_metrics)
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

TIMEOUT = 30
BUCKET = (32, 48)
ITERS = 2
JCFG = JaxConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
PCFG = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)


def assert_flow_close(got, want, what):
    """The full-model bound of tests/test_torch_golden.py."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bound = 1e-3 + 1e-3 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|diff| {err:.3g} > {bound:.3g}"


@pytest.fixture(scope="module")
def weights():
    """JAX parameters (numpy-seeded, non-trivial batch-norm statistics) and
    the port's model on the CPU holding the same weights."""
    params = seeded_jax_params(JCFG, seed=3)
    model = rt.RAFT(PCFG)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, model.eval()


def frames(seed, n=1, hw=BUCKET):
    return np.random.RandomState(seed).rand(2, n, *hw, 3).astype(np.float32)


# ----------------------------------------------------------- grid parity --

GRID_CASES = {
    "pair_only": dict(buckets=((32, 48), (64, 96)), max_batch=4,
                      max_sessions=0),
    "streaming": dict(buckets=((32, 48),), max_batch=4, max_sessions=4),
    "ragged": dict(buckets=((16, 24), (24, 32), (32, 48)), max_batch=2,
                   max_sessions=2, ragged=True),
    "converge": dict(buckets=((32, 48),), max_batch=2, max_sessions=2,
                     iters_policy="converge:0.5:2"),
    "chaos": dict(buckets=((32, 48),), max_batch=3, max_sessions=2,
                  chaos="seed=3,nan=0.1,session=0.2"),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_warmup_grid_equals_jax(case):
    kw = GRID_CASES[case]
    want = jax_grid(JCFG, JaxServeConfig(**kw))
    got = port_grid(PCFG, ServeConfig(**kw))
    assert got == want and len(set(got)) == len(got)


def test_main_serving_grid_is_jax_twelve_keys():
    """S1's configuration (432x1024, max_batch 4, 4 sessions): pair x3,
    encode, stream, szero, sbatch x3, scommit x3."""
    kw = dict(buckets=((432, 1024),), max_batch=4, max_sessions=4)
    got = port_grid(PCFG, ServeConfig(**kw))
    assert got == jax_grid(JCFG, JaxServeConfig(**kw)) and len(got) == 12


@pytest.mark.parametrize("kw,item", [
    (dict(dp_devices=2), "item 11"),
], ids=["dp_devices"])
def test_serve_config_rejects_unported_values(kw, item):
    """An unported value raises naming its ROADMAP item; ``dp_devices``
    (item 11) is ported now: its batch steps round up to multiples of the
    devices, as the JAX package's do."""
    if item == "item 11":
        sc = ServeConfig(max_batch=3, **kw)
        assert sc.batch_steps == JaxServeConfig(max_batch=3, **kw).batch_steps
        assert all(s % kw["dp_devices"] == 0 for s in sc.batch_steps)
        return
    with pytest.raises(NotImplementedError, match=item):
        ServeConfig(**kw)


def test_serve_config_validates_as_jax():
    for kw in (dict(buckets=((30, 48),)), dict(buckets=()),
               dict(max_batch=4, batch_steps=(1, 2)),
               dict(iters_policy="converge:x"), dict(max_sessions=-1)):
        with pytest.raises(ValueError):
            JaxServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    sc = ServeConfig(buckets=((64, 96), (32, 48)), max_batch=3)
    assert sc.route(30, 44) == (32, 48) and sc.pad_batch_to(3) == 3
    assert sc.batch_steps == default_batch_steps(3) == (1, 2, 3)


# --------------------------------------------------------- engine parity --

def _engines(weights, **kw):
    params, model = weights
    sc = dict(buckets=(BUCKET,), max_batch=2, max_sessions=0, warmup=False)
    sc.update(kw)
    return (JaxEngine(JCFG, params, JaxServeConfig(**sc), iters=ITERS),
            InferenceEngine(PCFG, model, ServeConfig(**sc), iters=ITERS))


def test_engine_run_matches_jax_at_batch_one_and_two(weights):
    jeng, peng = _engines(weights)
    for n, seed in ((1, 11), (2, 12)):
        im = frames(seed, n)
        want = jeng.run(BUCKET, im[0], im[1])
        got = peng.run(BUCKET, im[0], im[1])
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert_flow_close(got, want, f"run at batch {n}")
    # the CPU's "compile" is the first use of a key warmup did not build
    assert (peng.compile_misses, peng.compile_hits) == (2, 0)
    assert peng.run(BUCKET, im[0], im[1]) is not None
    assert (peng.compile_misses, peng.compile_hits) == (2, 1)
    assert (peng.pair_calls, jeng.pair_calls) == (3, 2)


@pytest.mark.parametrize("policy,used", [("converge:1e9:1", 1),
                                         ("converge:0", ITERS)])
def test_engine_converge_matches_jax_flows_and_iters_used(weights, policy,
                                                          used):
    jeng, peng = _engines(weights, iters_policy=policy)
    im = frames(13, 2)
    wflow, wused = jeng.run(BUCKET, im[0], im[1])
    gflow, gused = peng.run(BUCKET, im[0], im[1])
    assert_flow_close(gflow, wflow, policy)
    np.testing.assert_array_equal(gused, np.asarray(wused))
    assert gused.tolist() == [used, used]
    assert peng._key(32, 48, 2)[-1] == policy


def test_engine_warmup_builds_the_grid_then_serves_without_a_miss(weights):
    _, model = weights
    sc = ServeConfig(buckets=(BUCKET,), max_batch=2, max_sessions=0)
    eng = InferenceEngine(PCFG, model, sc, iters=ITERS)
    assert eng.warmup(verbose=False) == 2
    assert eng.keys() == sorted(port_grid(PCFG, sc))
    im = frames(14, 2)
    eng.run(BUCKET, im[0], im[1])
    eng.run(BUCKET, im[0][:1], im[1][:1])
    assert (eng.compile_misses, eng.compile_hits) == (0, 2)
    assert eng.captures() == 0 and eng.graph_count() == 0     # eager CPU


# ----------------------------------------------------------------- reload --

def test_reload_copies_in_place_and_bumps_the_version(weights):
    params, _ = weights
    model = rt.RAFT(PCFG)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    sc = ServeConfig(buckets=(BUCKET,), max_batch=1, max_sessions=0)
    eng = InferenceEngine(PCFG, model.eval(), sc, iters=ITERS)
    eng.warmup(verbose=False)
    ptrs = [t.data_ptr() for t in model.state_dict().values()]
    other = rt.init_raft_torch(PCFG, torch.Generator().manual_seed(5),
                               device="cpu")
    buf = io.BytesIO()
    save_params_npz(other.state_dict(), buf)
    buf.seek(0)
    info = eng.reload(rt.from_jax_params(rt.load_params_npz(buf)), tag="v2")
    assert info == {"version": 2, "tag": "v2", "probed": True}
    assert [t.data_ptr() for t in model.state_dict().values()] == ptrs
    for k, v in other.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    im = frames(15)
    want = rt.make_inference_fn(PCFG, device="cpu")(other, im[0], im[1])
    np.testing.assert_array_equal(eng.run(BUCKET, im[0], im[1]),
                                  want.numpy())
    assert eng.compile_misses == 0 and eng.weight_info()["version"] == 2


def test_reload_rejects_a_template_mismatch(weights):
    _, model = weights
    eng = InferenceEngine(PCFG, model, ServeConfig(buckets=(BUCKET,),
                                                   max_sessions=0))
    state = dict(model.state_dict())
    bad = dict(state)
    bad.pop(next(iter(bad)))
    with pytest.raises(ReloadMismatch, match="names differ"):
        eng.reload(bad)
    name = next(iter(state))
    bad = dict(state, **{name: torch.zeros(3)})
    with pytest.raises(ReloadMismatch, match="differs"):
        eng.reload(bad)
    bad = dict(state, **{name: state[name].double()})
    with pytest.raises(ReloadMismatch, match="float64"):
        eng.reload(bad)
    assert eng.weight_info()["version"] == 1


def test_jax_tree_round_trips_through_the_port_npz(weights):
    params, model = weights
    tree = to_jax_params(model.state_dict())
    flat_want = {}

    def walk(node, path, out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), out)
            else:
                out[path + (k,)] = np.asarray(v)
    walk(params, (), flat_want)
    flat_got = {}
    walk(tree, (), flat_got)
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg="/".join(k))


# ---------------------------------------------------------- HTTP parity --

def _post(server, path, body, content_type="application/json"):
    req = urllib.request.Request(server.url + path, data=body,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.read()


def _get(server, path):
    with urllib.request.urlopen(server.url + path, timeout=TIMEOUT) as r:
        return r.read()


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def twin_servers(weights):
    """One JAX and one port FlowServer on the same weights and ServeConfig
    (port 0, one bucket, batch 1, streaming on: a 6-key grid)."""
    params, model = weights
    kw = dict(buckets=(BUCKET,), max_batch=1, max_sessions=2, port=0,
              default_deadline_ms=30_000.0, history_interval_s=0.2)
    servers = []
    try:
        servers.append(JaxFlowServer(JCFG, params, JaxServeConfig(**kw),
                                     iters=ITERS))
        servers.append(FlowServer(PCFG, model, ServeConfig(**kw),
                                  iters=ITERS))
        for s in servers:
            s.start()
        yield servers
    finally:
        for s in servers:
            s.stop(timeout=TIMEOUT)


def test_http_flow_matches_jax(twin_servers):
    im = frames(21, hw=(30, 44))
    body = json.dumps({"image1": im[0, 0].tolist(),
                       "image2": im[1, 0].tolist()}).encode()
    (js, jb), (ps, pb) = (_post(s, "/v1/flow", body) for s in twin_servers)
    assert js == ps == 200
    jr, pr = json.loads(jb), json.loads(pb)
    assert_flow_close(pr["flow"], jr["flow"], "/v1/flow")
    assert np.asarray(pr["flow"]).shape == (30, 44, 2)
    assert pr["meta"].keys() == jr["meta"].keys()
    assert pr["meta"]["bucket"] == jr["meta"]["bucket"] == list(BUCKET)


def test_http_healthz_keys_and_metrics_families_match_jax(twin_servers):
    jh, ph = (json.loads(_get(s, "/healthz")) for s in twin_servers)

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out
    assert keys(ph) == keys(jh)
    assert ph["executables"] == jh["executables"] == 6
    assert ph["status"] == "ok"
    jm, pm = (_families(_get(s, "/metrics").decode()) for s in twin_servers)
    assert jm <= pm, sorted(jm - pm)


def test_http_stream_matches_jax_and_prestage_is_cacheless(twin_servers):
    im = frames(22, n=3)[0, :, :, :, :]
    flows = []
    for s in twin_servers:
        _, b = _post(s, "/v1/stream", json.dumps(
            {"image": im[0].tolist()}).encode())
        sid = json.loads(b)["session"]
        out = []
        for k in (1, 2):
            _, b = _post(s, "/v1/stream", json.dumps(
                {"session": sid, "image": im[k].tolist()}).encode())
            r = json.loads(b)
            assert r["meta"]["warm"] is True and r["frame"] == k
            out.append(np.asarray(r["flow"], np.float32))
        _post(s, "/v1/stream", json.dumps({"op": "close",
                                           "session": sid}).encode())
        flows.append(out)
    for k in range(2):
        assert_flow_close(flows[1][k], flows[0][k], f"stream advance {k + 1}")
    # neither twin has an engine cache: both refuse the prestage alike (a
    # server with one exports: tests/test_torch_port_aot_cache.py)
    answers = []
    for s in twin_servers:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(s, "/admin/cache/prestage", b"")
        answers.append((e.value.code, json.loads(e.value.read())))
    assert answers[0] == answers[1] and answers[0][0] == 409
    assert twin_servers[1].engine_cache is None


def test_http_reload_and_debug_endpoints(twin_servers):
    port = twin_servers[1]
    buf = io.BytesIO()
    save_params_npz(port.engine.model.state_dict(), buf)
    status, body = _post(port, "/admin/reload", buf.getvalue(),
                         "application/octet-stream")
    assert status == 200 and json.loads(body)["weights"]["version"] == 2
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/admin/reload", b"not an npz",
              "application/octet-stream")
    assert e.value.code == 400
    traces = json.loads(_get(port, "/debug/traces"))
    assert traces["open_traces"] == 0 and traces["traces"]
    assert "series" in json.loads(_get(port, "/debug/history?window=30"))
    status, body = _post(port, "/debug/profile?ms=50", b"")
    info = json.loads(body)
    assert status == 200 and info["trace_file"].endswith("trace.json")
    assert json.load(open(info["trace_file"]))["traceEvents"] is not None
    assert port.engine.compile_misses == 0


# ------------------------------------------- port-only behaviour (stubs) --

def make_request(deadline_s=30.0, bucket=BUCKET, fill=0.0):
    h, w = bucket
    im = np.full((1, h, w, 3), fill, np.float32)
    return Request(im, im, bucket, (0, 0, 0, 0),
                   deadline=time.monotonic() + deadline_s)


class StubEngine:
    """Records (bucket, batch) per call; optionally blocks on a gate,
    raises, or writes Inf into rows whose image1 is all ones."""

    def __init__(self, gate=None, fail=False, nan=False):
        self.calls = []
        self.gate = gate
        self.fail = fail
        self.nan = nan
        self.entered = threading.Event()

    def run(self, bucket, im1, im2):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(TIMEOUT)
        self.calls.append((bucket, im1.shape[0]))
        if self.fail:
            raise RuntimeError("engine exploded")
        flows = np.zeros(im1.shape[:3] + (2,), np.float32)
        if self.nan:
            flows[[bool(im1[i].min() >= 1.0) for i in range(len(im1))]] = \
                np.inf
        return flows


def stub_stack(engine, max_batch=4, max_wait_ms=30.0, depth=16,
               metrics=None):
    q = RequestQueue(depth)
    steps = default_batch_steps(max_batch)
    b = MicroBatcher(q, engine.run, lambda n: next(s for s in steps
                                                   if s >= n),
                     max_batch, max_wait_ms, metrics=metrics)
    b.start()
    return q, b


@pytest.fixture
def stub_server():
    """``make(engine, **ServeConfig overrides)`` -> a started FlowServer on
    a stub engine; every server made is stopped after the test."""
    made = []

    def make(engine, **cfg):
        kw = dict(buckets=(BUCKET,), max_batch=4, max_wait_ms=5.0,
                  queue_depth=16, port=0, max_sessions=0,
                  degraded_window_s=0.4, retry_backoff_ms=1.0,
                  default_deadline_ms=10_000.0, history_interval_s=0)
        kw.update(cfg)
        server = FlowServer(None, None, ServeConfig(**kw), engine=engine)
        made.append(server)
        server.start()
        return server
    try:
        yield make
    finally:
        for s in made:
            s.stop(timeout=TIMEOUT)


def test_batcher_coalesces_a_full_batch():
    eng = StubEngine()
    q, b = stub_stack(eng, max_wait_ms=10_000.0)
    reqs = [make_request() for _ in range(3)] + [make_request()]
    for r in reqs:
        q.submit(r)
    assert all(r.wait(timeout=TIMEOUT).shape == (32, 48, 2) for r in reqs)
    assert eng.calls == [(BUCKET, 4)]
    assert all((r.batch_real, r.batch_padded) == (4, 4) for r in reqs)
    q.close()
    b.join(TIMEOUT)
    assert not b.alive


def test_queue_backpressure_sheds_and_drain_refuses():
    gate = threading.Event()
    eng = StubEngine(gate=gate)
    q, b = stub_stack(eng, max_batch=1, max_wait_ms=5.0, depth=2)
    inflight = make_request()
    q.submit(inflight)
    assert eng.entered.wait(TIMEOUT)
    queued = [make_request(), make_request()]
    for r in queued:
        q.submit(r)
    with pytest.raises(QueueFull) as e:
        q.submit(make_request())
    assert e.value.http_status == 429
    gate.set()
    for r in [inflight] + queued:
        r.wait(timeout=TIMEOUT)
    q.close()
    with pytest.raises(Draining) as e:
        q.submit(make_request())
    assert e.value.http_status == 503
    b.join(TIMEOUT)


def test_deadline_passes_in_the_queue_504():
    gate = threading.Event()
    eng = StubEngine(gate=gate)
    q, b = stub_stack(eng, max_batch=2, max_wait_ms=5.0)
    first = make_request()
    q.submit(first)
    assert eng.entered.wait(TIMEOUT)
    doomed = make_request(deadline_s=0.05)
    q.submit(doomed)
    time.sleep(0.15)
    gate.set()
    first.wait(timeout=TIMEOUT)
    with pytest.raises(DeadlineExceeded) as e:
        doomed.wait(timeout=TIMEOUT)
    assert e.value.http_status == 504 and b.timed_out == 1
    q.close()
    b.join(TIMEOUT)


def test_nan_row_is_nonfinite_output_alone():
    reg = Registry()
    metrics = make_serving_metrics(reg, ServeConfig(buckets=(BUCKET,)))
    metrics["nonfinite"] = make_robustness_metrics(reg)["nonfinite"]
    eng = StubEngine(nan=True)
    q, b = stub_stack(eng, metrics=metrics)
    innocents = [make_request() for _ in range(3)]
    guilty = make_request(fill=1.0)
    for r in innocents[:2] + [guilty] + innocents[2:]:
        q.submit(r)
    for r in innocents:
        assert np.isfinite(r.wait(timeout=TIMEOUT)).all()
    with pytest.raises(NonFiniteOutput):
        guilty.wait(timeout=TIMEOUT)
    assert reg.get("raft_nonfinite_outputs_total").value == 1
    q.close()
    b.join(TIMEOUT)


def test_chaos_nan_arm_fails_the_request_with_nonfinite_output(weights):
    """The chaos ``nan`` arm on the port's real engine: the poisoned row
    raises NonFiniteOutput, and the next request serves."""
    _, model = weights
    sc = ServeConfig(buckets=(BUCKET,), max_batch=1, max_sessions=0, port=0,
                     chaos="seed=1", history_interval_s=0)
    server = FlowServer(PCFG, model, sc, iters=ITERS)
    try:
        server.start()
        server.faults.force("nan", [1])
        im = frames(23)
        with pytest.raises(NonFiniteOutput):
            server.infer(im[0, 0], im[1, 0])
        flow = server.infer(im[0, 0], im[1, 0]).result
        assert np.isfinite(flow).all() and flow.shape == (32, 48, 2)
        assert server.engine.compile_misses == 0
    finally:
        server.stop(timeout=TIMEOUT)


def test_supervisor_restarts_a_killed_batcher(stub_server):
    server = stub_server(StubEngine(), chaos="seed=1")
    server.faults.force("kill", [1])
    im = np.zeros((32, 48, 3), np.float32)
    with pytest.raises(BatcherCrashed):
        server.infer(im, im)
    deadline = time.monotonic() + 5.0
    while not server.batcher.alive and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.batcher.alive and server.supervisor.restarts == 1
    assert json.loads(_get(server, "/healthz"))["status"] == "degraded"
    assert server.infer(im, im).result.shape == (32, 48, 2)
    time.sleep(0.5)
    assert json.loads(_get(server, "/healthz"))["status"] == "ok"
    assert "raft_batcher_restarts_total 1" in _get(server,
                                                    "/metrics").decode()


def test_breaker_opens_sheds_503_and_closes(stub_server):
    eng = StubEngine(fail=True)
    server = stub_server(eng, breaker_window=8, breaker_threshold=0.5,
                         breaker_min_volume=2, breaker_cooldown_s=0.3,
                         engine_retries=0)
    im = np.zeros((32, 48, 3), np.float32)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            server.infer(im, im)
    assert server.breaker.state == "open"
    with pytest.raises(BreakerOpen) as e:
        server.infer(im, im)
    assert e.value.http_status == 503 and e.value.retry_after is not None
    body = json.dumps({"image1": im.tolist(), "image2": im.tolist()}).encode()
    with pytest.raises(urllib.error.HTTPError) as he:
        _post(server, "/v1/flow", body)
    assert he.value.code == 503 and int(he.value.headers["Retry-After"]) >= 1
    eng.fail = False
    time.sleep(0.35)
    assert server.infer(im, im).result.shape == (32, 48, 2)
    assert server.breaker.state == "closed"


def test_http_429_when_the_queue_is_full(stub_server):
    gate = threading.Event()
    eng = StubEngine(gate=gate)
    server = stub_server(eng, max_batch=1, queue_depth=1)
    im = np.zeros((32, 48, 3), np.float32)
    threads = [threading.Thread(target=lambda: server.infer(im, im))
               for _ in range(2)]
    try:
        threads[0].start()
        assert eng.entered.wait(TIMEOUT)
        threads[1].start()
        deadline = time.monotonic() + 5.0
        while len(server.queue) < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        body = json.dumps({"image1": im.tolist(),
                           "image2": im.tolist()}).encode()
        with pytest.raises(urllib.error.HTTPError) as he:
            _post(server, "/v1/flow", body)
        assert he.value.code == 429
        assert int(he.value.headers["Retry-After"]) >= 1
    finally:
        gate.set()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
