"""The port's replica fleet (``raft_tpu_torch/fleet``) against the JAX
package's (``raft_tpu/fleet``), on the CPU.

Two tiers, as ``tests/test_fleet.py``'s.  The decision logic — prom
parsing, the status taxonomy, least-loaded picks, ``scale_to``, respawn,
the session map, the autoscaler over signal traces, ``fleet_signals``, the
rolling update's abort, replica skew and the fleet metrics' rollup — runs
on fake replicas (an injected ``spawn_fn``, stub processes, a fake clock)
in BOTH packages from the same inputs, and each test holds the two
records equal.  Then a live fleet: two in-process port ``FlowServer``s
(raft-small, 1 iteration, bucket 32x48, streaming on, one shared AOT
engine cache) behind the port's ``FleetRouter``: each routed flow bitwise
the port's direct call on the same weights and within the full-model
bound ``1e-3 + 1e-3 * max|flow|`` of the JAX package's; stream affinity, a
rolling hot-swap under a stream with no drop and no serve-time capture,
the roll's 409 abort, the metrics and history endpoints, and, last, a
killed replica's session migrating.  Every HTTP call has a timeout."""

import copy
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.fleet as jax_fleet
import raft_tpu.fleet.manager as jax_manager
import raft_tpu.fleet.router as jax_router
from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.models.raft import make_inference_fn as jax_inference_fn
import raft_tpu_torch as rt
from raft_tpu_torch import _build
import raft_tpu_torch.fleet as port_fleet
import raft_tpu_torch.fleet.manager as port_manager
import raft_tpu_torch.fleet.router as port_router
from raft_tpu_torch.convert.weights import save_params_npz
from raft_tpu_torch.serving import FlowServer, ServeConfig
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

TIMEOUT = 60
PKGS = {"jax": (jax_fleet, jax_manager, jax_router),
        "port": (port_fleet, port_manager, port_router)}


def both(scenario):
    """``scenario(fleet, manager_module, router_module)`` in each package;
    asserts the two records equal and returns the port's."""
    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# ---------------------------------------------------------------------------
# fakes (tests/test_fleet.py's)
# ---------------------------------------------------------------------------

class FakeProc:
    """Popen-shaped stub; ``kill()`` is what a SIGKILL'd child looks like
    to the manager (poll() flips non-None)."""

    def __init__(self, on_stop=None):
        self.returncode = None
        self._on_stop = on_stop

    def poll(self):
        return self.returncode

    def terminate(self):
        self._exit(0)

    def kill(self):
        self._exit(-9)

    def wait(self, timeout=None):
        return self.returncode

    def _exit(self, code):
        if self.returncode is None:
            self.returncode = code
            if self._on_stop is not None:
                self._on_stop()


def fake_fleet(fl, n=2, **overrides):
    kw = dict(replicas=n, health_poll_s=60.0, restart_dead=False,
              spawn_timeout_s=5.0)
    kw.update(overrides)
    config = fl.FleetConfig(**kw)

    def spawn(rep):
        return FakeProc(), f"http://127.0.0.1:{10000 + rep.idx}"

    manager = fl.ReplicaManager(config, out_dir="/tmp", spawn_fn=spawn)
    for _ in range(n):
        manager._spawn_one()
    return config, manager


def states(manager):
    return sorted((r.idx, r.state) for r in manager.replicas())


# ---------------------------------------------------------------------------
# config, parsing, taxonomy
# ---------------------------------------------------------------------------

BAD_CONFIGS = [dict(replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(replicas=5, max_replicas=2), dict(health_poll_s=0),
               dict(unhealthy_after=0), dict(forward_retries=-1),
               dict(trace_sample=1.5), dict(up_after=0),
               dict(history_window=1), dict(skew_window_s=0),
               dict(skew_factor=1.0)]


def test_config_defaults_and_validation_equal():
    import dataclasses

    def scenario(fl, _m, _r):
        rejected = []
        for kw in BAD_CONFIGS:
            try:
                fl.FleetConfig(**kw)
                rejected.append(False)
            except ValueError:
                rejected.append(True)
        return dataclasses.asdict(fl.FleetConfig()), rejected
    _, rejected = both(scenario)
    assert all(rejected)


def test_prom_parsing_and_status_taxonomy_equal():
    text = ("# HELP raft_serving_queue_depth d\n"
            "raft_serving_queue_depth 3\n"
            "raft_serving_queue_limit 16\n"
            'raft_serving_requests_total{status="shed"} 2\n'
            "garbage line without value\n"
            'raft_x{a="1",b="two"} -4.5e-3\n')

    def scenario(_f, m, r):
        return (m.parse_prom_text(text),
                [r.status_class(s) for s in range(100, 600, 7)])
    parsed, _ = both(scenario)
    assert parsed['raft_serving_requests_total{status="shed"}'] == 2.0


# ---------------------------------------------------------------------------
# picks, scaling, respawn, the session map
# ---------------------------------------------------------------------------

def test_least_loaded_picks_equal():
    def scenario(fl, _m, r):
        config, manager = fake_fleet(fl, 3)
        router = fl.FleetRouter(config, manager)
        seq = []
        held = [router._pick(), router._pick(), router._pick(exclude={2})]
        seq += [p.idx for p in held]
        manager.get(0).prom = {"raft_serving_queue_depth": 8.0,
                               "raft_serving_queue_limit": 16.0}
        seq.append(router._pick(exclude={1}).idx)
        for p in held:
            router._unpick(p.idx)
        seq.append(router.total_inflight())
        manager.get(0).updating = True
        seq += [router._pick().idx for _ in range(3)]
        for rep in manager.replicas():
            rep.updating = True
        seq.append(router._pick().idx)
        for rep in manager.replicas():
            rep.state = "dead"
        try:
            router._pick()
        except r.NoReplica:
            seq.append("no_replica")
        return seq
    assert both(scenario)[-1] == "no_replica"


def test_scale_to_and_respawn_equal():
    def scenario(fl, _m, _r):
        config, manager = fake_fleet(fl, 3, max_replicas=4)
        out = [manager.scale_to(1), states(manager), manager.desired]
        out += [manager.scale_to(99), manager.ready_count(),
                manager.scale_to(0)]
        config, manager = fake_fleet(fl, 2, restart_dead=True)
        manager.get(0).proc.kill()
        manager.poll_once()
        deadline = time.monotonic() + 10
        while manager.ready_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        out += [states(manager), manager.restarts,
                sorted(r.idx for r in manager.routable())]
        return out
    got = both(scenario)
    assert got[-1] == [1, 2] and got[-2] == 1


def test_admin_scale_clamps_and_rejects():
    """``POST /admin/scale?replicas=N``, an endpoint of the port's router
    alone (the JAX router has none): ``scale_to`` clamped to
    [min_replicas, max_replicas]; a missing or non-integer count is a
    400 that leaves the fleet as it was."""
    config, manager = fake_fleet(port_fleet, 3, min_replicas=2,
                                 max_replicas=4, port=0)
    router = port_fleet.FleetRouter(config, manager)
    router.start()
    try:
        for query in ("?replicas=two", ""):
            status, _, body = _post(router, "/admin/scale" + query, None,
                                    raw=b"")
            assert status == 400 and b"integer" in body, (query, body)
            assert manager.desired == 3 and manager.ready_count() == 3
        for n, want in ((1, 2), (99, 4), (3, 3)):
            status, _, body = _post(router, f"/admin/scale?replicas={n}",
                                    None, raw=b"")
            got = json.loads(body)
            assert status == 200 and got["desired"] == want, (n, got)
            assert manager.ready_count() == want
            assert len([r for r in got["replicas"]
                        if r["state"] == "ready"]) == want
    finally:
        router.stop()


def test_session_map_equal():
    def scenario(fl, _m, _r):
        m = fl.FleetSessionMap()
        frame = np.zeros((1, 4, 4, 3), np.float32)
        s = m.create(0, "backend-1", frame)
        t = m.create(1, "backend-2", frame)
        out = [m.get(s.rsid) is s, m.count(), len(m.on_replica(0)),
               len(m.on_replica(2)), len(s.rsid)]
        s.last_used -= 7200.0
        out += [m.reap(ttl_s=3600.0), m.get(s.rsid) is None,
                m.remove(t.rsid) is t, m.remove("nope"), m.count()]
        return out
    both(scenario)


# ---------------------------------------------------------------------------
# the autoscaler, its signals, the rolling update
# ---------------------------------------------------------------------------

CALM = {"burn": 0.0, "queue_frac": 0.0, "breaker_open": False,
        "shed_rate": 0.0}
HOT = {"burn": 2.0, "queue_frac": 0.9, "breaker_open": False,
       "shed_rate": 0.0}
TRACES = {
    "hot_calm_hot": [HOT, CALM, HOT] * 2,
    "hot": [HOT] * 6,
    "calm": [CALM] * 10,
    "shed_then_breaker": [dict(CALM, shed_rate=3.0),
                          dict(CALM, breaker_open=True)] * 2,
    "anomaly": [dict(CALM, anomaly=1.0)] * 5,
    "mixed": [HOT, HOT, CALM, dict(HOT, burn=0.5, queue_frac=0.3), CALM,
              CALM, CALM, CALM, CALM, CALM, HOT, HOT],
}


@pytest.mark.parametrize("trace", list(TRACES))
def test_autoscaler_decisions_equal(trace):
    """The same signal trace and fake clock: the same decisions, desired
    sizes and events (the clock passes the cooldown half-way)."""
    def scenario(fl, _m, _r):
        config, manager = fake_fleet(fl, 2, min_replicas=1, max_replicas=3,
                                     up_after=2, down_after=3,
                                     cooldown_s=100.0)
        clock = {"t": 0.0}
        it = iter(TRACES[trace])
        scaler = fl.Autoscaler(config, manager, signals_fn=lambda: next(it),
                               now_fn=lambda: clock["t"])
        out = []
        for i in range(len(TRACES[trace])):
            if i == len(TRACES[trace]) // 2:
                clock["t"] = 200.0
            out.append((scaler.step(), manager.desired))
        return out, scaler.events
    both(scenario)


def test_fleet_signals_equal():
    scrapes = [
        {0: {'raft_slo_burn_rate{objective="pair"}': 0.4,
             "raft_serving_queue_depth": 8.0,
             "raft_serving_queue_limit": 16.0,
             'raft_serving_requests_total{status="shed"}': 5.0,
             'raft_anomaly_active{rule="p95_drift"}': 1.0},
         1: {'raft_slo_burn_rate{objective="pair"}': 1.5,
             "raft_serving_queue_depth": 0.0,
             "raft_serving_queue_limit": 16.0, "raft_breaker_state": 2.0}},
        {0: {'raft_serving_requests_total{status="shed"}': 9.0,
             'raft_serving_requests_total{status="breaker_open"}': 2.0,
             "raft_serving_queue_limit": 16.0},
         1: {"raft_serving_queue_limit": 0.0}},
        {0: {'raft_serving_requests_total{status="shed"}': 9.0,
             'raft_serving_requests_total{status="breaker_open"}': 2.0}},
    ]

    def scenario(fl, _m, _r):
        _, manager = fake_fleet(fl, 2)
        prev, out = {}, []
        for scrape in scrapes:
            for idx, prom in scrape.items():
                manager.get(idx).prom = prom
            out.append(fl.fleet_signals(manager, prev))
        manager.get(1).state = "dead"
        out.append(fl.fleet_signals(manager, prev))
        return out
    got = both(scenario)
    assert got[0]["burn"] == 1.5 and got[1]["shed_rate"] == 6.0


def test_rolling_update_abort_equal():
    def scenario(fl, _m, _r):
        _, manager = fake_fleet(fl, 3)
        updater = fl.RollingUpdater(manager)
        seen = []

        def push(rep, body, tag):
            seen.append((rep.idx, rep.updating))
            if rep.idx == 1:
                return 409, {"error": "param tree structure differs"}
            return 200, {"weights": {"version": 2, "tag": tag}}
        updater._push = push
        results = updater.roll(b"npz-bytes", tag="v2")
        return results, seen, [r.updating for r in manager.replicas()]
    results, seen, _ = both(scenario)
    assert [r["status"] for r in results] == ["reloaded", "failed", "skipped"]
    assert seen == [(0, True), (1, True)]


# ---------------------------------------------------------------------------
# skew, the metrics rollup, health aggregation
# ---------------------------------------------------------------------------

def _lat_scrape(pairs, b01, b1):
    return {"raft_serving_pairs_total": float(pairs),
            'raft_serving_request_latency_seconds_bucket{le="0.1"}':
                float(b01),
            'raft_serving_request_latency_seconds_bucket{le="1"}': float(b1),
            'raft_serving_request_latency_seconds_bucket{le="+Inf"}':
                float(b1),
            "raft_serving_request_latency_seconds_sum": float(b1) * 0.05,
            "raft_serving_request_latency_seconds_count": float(b1)}


SKEW_ROUNDS = [
    {i: (0, 0, 0) for i in range(3)},
    {0: (100, 100, 100), 1: (100, 100, 100), 2: (100, 0, 100)},
    {0: (200, 200, 200), 1: (200, 200, 200), 2: (200, 200, 200)},
]


@pytest.mark.parametrize("n", [3, 2])
def test_skew_detection_equal(n):
    def scenario(fl, _m, _r):
        config, manager = fake_fleet(fl, n)
        router = fl.FleetRouter(config, manager)
        out = []
        for rnd in SKEW_ROUNDS:
            for idx, args in rnd.items():
                if idx < n:
                    rep = manager.get(idx)
                    rep.prom = _lat_scrape(*args)
                    router._replica_polled(rep)
            picks = []
            for _ in range(4):
                p = router._pick()
                picks.append(p.idx)
                router._unpick(p.idx)
            out.append((router.skewed(), router.skew_count(), picks,
                        sorted(router.fleet_history.sources())))
        router._replica_died(manager.get(n - 1))
        out.append(sorted(router.fleet_history.sources()))
        return out
    got = both(scenario)
    assert got[1][0] == ([2] if n == 3 else [])


def test_fleet_metrics_render_and_health_equal():
    def scenario(fl, m, _r):
        config, manager = fake_fleet(fl, 3)
        router = fl.FleetRouter(config, manager)
        manager.get(0).prom = {"raft_serving_pairs_total": 300.0,
                               'raft_serving_requests_total{status="ok"}': 30.0,
                               "raft_serving_queue_depth": 2.0}
        manager.get(1).prom = {"raft_serving_pairs_total": 100.0,
                               'raft_serving_requests_total{status="ok"}': 10.0,
                               "raft_serving_queue_depth": 1.0}
        manager.get(2).prom = {"raft_serving_pairs_total": 999.0}
        health = [router.health()]
        manager.get(2).state = "dead"
        text = router.render_fleet_metrics()
        health.append(router.health())
        for rep in manager.replicas():
            rep.state = "dead"
        health.append(router.health())
        families = sorted({ln.split()[2] for ln in
                           router.registry.render().splitlines()
                           if ln.startswith("# TYPE")})
        return text, m.parse_prom_text(text), health, families
    text, parsed, health, _ = both(scenario)
    assert 'raft_serving_pairs_total{replica="all"} 400' in text
    assert parsed['raft_serving_queue_depth{replica="all"}'] == 3.0
    assert [h[0] for h in health] == [200, 200, 503]


# ---------------------------------------------------------------------------
# live fleet: two port FlowServers behind the port's router
# ---------------------------------------------------------------------------

JCFG = JaxConfig.small_model(iters=1)
PCFG = rt.RAFTConfig.small_model(iters=1)
HW = (32, 48)


@pytest.fixture(scope="module", autouse=True)
def build_root():
    """The live replicas attach a cache, which points ``_build`` at the
    cache's kernels; the module leaves it where it found it."""
    root = _build.BUILD_ROOT
    yield
    _build.use_root(root)


@pytest.fixture(scope="module")
def live_fleet(tmp_path_factory):
    """Two in-process port replicas (each its own copy of the weights and
    its own engine, one shared engine-cache directory) behind the port's
    FleetRouter.  ``restart_dead=False`` so the kill test (last in this
    file) is deterministic."""
    out = tmp_path_factory.mktemp("fleet")
    params = seeded_jax_params(JCFG, seed=9)
    model = rt.RAFT(PCFG)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    model.eval()
    sconfig = ServeConfig(buckets=(HW,), max_batch=1, batch_steps=(1,),
                          max_wait_ms=5.0, queue_depth=16,
                          default_deadline_ms=30_000.0, port=0,
                          max_sessions=2, session_ttl_s=600.0,
                          engine_cache_dir=str(out / "engine-cache"))
    servers = {}

    def spawn(rep):
        server = FlowServer(PCFG, copy.deepcopy(model), sconfig, iters=1)
        server.start()
        servers[rep.idx] = server
        return FakeProc(on_stop=lambda: server.stop(drain=False)), server.url

    fconfig = port_fleet.FleetConfig(replicas=2, port=0, health_poll_s=60.0,
                                     restart_dead=False, forward_retries=2,
                                     trace_sample=1.0)
    manager = port_fleet.ReplicaManager(fconfig, out_dir=str(out),
                                        spawn_fn=spawn)
    for _ in range(2):
        manager._spawn_one()
    manager.poll_once()
    router = port_fleet.FleetRouter(fconfig, manager, out_dir=str(out))
    router.updater = port_fleet.RollingUpdater(manager,
                                               metrics=router.metrics)
    router.start()
    try:
        yield router, manager, servers, model, params
    finally:
        router.stop()
        for server in servers.values():
            try:
                server.stop(drain=False)
            except Exception:
                pass


def _post(router, path, payload, headers=None, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    h = {"Content-Type": ("application/octet-stream" if raw is not None
                          else "application/json")}
    h.update(headers or {})
    req = urllib.request.Request(router.url + path, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.getheaders()), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.rand(*HW, 3).astype(np.float32) for _ in range(n)]


def test_live_fleet_health_and_shared_cache(live_fleet):
    router, manager, servers, _, _ = live_fleet
    status, payload = router.health()
    assert status == 200 and payload["status"] == "ok"
    assert payload["ready"] == 2 and payload["desired"] == 2
    assert all(r["weights"]["version"] == 1 for r in payload["replicas"])
    # replica 0 wrote the shared directory, replica 1 hit every key of it
    st = [servers[i].engine_cache.stats for i in (0, 1)]
    assert (st[0].hits, st[0].saves, st[1].hits, st[1].misses) == (0, 6, 6, 0)
    assert servers[0].engine_cache.dir == servers[1].engine_cache.dir


def test_live_fleet_flows_bitwise_direct_and_close_to_jax(live_fleet):
    router, _, _, model, params = live_fleet
    direct = rt.make_inference_fn(PCFG, device="cpu")
    jfn = jax.jit(jax_inference_fn(JCFG))
    seen = set()
    for seed in (60, 61):
        f1, f2 = _frames(seed, 2)
        want = direct(model, f1[None], f2[None])[0].numpy()
        jflow = np.asarray(jfn(params, jnp.asarray(f1[None]),
                               jnp.asarray(f2[None])))[0]
        for _ in range(2):
            st, headers, body = _post(router, "/v1/flow",
                                      {"image1": f1.tolist(),
                                       "image2": f2.tolist()})
            assert st == 200
            seen.add(headers["X-Raft-Replica"])
            got = np.asarray(json.loads(body)["flow"], np.float32)
            np.testing.assert_array_equal(got, want)
            bound = 1e-3 + 1e-3 * float(np.abs(jflow).max())
            assert float(np.abs(got - jflow).max()) <= bound
    assert seen <= {"0", "1"}
    assert router.metrics["requests"].labels("ok").value >= 4


def test_live_fleet_stream_affinity_and_unknown_session(live_fleet):
    router, _, _, _, _ = live_fleet
    frames = _frames(62, 4)
    st, h, body = _post(router, "/v1/stream", {"op": "open",
                                               "image": frames[0].tolist()})
    assert st == 200
    sid, pinned = json.loads(body)["session"], h["X-Raft-Replica"]
    for fr in frames[1:]:
        st, h, body = _post(router, "/v1/stream",
                            {"session": sid, "image": fr.tolist()})
        assert st == 200 and h["X-Raft-Replica"] == pinned
        assert json.loads(body)["meta"]["migrated"] is False
    assert _post(router, "/v1/stream", {"op": "close",
                                        "session": sid})[0] == 200
    assert router.sessions.count() == 0
    st, _, body = _post(router, "/v1/stream", {"session": "deadbeef",
                                               "image": frames[0].tolist()})
    assert st == 404 and "unknown session" in json.loads(body)["error"]


def test_live_fleet_hot_swap_rolls_without_drops_or_captures(live_fleet):
    router, _, servers, model, _ = live_fleet
    frames = _frames(63, 6)
    st, _, body = _post(router, "/v1/stream", {"op": "open",
                                               "image": frames[0].tolist()})
    sid = json.loads(body)["session"]
    misses0 = {i: s.engine.compile_misses for i, s in servers.items()}
    versions0 = {i: s.engine.weight_info()["version"]
                 for i, s in servers.items()}
    buf = io.BytesIO()
    save_params_npz(model.state_dict(), buf)
    statuses, done = [], threading.Event()

    def advance_loop():
        for fr in frames[1:]:
            statuses.append(_post(router, "/v1/stream",
                                  {"session": sid, "image": fr.tolist()})[0])
        done.set()
    t = threading.Thread(target=advance_loop)
    t.start()
    st, _, body = _post(router, "/admin/reload", None, raw=buf.getvalue(),
                        headers={"X-Raft-Weight-Tag": "test-roll"})
    assert done.wait(TIMEOUT)
    t.join(5.0)
    assert st == 200, body
    result = json.loads(body)
    assert [r["status"] for r in result["replicas"]] == ["reloaded"] * 2
    assert statuses == [200] * (len(frames) - 1)
    for i, server in servers.items():
        assert server.engine.compile_misses == misses0[i]
        info = server.engine.weight_info()
        assert info == {"version": versions0[i] + 1, "tag": "test-roll"}
    assert router.metrics["hot_swaps"].value == 2.0
    _post(router, "/v1/stream", {"op": "close", "session": sid})
    # a tree of other names and shapes: 409 on the first replica, the rest
    # skipped (the port answers 400 for an npz it cannot read at all)
    bad = io.BytesIO()
    np.savez(bad, **{"cnet/conv1/w": np.zeros((3, 3, 3, 8), np.float32)})
    st, _, body = _post(router, "/admin/reload", None, raw=bad.getvalue())
    result = json.loads(body)
    assert st == 409 and result["status"] == "partial"
    assert [r["status"] for r in result["replicas"]] == ["failed", "skipped"]
    for i, server in servers.items():
        assert server.engine.weight_info()["version"] == versions0[i] + 1


def test_live_fleet_metrics_and_history_endpoints(live_fleet):
    router, manager, _, _, _ = live_fleet
    manager.poll_once()
    manager.poll_once()
    with urllib.request.urlopen(router.url + "/metrics/fleet",
                                timeout=TIMEOUT) as r:
        text = r.read().decode()
    parsed = port_manager.parse_prom_text(text)
    assert parsed['raft_serving_queue_limit{replica="all"}'] == \
        parsed['raft_serving_queue_limit{replica="0"}'] \
        + parsed['raft_serving_queue_limit{replica="1"}']
    assert parsed['raft_engine_cache_hits_total{replica="all"}'] == 6.0
    with urllib.request.urlopen(router.url + "/debug/history",
                                timeout=TIMEOUT) as r:
        body = json.loads(r.read())
    assert set(body["sources"]) == {"0", "1"} and body["skewed"] == []
    assert "pairs_per_s" in body["sources"]["0"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(router.url + "/debug/history?window=junk",
                               timeout=TIMEOUT)
    assert ei.value.code == 400


def test_live_fleet_kill_migrates_the_session(live_fleet):
    """Runs LAST: the killed replica stays dead.  The migrated advance is
    the survivor's cold first advance after opening the previous frame;
    its flow is held to the survivor's pairwise answer on the same frames
    within the full-model bound (two different graphs, one input)."""
    router, manager, _, _, _ = live_fleet
    frames = _frames(65, 3)
    st, h, body = _post(router, "/v1/stream", {"op": "open",
                                               "image": frames[0].tolist()})
    sid, pinned = json.loads(body)["session"], int(h["X-Raft-Replica"])
    assert _post(router, "/v1/stream", {"session": sid,
                                        "image": frames[1].tolist()})[0] == 200
    manager.kill(pinned)
    manager.poll_once()
    assert manager.get(pinned).state == "dead"
    st, h, body = _post(router, "/v1/stream", {"session": sid,
                                               "image": frames[2].tolist()})
    assert st == 200
    resp = json.loads(body)
    assert resp["meta"]["migrated"] is True
    assert resp["meta"]["replica"] != pinned
    st, _, body = _post(router, "/v1/flow", {"image1": frames[1].tolist(),
                                             "image2": frames[2].tolist()})
    want = np.asarray(json.loads(body)["flow"], np.float32)
    got = np.asarray(resp["flow"], np.float32)
    assert float(np.abs(got - want).max()) <= \
        1e-3 + 1e-3 * float(np.abs(want).max())
    assert router.metrics["migrations"].value == 1.0
    status, payload = router.health()
    assert status == 200 and payload["status"] == "degraded"
    assert payload["ready"] == 1
    _post(router, "/v1/stream", {"op": "close", "session": sid})
