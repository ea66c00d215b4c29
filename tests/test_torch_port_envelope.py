"""The capacity half of the port's lint (``raft_tpu_torch/lint/budget.py``)
and the two serving faults this slice closes.

* The kernels' launch envelopes: the Python mirror of each kernel
  source's constants equals the ``constexpr``s read from ``csrc/*.cu``,
  the shared-memory expressions are the sources' own, the blocks-per-SM
  rule follows the occupancy rules, and every entry fits the H100's
  limits (the card holds the same figures to the sources' queries and to
  ``cudaFuncGetAttributes``: ``chip_smoke.py``).
* The graph pools: priced from fake tensors for a serving grid and a
  train step, each key's peak above what it keeps.
* C9: an engine-cache hit still refuses other weights, another key's
  graph and another cuDNN mode.
* C8: the batcher wakes a group's handlers only after every row's spans
  are recorded; the tracer's ids.
"""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.lint import budget

torch.set_num_threads(2)   # several test workers share the host's cores

CSRC = Path(__file__).resolve().parent.parent / "raft_tpu_torch" / "csrc"


def _constexprs(source: str) -> dict:
    """Namespace-scope ``constexpr int NAME = EXPR;`` of a kernel source,
    each evaluated with the names before it (plain integer arithmetic)."""
    out = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", source, re.M):
        for part in decl.split(","):
            name, expr = (x.strip() for x in part.split("=", 1))
            out[name] = int(eval(expr, {}, dict(out)))   # noqa: S307
    return out


CORR_SRC = (CSRC / "corr_lookup.cu").read_text()
GRU_SRC = (CSRC / "sep_conv_gru.cu").read_text()


def test_corr_constants_equal_the_source():
    c = _constexprs(CORR_SRC)
    for name in ("kWarps", "kTileH", "kTileW", "kChunk", "kRowWords",
                 "kMaxWin", "kMmaMaxWin"):
        assert budget.CORR_KERNEL[name] == c[name], name
    assert "__launch_bounds__(kThreads, 2)" in CORR_SRC
    assert budget.CORR_KERNEL["launch_bounds_min_blocks"] == 2
    env = budget.corr_envelope(False, 256, 4)
    tile = c["kTile"]
    # the source's launch(): mma ? kStagingBytes + kTile*nwin*4 : ...
    assert ("const int smem = mma_ok ? kStagingBytes + kTile * nwin * 4 : "
            "kWarps * nwin * 4;") in CORR_SRC
    assert env["dynamic_smem"] == c["kStagingBytes"] + tile * 100 * 4
    assert env["opt_in_smem"] == (c["kStagingBytes"]
                                  + tile * c["kMmaMaxWin"] ** 2 * 4)
    assert env["threads"] == c["kThreads"]
    # the kernel's static arrays: three int and two float arrays of kTile
    assert "__shared__ int s_ix0[kTile], s_iy0[kTile], s_state[kTile];" \
        in CORR_SRC
    assert "__shared__ float s_fx[kTile], s_fy[kTile];" in CORR_SRC
    assert "__shared__ int s_box[5];" in CORR_SRC
    assert CORR_SRC.count("__shared__") == 4      # and the extern buffer
    # 1300 bytes, padded to 16 (what cudaFuncGetAttributes reports)
    assert env["static_smem"] == 1312 == -(-(5 * tile * 4 + 20) // 16) * 16
    gather = budget.corr_envelope(False, 256, 8)      # 2r+2 = 18 > 16
    assert not gather["mma"] and gather["dynamic_smem"] == \
        c["kWarps"] * 18 * 18 * 4


@pytest.mark.parametrize("bf16,C,nv,vec", [(False, 256, 2, 1),
                                           (False, 128, 1, 1),
                                           (False, 512, 4, 1),
                                           (True, 256, 1, 1),
                                           (True, 512, 2, 1),
                                           (False, 130, 4, 0)])
def test_corr_instantiation_follows_run(bf16, C, nv, vec):
    env = budget.corr_envelope(bf16, C, 4)
    assert (env["nv"], env["vec"]) == (nv, vec)
    assert env["instantiation"].startswith(
        "corr_lookup_kernel<" + ("__nv_bfloat16" if bf16 else "float"))


def test_gru_constants_and_launches_equal_the_source():
    c = _constexprs(GRU_SRC)
    for name in ("kTaps", "kHalo", "BN", "kWarps", "kStages"):
        assert budget.GRU_KERNEL[name] == c[name], name
    assert "__launch_bounds__(kThreads, 2)" in GRU_SRC
    launched = re.findall(r"launch<(\d), (true|false), TIO, (true|false), "
                          r"TF32, (\d+)>", GRU_SRC)
    # run() issues pass 1 then pass 2 of each GEMM: z/r (MODE 0), q (1)
    want = sorted((int(m), v == "true", p == "true", int(bm))
                  for m, v, p, bm in launched)
    assert sorted(budget.GRU_LAUNCHES) == want
    assert ("static constexpr int kSmemBytes = (kStages * kStageWords + "
            "kPlanes * kRows * 8) * 4;") in GRU_SRC
    f32 = budget.gru_envelopes(False)
    # TF32 entry: 8-word A rows, 4 weight words, no piece planes
    assert f32[0]["dynamic_smem"] == 3 * ((128 + 4) * 8 + 5 * 64 * 4 * 4) * 4
    bf = budget.gru_envelopes(True)
    # bf16 entry, pass 2's z/r GEMM: a float32 h1 in 3 bf16 pieces
    assert bf[2]["dynamic_smem"] == (3 * ((128 + 4) * 16 + 5 * 64 * 4 * 2)
                                     + 3 * (128 + 4) * 8) * 4


def test_blocks_per_sm_follows_the_occupancy_rules():
    assert budget.blocks_per_sm(256, 88320, 128) == (2, "shared memory")
    assert budget.blocks_per_sm(256, 43392, 64) == (4, "registers")
    assert budget.blocks_per_sm(256, 0, 32) == (8, "threads")
    assert budget.blocks_per_sm(64, 0, 16)[0] == 32
    # 129 registers round up to 136 a thread: one block of 256 threads
    assert budget.blocks_per_sm(256, 1024, 129) == (1, "registers")


@pytest.mark.parametrize("config", ["full", "small"])
def test_every_entry_fits_the_h100(config):
    cfg = getattr(RAFTConfig, "full" if config == "full"
                  else "small_model")()
    rep = budget.kernel_envelopes(cfg)
    assert not rep["violations"]
    kernels = {e["kernel"] for e in rep["entries"]}
    assert kernels == {"B1", "B2", "B3", "B4", "B5"}
    assert len([e for e in rep["entries"] if e["kernel"] == "B2"]) == 8
    tight = dict(budget.H100_LIMITS, smem_per_block=64 * 1024)
    assert budget.kernel_envelopes(cfg, limits=tight)["violations"]
    # registers the launch bounds cannot hold: fewer blocks than promised
    inst = rep["entries"][0]["instantiation"]
    assert budget.kernel_envelopes(cfg, regs={inst: 168})["violations"]


def test_serving_pools_priced_from_fake_tensors():
    from raft_tpu_torch.serving import ServeConfig
    cfg = RAFTConfig.small_model(iters=2)
    sc = ServeConfig(buckets=((32, 48),), max_batch=2, max_sessions=2)
    rep = budget.serving_pool_prices(cfg, sc)
    kinds = [k["key"][0] for k in rep["keys"]]
    assert kinds == ["pair", "pair", "encode", "stream", "sbatch", "sbatch"]
    for k in rep["keys"]:
        assert k["peak_bytes"] >= k["kept_bytes"] > 0
        assert k["growth_bytes"] >= 0
    pair = rep["pools"]["pair"]
    b1, b2 = rep["keys"][:2]
    assert pair["live_price"] == max(b1["peak_bytes"],
                                     b1["kept_bytes"] + b2["peak_bytes"])
    # the allocator reserves whole segments: at least the live bound
    assert pair["price"] >= pair["live_price"]
    assert pair["price"] == b1["growth_bytes"] + b2["growth_bytes"]
    assert rep["total_bytes"] == sum(p["price"]
                                     for p in rep["pools"].values())


def test_pool_sim_follows_the_caching_allocator():
    sim = budget._PoolSim()
    a = sim.alloc(100)                     # small: a 2 MiB segment
    assert sim.reserved == 2 << 20
    b = sim.alloc(3 << 20)                 # 1-10 MiB: a 20 MiB segment
    assert sim.reserved == 22 << 20
    c = sim.alloc(5 << 20)                 # split from the 20 MiB one
    assert sim.reserved == 22 << 20
    sim.free(b)
    sim.free(c)                            # merged back: 20 MiB free
    d = sim.alloc(15 << 20)
    assert sim.reserved == 22 << 20
    sim.alloc((33 << 20) + 1)              # its own segment, 2 MiB units
    assert sim.reserved == (22 + 34) << 20
    sim.free(a)
    sim.free(d)


def test_train_pool_grows_with_the_batch():
    cfg = RAFTConfig.small_model(iters=2)
    tc = TrainConfig(batch_size=2, image_size=(32, 48))
    one = budget.train_pool_price(cfg, tc, 1, 32, 48)
    two = budget.train_pool_price(cfg, tc, 2, 32, 48)
    assert 0 < one["peak_bytes"] < two["peak_bytes"]


# -- C9: what an engine-cache hit proves ---------------------------------

def _cache_engine(root, seed=0, cudnn="benchmark"):
    from raft_tpu_torch.models.raft import init_raft_torch
    from raft_tpu_torch.serving import ServeConfig
    from raft_tpu_torch.serving.aot_cache import EngineCache
    from raft_tpu_torch.serving.engine import InferenceEngine
    cfg = RAFTConfig.small_model(iters=1)
    model = init_raft_torch(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    sc = ServeConfig(buckets=((32, 48),), max_batch=1, max_sessions=0,
                     cudnn=cudnn)
    cache = EngineCache(root, cfg, model, cudnn=cudnn)
    eng = InferenceEngine(cfg, model, sc, iters=1, cache=cache)
    eng.warmup(verbose=False)
    return eng, cache


def test_cache_hit_refuses_other_weights_key_and_cudnn_mode(tmp_path):
    from raft_tpu_torch.serving.aot_cache import key_filename
    eng, cache = _cache_engine(tmp_path)
    assert cache.stats.saves == 1 and cache.stats.hits == 0
    eng, cache = _cache_engine(tmp_path)
    assert cache.stats.hits == 1 and cache.stats.misses == 0
    # other weights: another identity, every key misses
    eng, cache = _cache_engine(tmp_path, seed=1)
    assert cache.stats.hits == 0 and cache.stats.misses == 1
    # another cuDNN mode: another identity
    eng, cache = _cache_engine(tmp_path, cudnn="heuristic")
    assert cache.stats.hits == 0 and cache.stats.misses == 1
    # another key's graph: the entry's digest is not this key's output
    eng, cache = _cache_engine(tmp_path)
    key = next(iter(eng._exec))
    path = cache.dir / key_filename(key)
    entry = path.read_text().replace(eng._digests[key][1], "0" * 64)
    path.write_text(entry)
    eng, cache = _cache_engine(tmp_path)
    assert cache.stats.hits == 0 and cache.stats.mismatches == 1


# -- C8: the handoff from the batcher back to the handlers ----------------

def test_group_wakes_after_every_rows_spans(monkeypatch):
    """A batch of 4 traced requests: each handler wakes (``finished_at``)
    only after the last row's execute span was recorded, so a woken
    handler never holds the interpreter while later rows' bookkeeping
    waits."""
    from raft_tpu_torch.serving.batcher import MicroBatcher
    from raft_tpu_torch.serving.queue import Request, RequestQueue
    from raft_tpu_torch.telemetry import spans

    stamped = []
    real_span = spans.RequestTrace.span

    def span(self, name, *a, **kw):
        sid = real_span(self, name, *a, **kw)
        if name == "execute":
            stamped.append(time.monotonic())
        return sid
    monkeypatch.setattr(spans.RequestTrace, "span", span)
    gate = threading.Event()

    def run(bucket, im1, im2):
        assert gate.wait(30)
        return np.zeros(im1.shape[:3] + (2,), np.float32)
    q = RequestQueue(16)
    b = MicroBatcher(q, run, lambda n: 4, 4, 50.0)
    b.start()
    tracer = spans.Tracer(1.0)
    reqs = []
    try:
        for _ in range(4):
            im = np.zeros((1, 8, 8, 3), np.float32)
            r = Request(im, im, (8, 8), (0, 0, 0, 0),
                        deadline=time.monotonic() + 30)
            r.trace = tracer.start("pair")
            q.submit(r)
            reqs.append(r)
        gate.set()
        for r in reqs:
            r.wait(30)
    finally:
        q.close()
        b.join(10)
    assert len(stamped) == 4
    assert min(r.finished_at for r in reqs) >= max(stamped)
    for r in reqs:
        names = [s[0] for s in r.trace._spans]
        assert "execute" in names and "pad" in names


def test_trace_and_span_ids():
    from raft_tpu_torch.telemetry import spans
    tid = spans.new_trace_id()
    assert re.fullmatch(r"[0-9a-f]{32}", tid)
    ids = {spans.new_span_id() for _ in range(10000)}
    assert len(ids) == 10000
    assert all(re.fullmatch(r"[0-9a-f]{16}", s) for s in ids)
    tr = spans.Tracer(1.0).start("pair")
    t0 = tr.t0
    tr.span("admit", t0, t0 + 0.0012)
    tr.span("admit", t0, t0 + 0.001)
    assert tr.timings_ms() == {"admit": 2.2}
    rec = tr.finish()
    assert [s["name"] for s in rec["spans"]] == ["request", "admit", "admit"]
    assert rec["spans"][1]["parent"] == rec["spans"][0]["span"]
    assert rec["spans"][1]["dur_ms"] == 1.2


def test_cudnn_mode_is_validated_and_reaches_the_smoke():
    from raft_tpu_torch.serving import ServeConfig
    from raft_tpu_torch.tools import serve_bench
    assert ServeConfig().cudnn == "benchmark"
    with pytest.raises(ValueError):
        ServeConfig(cudnn="fastest")
    args = serve_bench.build_parser().parse_args(["--smoke"])
    assert serve_bench._serve_knobs(args) == {}
    args.cudnn = serve_bench.SMOKE_CUDNN
    assert serve_bench._serve_knobs(args) == {"cudnn": "heuristic"}


# -- C10: the profiler's session opens and closes with no replay in flight --

def test_profile_capture_quiesces_the_device(monkeypatch, tmp_path):
    """``capture_profile(quiesce=lock)`` holds the lock while the session
    starts and while it stops, and not during the window; a server passes
    its engine's device lock."""
    from raft_tpu_torch.telemetry import trace

    lock = threading.Lock()
    seen = []

    class Prof:
        def stop(self):
            seen.append(("stop", lock.locked()))

        def export_chrome_trace(self, path):
            seen.append(("export", lock.locked()))
            open(path, "w").write("{}")

    def start():
        seen.append(("start", lock.locked()))
        return Prof()
    monkeypatch.setattr(trace, "_profiler_warm", True)
    monkeypatch.setattr(trace, "_start_profiler", start)
    real_sleep = time.sleep

    def sleep(s):
        seen.append(("window", lock.locked()))
        real_sleep(0)
    monkeypatch.setattr(trace.time, "sleep", sleep)
    info = trace.capture_profile(str(tmp_path), 5.0, quiesce=lock)
    assert seen == [("start", True), ("window", False), ("stop", True),
                    ("export", False)]
    assert Path(info["trace_file"]).exists()

    from raft_tpu_torch.serving import FlowServer, ServeConfig
    got = {}
    monkeypatch.setattr(trace, "capture_profile",
                        lambda d, ms, log_fn=None, quiesce=None:
                        got.setdefault("quiesce", quiesce) or {})

    class Eng:
        _device_lock = lock

        def run(self, bucket, im1, im2):
            return np.zeros(im1.shape[:3] + (2,), np.float32)
    sc = ServeConfig(buckets=((8, 8),), port=0, max_sessions=0,
                     history_interval_s=0.0)
    server = FlowServer(RAFTConfig.small_model(), None, sc, engine=Eng())
    server.profile_capture(5.0)
    assert got["quiesce"] is lock


def test_server_freezes_its_heap_while_serving():
    """C8: a started server's heap leaves the collector's generations (a
    full collection over it paused the serving threads); stop() gives it
    back."""
    import gc
    from raft_tpu_torch.serving import FlowServer, ServeConfig

    class Eng:
        def run(self, bucket, im1, im2):
            return np.zeros(im1.shape[:3] + (2,), np.float32)
    sc = ServeConfig(buckets=((8, 8),), port=0, max_sessions=0,
                     history_interval_s=0.0)
    server = FlowServer(RAFTConfig.small_model(), None, sc, engine=Eng())
    before = gc.get_freeze_count()
    server.start()
    try:
        assert gc.get_freeze_count() > before
    finally:
        server.stop()
    assert gc.get_freeze_count() == 0
