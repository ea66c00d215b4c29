"""The port's streaming serving path against the JAX package's: the
engine's encode, solo stream step, slot-batched stream step and commit on
the same seeded frames and weights (dense and ragged), and the slot pool's
in-place discipline — a commit, a poison and a reset write into the pool's
own tensors and never move them (the stream batch step's CUDA graphs read
them by address), int8 rows round-trip as ``quantize_rows`` gives them —
and a live port server's sessions.

The port side runs on the CPU.  Feature maps are held at 5e-5
(``test_torch_port_stream.py``), flows at the full-model bound ``1e-3 +
1e-3 * max|flow|`` at 32x48 with 2 iterations.  No subprocess; servers
start in fixtures that stop them in ``finally``; every HTTP call and join
has a timeout of 30 s or less.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.serving import InferenceEngine as JaxEngine
from raft_tpu.serving import ServeConfig as JaxServeConfig
import raft_tpu_torch as rt
from raft_tpu_torch.serving import FlowServer, InferenceEngine, ServeConfig
from raft_tpu_torch.serving.session import (SlotPool, buffer_tensors,
                                            make_slot_commit_fn,
                                            make_slot_poison_fn, slot_shapes,
                                            zero_slot_buffers)
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

TIMEOUT = 30
BUCKET = (32, 48)
ITERS = 2
ENCODER_TOL = dict(rtol=5e-5, atol=5e-5)
JCFG = JaxConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
PCFG = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)


def assert_flow_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bound = 1e-3 + 1e-3 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|diff| {err:.3g} > {bound:.3g}"


def assert_maps_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **ENCODER_TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def weights():
    params = seeded_jax_params(JCFG, seed=4)
    model = rt.RAFT(PCFG)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, model.eval()


def video(seed, n, hw=BUCKET):
    """n frames [1, H, W, 3]: a texture drifting one pixel a frame, so
    consecutive frames carry motion."""
    rng = np.random.RandomState(seed)
    h, w = hw
    tex = rng.rand(h + n, w + n, 3).astype(np.float32)
    return [tex[None, k:k + h, k:k + w] for k in range(n)]


def _engines(weights, ragged=False):
    params, model = weights
    buckets = ((24, 32), BUCKET) if ragged else (BUCKET,)
    kw = dict(buckets=buckets, max_batch=2, max_sessions=2, warmup=False,
              ragged=ragged)
    return (JaxEngine(JCFG, params, JaxServeConfig(**kw), iters=ITERS,
                      stream=True),
            InferenceEngine(PCFG, model, ServeConfig(**kw), iters=ITERS,
                            stream=True))


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_stream_engine_matches_jax_over_two_frames(weights, ragged):
    """Open (encode) on frame 0, a solo stream step to frame 1 and its
    commit into slot 0, then a slot-batched step to frame 2 at a padded
    batch of 2 and its masked commit; every output and the pool's rows
    held to JAX's.  Ragged: the session is a 24x32 crop of the 32x48 box."""
    jeng, peng = _engines(weights, ragged)
    live = (24, 32) if ragged else BUCKET
    f = [rt.embed_to_shape(x, BUCKET) for x in video(5, 3, live)]
    sizes = np.asarray([live], np.int32) if ragged else None
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        fmap, cnet = eng.run_encode(BUCKET, f[0])
        init = np.zeros((1, 4, 6, 2), np.float32)
        step = eng.run_stream(BUCKET, f[1], fmap, cnet, init, sizes=sizes)
        seed = rt.warm_start_seed(np.asarray(step[1]), (4, 6))
        eng.commit_row(BUCKET, 0, step[2], step[3], seed)
        images = np.concatenate([f[2], f[2]])
        slots = np.asarray([0, eng.pool.scratch], np.int32)
        active = np.asarray([True, False])
        bsizes = None if sizes is None else np.concatenate([sizes, sizes])
        batch = eng.run_stream_batch(BUCKET, images, slots, active,
                                     sizes=bsizes)
        seeds = np.zeros((2, 4, 6, 2), np.float32)
        seeds[0] = rt.warm_start_seed(np.asarray(batch[1][:1]), (4, 6))[0]
        eng.commit_stream(BUCKET, slots, batch[2], batch[3], seeds, active)
        pool = [np.asarray(b) for b in eng.pool.buffers(BUCKET)]
        out[name] = (fmap, cnet, step, batch, pool)
    (jf, jc, js, jb, jp), (pf, pc, ps, pb, pp) = out["jax"], out["port"]
    crop = (slice(None), slice(0, live[0]), slice(0, live[1]))
    assert_maps_close(pf, jf, "encode fmap")
    assert_maps_close(pc, jc, "encode cnet")
    assert_flow_close(ps[0][crop], js[0][crop], "solo step flow")
    assert_maps_close(ps[2], js[2], "solo step fmap")
    assert_flow_close(pb[0][:1][crop], jb[0][:1][crop], "batch step flow")
    assert_maps_close(pb[2][:1], jb[2][:1], "batch step fmap rows")
    assert pb[4] is None and jb[4] is None                  # fixed policy
    for k, name in enumerate(("fmap", "cnet", "seed")):
        assert_maps_close(pp[k][:1], jp[k][:1], f"pool {name} slot 0")
    assert peng.stream_calls == jeng.stream_calls == 2
    assert peng.encode_calls == jeng.encode_calls == 1


def _pool(quant, cap=2, device="cpu"):
    cfg = rt.RAFTConfig.full(quant="int8" if quant else "none")
    return cfg, zero_slot_buffers(slot_shapes(cfg, cap, *BUCKET), device)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_commit_poison_reset_write_in_place(quant):
    cfg, bufs = _pool(quant)
    ptrs = [t.data_ptr() for t in buffer_tensors(bufs)]
    rng = np.random.RandomState(0)
    rows = [torch.from_numpy(rng.randn(2, 4, 6, c).astype(np.float32))
            for c in (cfg.fnet_dim, cfg.cnet_dim)]
    seeds = torch.from_numpy(rng.randn(2, 4, 6, 2).astype(np.float32))
    slots = torch.tensor([1, 2])                 # slot 2 is the scratch row
    out = make_slot_commit_fn(quant)(*bufs, slots, *rows, seeds,
                                     torch.tensor([True, False]))
    assert all(a is b for a, b in zip(out, bufs))
    assert [t.data_ptr() for t in buffer_tensors(bufs)] == ptrs
    for buf, r in zip(bufs[:2], rows):
        if quant:
            vals, scales = rt.quantize_rows(r[:1])
            assert torch.equal(buf[0][1:2], vals)
            assert torch.equal(buf[1][1:2], scales)
            assert float(buf[0][2].abs().max()) == 0 == float(buf[1][2].max())
        else:
            assert torch.equal(buf[1:2], r[:1])
            assert float(buf[2].abs().max()) == 0      # masked row kept
    assert torch.equal(bufs[2][1:2], seeds[:1])
    make_slot_poison_fn(quant)(bufs[0], torch.tensor([1]))
    poisoned = bufs[0][1] if quant else bufs[0]
    assert bool(torch.isnan(poisoned[1]).all())
    assert not bool(torch.isnan(poisoned[0]).any())
    for t in buffer_tensors(bufs):
        t.zero_()                                  # what reset_slots does
    assert [t.data_ptr() for t in buffer_tensors(bufs)] == ptrs


def test_int8_rows_round_trip_through_the_batch_step():
    """A committed int8 row, gathered by the stream batch step, is the
    dequantized quantize_rows of the committed float rows."""
    cfg = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1,
                             quant="int8")
    cfg_f = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                               iters=1)
    model = rt.init_raft_torch(cfg, device="cpu")
    sc = ServeConfig(buckets=(BUCKET,), max_batch=1, max_sessions=1)
    eng = InferenceEngine(cfg, model, sc, stream=True)
    eng.warmup(verbose=False)
    f = video(6, 3)
    fmap, cnet = eng.run_encode(BUCKET, f[0])
    seed = np.zeros((1, 4, 6, 2), np.float32)
    eng.commit_row(BUCKET, 0, fmap, cnet, seed)
    got = eng.run_stream_batch(BUCKET, f[1], np.asarray([0], np.int32),
                               np.asarray([True]))
    deq = [rt.dequantize_rows(*rt.quantize_rows(m)) for m in (fmap, cnet)]
    want = rt.make_stream_step_fn(cfg_f, device="cpu")(
        model, f[1], deq[0], deq[1], seed)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert eng.compile_misses == 0


def test_pool_buffers_never_move_across_a_serving_session(weights):
    """The engine allocates the pool at warmup (szero) and every later
    commit, poison and reset writes into the same tensors."""
    _, model = weights
    sc = ServeConfig(buckets=(BUCKET,), max_batch=2, max_sessions=2,
                     chaos="seed=1")
    from raft_tpu_torch.serving.faults import make_injector
    eng = InferenceEngine(PCFG, model, sc, iters=ITERS, stream=True,
                          faults=make_injector(sc.chaos))
    assert eng.pool.buffers(BUCKET) is None
    assert eng.warmup(verbose=False) == 10            # spoison under chaos
    ptrs = [t.data_ptr() for t in buffer_tensors(eng.pool.buffers(BUCKET))]
    f = video(7, 2)
    fmap, cnet = eng.run_encode(BUCKET, f[0])
    eng.commit_row(BUCKET, 1, fmap, cnet, np.zeros((1, 4, 6, 2), np.float32))
    eng.poison_slot(BUCKET, 1)
    assert bool(torch.isnan(eng.pool.buffers(BUCKET)[0][1]).all())
    eng.reset_slots(BUCKET)
    bufs = eng.pool.buffers(BUCKET)
    assert [t.data_ptr() for t in buffer_tensors(bufs)] == ptrs
    assert all(float(t.abs().max()) == 0 for t in buffer_tensors(bufs))
    assert eng.compile_misses == 0 and eng.compile_hits == 4


# ------------------------------------------------------ live port server --

@pytest.fixture(scope="module")
def stream_server(weights):
    _, model = weights
    sc = ServeConfig(buckets=(BUCKET,), max_batch=2, max_sessions=2, port=0,
                     max_wait_ms=20.0, default_deadline_ms=30_000.0,
                     history_interval_s=0)
    server = FlowServer(PCFG, model, sc, iters=ITERS)
    try:
        server.start()
        yield server
    finally:
        server.stop(timeout=TIMEOUT)


def _stream(server, payload):
    req = urllib.request.Request(server.url + "/v1/stream",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_live_sessions_advance_warm_and_match_the_stream_step(stream_server,
                                                              weights):
    """Two sessions advanced from two threads: every advance warm (one
    encoder pass: fnet cache hits == advances), each flow equal to the
    direct solo stream step from the session's last maps, no serve-time
    key, the pool's buffers where warmup put them."""
    _, model = weights
    eng = stream_server.engine
    ptrs = [t.data_ptr() for t in buffer_tensors(eng.pool.buffers(BUCKET))]
    vids = [video(8 + s, 3) for s in range(2)]
    flows = [[None] * 3 for _ in vids]
    errors = []

    def session(s):
        try:
            sid = _stream(stream_server, {"image": vids[s][0][0].tolist()})[
                "session"]
            for k in (1, 2):
                r = _stream(stream_server, {"session": sid,
                                            "image": vids[s][k][0].tolist()})
                assert r["meta"]["warm"] is True
                flows[s][k] = np.asarray(r["flow"], np.float32)
            _stream(stream_server, {"op": "close", "session": sid})
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=session, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert not errors, errors
    step = rt.make_stream_step_fn(PCFG, iters=ITERS, device="cpu")
    for s, v in enumerate(vids):
        fmap, cnet = rt.encode_frame(model, torch.from_numpy(v[0]), PCFG)
        seed = np.zeros((1, 4, 6, 2), np.float32)
        for k in (1, 2):
            out = step(model, v[k], fmap, cnet, seed)
            assert_flow_close(flows[s][k], out[0][0].numpy(),
                              f"session {s} frame {k}")
            fmap, cnet = out[2], out[3]
            seed = rt.warm_start_seed(out[1].numpy(), (4, 6))
    text = urllib.request.urlopen(stream_server.url + "/metrics",
                                  timeout=TIMEOUT).read().decode()
    assert "raft_stream_fnet_cache_hits_total 4" in text
    assert "raft_serving_compile_cache_misses_total 0" in text
    assert eng.compile_misses == 0 and eng.executables == 9
    assert [t.data_ptr() for t in buffer_tensors(
        eng.pool.buffers(BUCKET))] == ptrs
    assert eng.pool.in_use(BUCKET) == 0


def test_slot_pool_bookkeeping_is_jax_s():
    pool = SlotPool(2, arena=(32, 48))
    assert pool.alloc((16, 24)) == 0 and pool.alloc((32, 48)) == 1
    assert pool.alloc((24, 32)) is None and pool.in_use((16, 24)) == 2
    pool.set_extent((16, 24), 0, (16, 24))
    assert pool.used_pixels((32, 48)) == 16 * 24
    pool.free((16, 24), 0)
    assert pool.in_use((32, 48)) == 1 and pool.used_pixels((32, 48)) == 0
