"""The bookkeeping of ``raft_tpu_torch.models.capture.GraphedForward`` on the
CPU: the CUDA graph itself exists only on the card (``chip_smoke.py``
phase 6f holds real replays against eager there), so here ``capture`` is
replaced by a stand-in whose "graph" re-runs the captured function on the
static inputs and writes the static outputs in place, as a replay does.
What is held: one capture per (model, batch, H, W), sizes an input, the
inputs copied in and fresh outputs returned, an in-place weight load read
by the next replay, moved storages captured anew, a collected model's
graphs dropped, and malformed inputs refused before any copy.  Every
replay must equal the eager forward bitwise (the stand-in runs the same
eager code)."""

import contextlib
import gc

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.models import capture as capture_mod
from raft_tpu_torch.models import raft as port_raft


class _StandInGraph:
    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        self.replays += 1
        for dst, src in zip(self.out, self.fn()):
            if dst is not None:
                dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """Capture by the stand-in; no CUDA call is made."""
    calls = []

    def fake_capture(fn, pool=None):
        fn()                                 # the eager warm-up
        calls.append(pool)
        out = fn()
        return _StandInGraph(fn, out), out

    monkeypatch.setattr(capture_mod, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return calls


CFG = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=1)


def _graphed(ragged=False, cfg=CFG):
    """The pairwise entry's GraphedForward, capturing by the stand-in, and
    the factory's eager function on the CPU."""
    forward, spec, validate = port_raft._pair_entry(cfg, None, ragged)
    staged = forward if forward.adaptive else None
    return (capture_mod.GraphedForward(forward, lambda m: None, spec, validate,
                                       staged),
            port_raft._factory(cfg, "cpu", (forward, spec, validate)))


def _images(seed, B=1, H=16, W=24):
    return np.random.RandomState(seed).rand(2, B, H, W, 3).astype(np.float32)


def test_one_capture_per_key_fresh_outputs(stand_in):
    model = rt.init_raft_torch(CFG, device="cpu")
    fn, eager = _graphed()
    a, b = _images(1), _images(2)
    out_a = fn(model, a[0], a[1])
    out_b = fn(model, b[0], b[1])
    assert fn.captures == 1 and fn.graph_count() == 1
    torch.testing.assert_close(out_a.flow, eager(model, a[0], a[1]).flow,
                               rtol=0, atol=0)
    torch.testing.assert_close(out_b.flow, eager(model, b[0], b[1]).flow,
                               rtol=0, atol=0)
    assert not torch.equal(out_a.flow, out_b.flow)   # a was not overwritten
    torch.testing.assert_close(out_b.iters_used, torch.tensor([1], dtype=torch.int32))
    c = _images(3, B=2, H=24, W=16)                   # a second key
    fn(model, torch.from_numpy(c[0]), torch.from_numpy(c[1]))
    assert fn.captures == 2 and fn.graph_count() == 2
    again = fn(model, a[0], a[1])                     # the first key replays
    torch.testing.assert_close(again.flow, out_a.flow, rtol=0, atol=0)
    assert fn.captures == 2 and stand_in == ["pool"] * 2


def test_weights_in_place_replay_moved_storage_recaptures(stand_in):
    model = rt.init_raft_torch(CFG, device="cpu")
    other = rt.init_raft_torch(CFG, generator=torch.Generator().manual_seed(7),
                               device="cpu")
    fn, eager = _graphed()
    a = _images(4)
    fn(model, a[0], a[1])
    model.load_state_dict(other.state_dict())         # copies in place
    got = fn(model, a[0], a[1])
    assert fn.captures == 1
    torch.testing.assert_close(got.flow, eager(other, a[0], a[1]).flow,
                               rtol=0, atol=0)
    conv = model.update_block.flow_head.conv2
    conv.weight.data = conv.weight.data.clone()       # a storage moved
    fn(model, a[0], a[1])
    assert fn.captures == 2 and fn.graph_count() == 1


def test_a_collected_model_takes_its_graphs(stand_in, monkeypatch):
    """A real graph holds no Python reference to the model; the stand-in
    here keeps none either (its replay is not called for)."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(capture_mod, "capture",
                        lambda fn, pool=None: (Graph(), fn()))
    model = rt.init_raft_torch(CFG, device="cpu")
    fn, _ = _graphed()
    a = _images(7)
    fn(model, a[0], a[1])
    assert fn.graph_count() == 1
    del model
    gc.collect()
    assert fn.graph_count() == 0


def test_ragged_sizes_are_an_input(stand_in):
    model = rt.init_raft_torch(CFG, device="cpu")
    fn, eager = _graphed(ragged=True)
    a = _images(5, B=2, H=24, W=32)
    for sizes in ([[24, 32], [17, 21]], [[9, 30], [24, 11]]):
        sizes = np.array(sizes, np.int32)
        got = fn(model, a[0], a[1], sizes)
        torch.testing.assert_close(got.flow, eager(model, a[0], a[1], sizes).flow,
                                   rtol=0, atol=0)
    assert fn.captures == 1


def test_malformed_inputs_raise_before_any_capture(stand_in):
    model = rt.init_raft_torch(CFG, device="cpu")
    pairwise, _ = _graphed()
    ragged, _ = _graphed(ragged=True)
    a = _images(6)
    with pytest.raises(ValueError, match="image shapes differ"):
        pairwise(model, a[0], a[1][:, :8])
    with pytest.raises(ValueError, match="divisible by 8"):
        pairwise(model, a[0][:, :12], a[1][:, :12])
    with pytest.raises(ValueError, match="ragged entry takes sizes"):
        pairwise(model, a[0], a[1], np.array([[16, 24]]))
    with pytest.raises(ValueError, match="ragged entry takes sizes"):
        ragged(model, a[0], a[1])
    with pytest.raises(ValueError, match="sizes must be an integer"):
        ragged(model, a[0], a[1], np.array([[16.0, 24.0]]))
    with pytest.raises(ValueError, match="sizes must be an integer"):
        ragged(model, a[0], a[1], np.array([[16, 24], [8, 8]]))
    assert pairwise.captures == ragged.captures == 0 and stand_in == []


def test_capture_warms_up_once_on_a_side_stream_then_captures(monkeypatch):
    """``capture`` runs ``fn`` once eagerly on a side stream, then once
    inside ``torch.cuda.graph`` on the given pool, and returns that call's
    output with the graph (the CUDA calls recorded by stand-ins)."""
    log = []

    class _Stream:
        def __init__(self, name="side"):
            self.name = name

        def wait_stream(self, other):
            log.append(("wait", self.name, other.name))

    @contextlib.contextmanager
    def on_stream(s):
        log.append(("enter", s.name))
        yield
        log.append(("exit", s.name))

    class _Graph:
        pass

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        log.append(("capture", pool, capture_error_mode))
        yield
        log.append(("captured",))

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream("main"))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    calls = iter(("warm-up", "captured"))

    def fn():
        out = next(calls)
        log.append(("fn", out))
        return out

    g, out = capture_mod.capture(fn, pool="pool")
    assert isinstance(g, _Graph) and out == "captured"
    assert log == [("wait", "side", "main"), ("enter", "side"),
                   ("fn", "warm-up"), ("exit", "side"), ("wait", "main", "side"),
                   ("capture", "pool", "thread_local"), ("fn", "captured"),
                   ("captured",)]
