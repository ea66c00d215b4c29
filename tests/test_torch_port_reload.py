"""Fault C3, closed: ``InferenceEngine.reload`` stages and probes the new
weights off the serving path and holds the device lock for the in-place
copy only.  On the CPU, with a stand-in probe that blocks on an event, a
batch must complete while the probe is blocked, with the old weights; the
reload then lands (version 2, the new weights served).  On CUDA the
probe's device work (the model's move, its inputs, its forward) runs on
the engine's probe thread and holds the device lock, which a serve-time
capture needs to itself; its host build and load do neither.  A probe
that rejects the weights (non-finite flow) leaves the old ones serving,
with nothing copied."""

import threading

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.serving import InferenceEngine, ServeConfig
from raft_tpu_torch.serving.engine import ReloadMismatch

torch.set_num_threads(2)   # several test workers share the host's cores

CFG = rt.RAFTConfig.small_model(corr_impl="pallas", iters=2)
BUCKET = (32, 48)
TIMEOUT_S = 60


def _model(seed):
    return rt.init_raft_torch(CFG, torch.Generator().manual_seed(seed),
                              device="cpu")


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 — handed to the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


@pytest.fixture()
def engine():
    eng = InferenceEngine(CFG, _model(0), ServeConfig(
        buckets=(BUCKET,), max_batch=1, max_sessions=0), iters=2)
    eng.warmup(verbose=False)
    return eng


def test_a_batch_completes_while_the_reload_probe_is_blocked(engine):
    im = np.random.RandomState(1).rand(2, 1, *BUCKET, 3).astype(np.float32)
    direct = rt.make_inference_fn(CFG, iters=2, device="cpu")
    old = engine.run(BUCKET, im[0], im[1])
    entered, release = threading.Event(), threading.Event()
    real_probe = engine._probe

    def blocking_probe(staged):
        entered.set()
        assert release.wait(TIMEOUT_S)
        return real_probe(staged)

    engine._probe = blocking_probe
    new = _model(7)
    reload_t, reloaded = _in_thread(
        lambda: engine.reload(new.state_dict(), tag="v2"))
    try:
        assert entered.wait(TIMEOUT_S)
        batch_t, served = _in_thread(lambda: engine.run(BUCKET, im[0], im[1]))
        batch_t.join(TIMEOUT_S)
        assert not batch_t.is_alive(), "a batch waited for the reload probe"
        assert "err" not in served
        np.testing.assert_array_equal(served["out"], old)
        assert engine.weight_info()["version"] == 1
    finally:
        release.set()
    reload_t.join(TIMEOUT_S)
    assert not reload_t.is_alive() and "err" not in reloaded
    assert reloaded["out"] == {"version": 2, "tag": "v2", "probed": True}
    np.testing.assert_array_equal(engine.run(BUCKET, im[0], im[1]),
                                  direct(new, im[0], im[1]).numpy())


def test_the_probe_holds_the_device_lock_for_its_device_work_on_cuda(
        engine, monkeypatch):
    """The CPU engine made to take its CUDA branch: each step of the probe
    records whether the device lock is held when it runs, and whether it
    runs on the engine's probe thread (whose cuDNN choices warmup makes on
    CUDA) or on the caller's."""
    from raft_tpu_torch.models import raft as rm
    new, held = _model(7).state_dict(), {}

    def spy(name, fn):
        def wrapped(*a, **k):
            held.setdefault(name, (
                engine._device_lock.locked(),
                threading.current_thread().name.startswith(
                    "raft-reload-probe")))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(engine, "_cuda", True)
    monkeypatch.setattr(rm.RAFT, "load_state_dict",
                        spy("load", rm.RAFT.load_state_dict))
    monkeypatch.setattr(rm.RAFT, "to", spy("move", rm.RAFT.to))
    monkeypatch.setattr(engine, "_zeros", spy("inputs", engine._zeros))
    monkeypatch.setattr(rm, "raft_forward", spy("forward", rm.raft_forward))
    assert engine.reload(new)["probed"]
    assert held == {"load": (False, False), "move": (True, True),
                    "inputs": (True, True), "forward": (True, True)}


def test_a_rejected_probe_copies_nothing(engine):
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    bad = {k: v.clone() for k, v in _model(9).state_dict().items()}
    name = "update_block.flow_head.conv2.bias"
    bad[name] = torch.full_like(bad[name], float("nan"))
    with pytest.raises(ReloadMismatch, match="non-finite"):
        engine.reload(bad, tag="poisoned")
    assert engine.weight_info() == {"version": 1, "tag": None}
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, before[k]), k
