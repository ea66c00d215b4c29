"""The bookkeeping of ``raft_tpu_torch.training.capture.GraphedTrainStep``
on the CPU: the CUDA graph exists only on the card (``chip_smoke.py``
phase 9 holds real replays against the eager step there), so here
``capture`` is replaced by a stand-in whose "graph" re-runs the captured
step on the static buffers and writes the static metrics in place, as a
replay does; its warm-up's update is put back, so the capture leaves the
state as it found it, as on the card.  What is held: one capture per (model,
batch shape), the batch copied into static buffers, the dropout masks the
eager step draws for the same seed, the state updated in place and
bitwise the eager step's, an in-place restore read by the next replay,
moved storage captured anew, ``accum_steps=2``, the converge policy, a
NaN batch skipped, and malformed batches refused before any copy."""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.models import capture as capture_mod
from raft_tpu_torch.training import (GraphedTrainStep, TrainState,
                                     make_optimizer, make_train_step)
from raft_tpu_torch.training import capture as train_capture
from raft_tpu_torch.training.checkpoint import host_state
from raft_tpu_torch.training.step import step_masks
from raft_tpu_torch.convert.weights import from_jax_train_state

from torch_train_parity import make_batch, stage_kwargs

torch.set_num_threads(2)   # several test workers share the host's cores

CFG = rt.RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=2)
B, H, W = 2, 16, 24


class _StandInGraph:
    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        self.replays += 1
        for k, v in self.fn().items():
            self.out[k].copy_(v)


@pytest.fixture
def stand_in(monkeypatch):
    """Capture by the stand-in; no CUDA call is made."""
    calls = []

    def fake_capture(fn, pool=None, after_warmup=None):
        out = fn()          # the eager warm-up; its outputs stand for the
        after_warmup()      # static ones (a real capture executes nothing)
        calls.append(pool)
        return _StandInGraph(fn, out), out

    monkeypatch.setattr(capture_mod, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(train_capture, "_check_device", lambda dev: None)
    return calls


def _state(tc, seed=0, cfg=CFG):
    model = rt.init_raft_torch(cfg, torch.Generator().manual_seed(seed),
                               device="cpu", dtype=torch.float32)
    return TrainState.create(model, make_optimizer(tc))


def _leaves(state):
    return [t.detach().clone() for t in train_capture.state_tensors(state)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _pair(tc, cfg=CFG):
    """A captured step and an eager one on two states of the same weights."""
    tx_c, tx_e = make_optimizer(tc), make_optimizer(tc)
    step = GraphedTrainStep(cfg, tc, tx_c)
    eager = make_train_step(cfg, tc, tx_e)
    sc, se = _state(tc, cfg=cfg), _state(tc, cfg=cfg)
    sc.opt_state, se.opt_state = tx_c.init(sc.params), tx_e.init(se.params)
    return step, eager, sc, se


def test_replays_are_the_eager_steps_in_place(stand_in):
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    step, eager, sc, se = _pair(tc)
    ptrs = [t.data_ptr() for t in train_capture.state_tensors(sc)]
    for i in range(3):
        batch = make_batch(i, B, H, W)
        sc, mc = step(sc, batch, i)
        se, me = eager(se, batch, i)
        _same(_leaves(sc), _leaves(se))
        for k in me:
            torch.testing.assert_close(mc[k], me[k], rtol=0, atol=0)
    assert sc.step == se.step == 3
    assert step.captures == 1 and step.graph_count() == 1 and len(stand_in) == 1
    assert [t.data_ptr() for t in train_capture.state_tensors(sc)] == ptrs
    # the batch lies in the static buffers; the caller's arrays are copies
    [entry] = step.entries(sc)
    for buf, x in zip(entry.inputs, make_batch(2, B, H, W)):
        np.testing.assert_array_equal(buf.numpy(), x)
    assert len(entry.inputs) == 4          # dropout 0: no mask is drawn
    # metrics are fresh tensors, not the graph's outputs
    assert all(mc[k] is not entry.outputs[k] for k in mc)
    # a second batch shape is a second key
    sc, _ = step(sc, make_batch(9, B, H + 8, W), 9)
    assert step.captures == 2 and step.graph_count() == 2


def test_dropout_masks_are_the_eager_steps(stand_in):
    cfg = dataclasses.replace(CFG, dropout=0.25)
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    step, eager, sc, se = _pair(tc, cfg)
    for seed in (3, 4):
        batch = make_batch(seed, B, H, W)
        sc, mc = step(sc, batch, seed)
        se, me = eager(se, batch, seed)
        _same(_leaves(sc), _leaves(se))
        torch.testing.assert_close(mc["loss"], me["loss"], rtol=0, atol=0)
        [entry] = step.entries(sc)
        want = step_masks(cfg, B, 1, seed)[0]
        assert len(want) == 2 and not all(bool(m.all()) for m in want)
        assert len(entry.inputs) == 4 + len(want)
        for buf, m in zip(entry.inputs[4:], want):
            torch.testing.assert_close(buf, m, rtol=0, atol=0)
    assert step.captures == 1


def test_accum_steps_two(stand_in):
    tc = TrainConfig(**stage_kwargs(batch_size=4, image_size=(H, W),
                                    accum_steps=2))
    step, eager, sc, se = _pair(tc)
    for i in range(2):
        batch = make_batch(i, 4, H, W)
        sc, mc = step(sc, batch, i)
        se, me = eager(se, batch, i)
        _same(_leaves(sc), _leaves(se))
        torch.testing.assert_close(mc["grad_norm"], me["grad_norm"],
                                   rtol=0, atol=0)
    assert step.captures == 1


def test_converge_policy_masked(stand_in):
    """The converge policy trains masked over every iteration, with no host
    read of the device flag: the replays equal the eager steps."""
    cfg = dataclasses.replace(CFG, iters_policy="converge:1e9:1")
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    step, eager, sc, se = _pair(tc, cfg)
    for i in range(2):
        batch = make_batch(i, B, H, W)
        sc, mc = step(sc, batch, i)
        se, me = eager(se, batch, i)
        _same(_leaves(sc), _leaves(se))
        torch.testing.assert_close(mc["mean_iters"], me["mean_iters"],
                                   rtol=0, atol=0)
    assert float(mc["mean_iters"]) == 1.0 and step.captures == 1


def test_restore_in_place_and_moved_storage(stand_in):
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    tx = make_optimizer(tc)
    step = GraphedTrainStep(CFG, tc, tx)
    state = _state(tc)
    state.opt_state = tx.init(state.params)
    state, _ = step(state, make_batch(0, B, H, W), 0)
    saved = host_state(state)                       # step 1, on the host
    state, m2 = step(state, make_batch(1, B, H, W), 1)
    after2 = _leaves(state)
    # an in-place restore (the loop's rollback and resume) is what the next
    # replay reads: step 2 again gives step 2's state bitwise
    from_jax_train_state(saved, state)
    assert state.step == 1
    state, m2b = step(state, make_batch(1, B, H, W), 1)
    _same(_leaves(state), after2)
    torch.testing.assert_close(m2b["loss"], m2["loss"], rtol=0, atol=0)
    assert step.captures == 1
    # a parameter whose storage moved: the next call captures anew
    p = next(state.model.parameters())
    p.data = p.data.clone()
    state, _ = step(state, make_batch(2, B, H, W), 2)
    assert step.captures == 2 and step.graph_count() == 1
    assert step.recaptures == 1
    # a fresh model (a restore into a new process's state) is a new key
    fresh = copy.deepcopy(state)
    fresh, _ = step(fresh, make_batch(3, B, H, W), 3)
    assert step.captures == 3 and step.graph_count() == 2
    assert step.recaptures == 1


def test_nan_batch_skipped(stand_in):
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    assert tc.skip_nonfinite_updates
    step, _, state, _ = _pair(tc)
    state, _ = step(state, make_batch(0, B, H, W), 0)
    before = _leaves(state)
    nfc = int(state.opt_state.notfinite_count)
    bad = list(make_batch(1, B, H, W))
    bad[0] = np.full_like(bad[0], np.nan)
    state, m = step(state, tuple(bad), 1)
    assert not np.isfinite(float(m["loss"]))
    after = _leaves(state)
    counters = {id(t) for t in (state.opt_state.notfinite_count,
                                state.opt_state.last_finite,
                                state.opt_state.total_notfinite)}
    for t, x, y in zip(train_capture.state_tensors(state), before, after):
        if id(t) not in counters:
            torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert int(state.opt_state.notfinite_count) == nfc + 1
    assert step.captures == 1


def test_malformed_batches_refused_before_any_copy(stand_in):
    tc = TrainConfig(**stage_kwargs(batch_size=4, image_size=(H, W),
                                    accum_steps=2))
    step, _, state, _ = _pair(tc)
    good = make_batch(0, 4, H, W)
    state, _ = step(state, good, 0)
    [entry] = step.entries(state)
    bufs = [b.clone() for b in entry.inputs]
    bad_flow = (good[0], good[1], good[2][..., :1], good[3])
    with pytest.raises(ValueError, match="batch.flow"):
        step(state, bad_flow, 1)
    with pytest.raises(ValueError, match="accum_steps"):
        step(state, make_batch(1, 3, H, W), 1)
    for b, x in zip(entry.inputs, bufs):
        torch.testing.assert_close(b, x, rtol=0, atol=0)
    assert step.captures == 1 and state.step == 1


def test_cpu_model_raises():
    tc = TrainConfig(**stage_kwargs(batch_size=B, image_size=(H, W)))
    step, _, state, _ = _pair(tc)
    with pytest.raises(ValueError, match="runs on CUDA"):
        step(state, make_batch(0, B, H, W), 0)
