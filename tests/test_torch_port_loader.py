"""The port's multi-process loader (``data/mp_loader.py``): per-index
content determinism under both transports, a respawn after SIGKILL (the
training chaos arm ``worker_kill``), the stall arm healed, a worker's
exception raised in the consumer, and the torn-frame case: a worker
stopped and then SIGKILLed in the middle of writing a multi-MB result
frame, which must not block the consumer.  Each loader runs in a thread
joined with a timeout (:func:`_drive`), so a hang fails the test instead
of the run."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch.data.augment import FlowAugmentor
from raft_tpu_torch.data.mp_loader import MPSampleLoader, SampleSpec
from raft_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_tpu_torch.training.faults import make_train_injector

torch.set_num_threads(2)   # several test workers share the host's cores

DEADLINE_S = 90.0


class MarkedSamples:
    """Samples whose every value is their index; ``fail_at`` raises."""

    augmentor = None

    def __init__(self, n: int, shape=(8, 8), fail_at=None):
        self.n, self.shape, self.fail_at = n, tuple(shape), fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx == self.fail_at:
            raise KeyError(f"sample {idx} is unreadable")
        return (np.full(self.shape, idx, np.float32),
                np.full((4,), idx, np.int64))


def _drive(loader, take=None):
    """Iterate ``loader`` in a thread (``take`` samples, or to its end);
    returns (each sample's first field, the exception raised or None).
    Fails if the thread is still running after DEADLINE_S."""
    got, errors = [], []

    def run():
        try:
            for s in loader:
                got.append(np.array(s[0]))      # shm views: copy now
                if take is not None and len(got) >= take:
                    break
        except Exception as e:  # noqa: BLE001 — handed to the test
            errors.append(e)
        finally:
            loader.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), "the loader blocked its consumer"
    return got, (errors[0] if errors else None)


@pytest.mark.parametrize("transport", ["pickle", "shm"])
def test_content_is_deterministic_per_index(transport):
    """Each sample equals the dataset's own at its task's content seed,
    whichever worker made it and in whatever order it arrived."""
    ds = SyntheticFlowDataset(size=(24, 32), length=6,
                              augmentor=FlowAugmentor((16, 24)))
    seed = 5
    loader = MPSampleLoader(ds, num_workers=2, seed=seed, epochs=1,
                            transport=transport)
    got, err = _drive(loader)
    assert err is None and len(got) == 6
    want = {}
    for idx in range(6):
        ds.augmentor.rng = np.random.RandomState((seed * 1_000_003 + idx)
                                                 % 2 ** 31)
        want[ds[idx][0].tobytes()] = idx
    assert sorted(want[g.tobytes()] for g in got) == list(range(6))


@pytest.mark.parametrize("transport", ["pickle", "shm"])
def test_worker_kill_arm_respawns_and_the_stream_goes_on(transport):
    faults = make_train_injector("seed=1")
    faults.force("worker_kill", [False, False, False, True])
    loader = MPSampleLoader(MarkedSamples(10), num_workers=2, seed=0,
                            epochs=2, transport=transport, faults=faults)
    got, err = _drive(loader)
    assert err is None
    assert sorted(int(g.flat[0]) for g in got) == sorted(list(range(10)) * 2)
    assert loader.respawns == 1 and faults.injected["worker_kill"] == 1
    assert not any(w.proc.is_alive() for w in loader._workers)


def test_worker_stall_arm_is_healed():
    faults = make_train_injector("seed=2")
    faults.force("worker_stall", [True])
    loader = MPSampleLoader(MarkedSamples(8), num_workers=2, seed=0,
                            epochs=1, transport="shm", faults=faults,
                            stall_timeout=1.0)
    got, err = _drive(loader)
    assert err is None and sorted(int(g.flat[0]) for g in got) == \
        list(range(8))
    assert loader.respawns >= 1


def test_a_worker_exception_is_raised_and_a_spent_budget_escalates():
    loader = MPSampleLoader(MarkedSamples(6, fail_at=3), num_workers=2,
                            seed=0, epochs=1, shuffle=False)
    _, err = _drive(loader)
    assert isinstance(err, RuntimeError) and "unreadable" in str(err)
    faults = make_train_injector("seed=3")
    faults.force("worker_kill", [True])
    loader = MPSampleLoader(MarkedSamples(6), num_workers=1, seed=0,
                            faults=faults, max_respawns=0)
    _, err = _drive(loader, take=4)
    assert isinstance(err, RuntimeError) and "respawn budget" in str(err)
    with pytest.raises(ValueError, match="shape"):
        SampleSpec.from_sample((np.zeros((2, 3)),)).write(
            bytearray(64), (np.zeros((3, 2)),))


def test_a_torn_frame_cannot_block_the_consumer():
    """A worker writing a 32 MB result frame is stopped (SIGSTOP) once
    the consumer holds part of that frame, and then SIGKILLed: the frame
    is torn.  The consumer must go on: the dead worker's task goes to its
    replacement and the bounded run delivers every sample."""
    n = 5
    ds = MarkedSamples(n, shape=(4 * 1024, 2048))          # 32 MB each
    loader = MPSampleLoader(ds, num_workers=1, seed=0, epochs=1,
                            shuffle=False)
    victim = loader._workers[0]
    state = {"torn": False}

    def tear():
        deadline = time.monotonic() + 60
        reader = victim.reader
        while time.monotonic() < deadline:
            body, got = reader._body, reader._got
            if body is not None and 0 < got < len(body):
                os.kill(victim.proc.pid, signal.SIGSTOP)
                time.sleep(0.3)          # the consumer drains the pipe
                if reader._body is body and reader._got < len(body):
                    state["torn"] = True
                    os.kill(victim.proc.pid, signal.SIGKILL)
                    return
                os.kill(victim.proc.pid, signal.SIGCONT)
            time.sleep(0.0005)

    tearer = threading.Thread(target=tear, daemon=True)
    tearer.start()
    got, err = _drive(loader)
    tearer.join(5)
    assert state["torn"], "no frame was caught half written"
    assert err is None
    assert sorted(int(g.flat[0]) for g in got) == list(range(n))
    assert loader.respawns == 1
