"""The port's multi-process coordination (``raft_tpu_torch/parallel/
distributed.py``) and the command lines that use it, against the JAX
package's ``parallel/distributed.py`` and tests/test_distributed.py.

The unit tests simulate topologies (``process_info`` patched) or catch
the call into ``torch.distributed``; the multi-process ones run real gloo
ranks on the CPU through the command line, each rendezvous a ``file://``
store under the test's tmp_path (no TCP port to race for), each process
group's timeout short, every process waited for with a deadline and
killed on the way out.  Loss trajectories agree within 1e-3 relative (the
JAX README's claim for its multi-process run).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from raft_tpu.parallel import distributed as jax_distributed

from raft_tpu_torch import cli
from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.utils.flow_io import read_flo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_RTOL = 1e-3


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _unset_env(monkeypatch):
    for k in ("RAFT_TPU_COORDINATOR", "RAFT_TPU_NUM_PROCESSES",
              "RAFT_TPU_PROCESS_ID", "RAFT_TPU_HEARTBEAT_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_noops_for_one_process(monkeypatch):
    """With one process (the default, an explicit 1 or the env's 1) no
    process group is joined, as JAX's ``initialize`` never contacts its
    coordinator."""
    def boom(*a, **k):
        raise AssertionError("a process group was joined")
    _unset_env(monkeypatch)
    monkeypatch.setattr(distributed.dist, "init_process_group", boom)
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    for kw, env in (({}, None), ({"num_processes": 1}, None), ({}, "1")):
        if env is not None:
            monkeypatch.setenv("RAFT_TPU_NUM_PROCESSES", env)
        assert distributed.initialize(**kw) is False
        jax_distributed.initialize(**kw)
    assert distributed.process_info() == jax_distributed.process_info()


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    jcalls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jcalls.append(kw))
    return calls, jcalls


def test_initialize_reads_env_fallbacks(monkeypatch):
    """Every argument left None falls back to its RAFT_TPU_* variable, as
    in JAX; ``RAFT_TPU_HEARTBEAT_TIMEOUT`` becomes the group's timeout
    (JAX's heartbeat), the backend follows the device."""
    calls, jcalls = _capture(monkeypatch)
    _unset_env(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_COORDINATOR", "host0:1234")
    monkeypatch.setenv("RAFT_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("RAFT_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("RAFT_TPU_HEARTBEAT_TIMEOUT", "7")
    assert distributed.initialize(device="cpu") is True
    jax_distributed.initialize()
    (kw,), (jkw,) = calls, jcalls
    assert kw["init_method"] == "tcp://" + jkw["coordinator_address"]
    assert (kw["world_size"], kw["rank"]) == (jkw["num_processes"],
                                              jkw["process_id"]) == (2, 1)
    assert kw["timeout"].total_seconds() == jkw["heartbeat_timeout_seconds"]
    assert kw["backend"] == "gloo"
    assert distributed.default_backend("cuda") == "cpu:gloo,cuda:nccl"


def test_initialize_explicit_arguments_win(monkeypatch):
    calls, jcalls = _capture(monkeypatch)
    _unset_env(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_NUM_PROCESSES", "8")
    distributed.initialize("file:///tmp/rdv", 2, 0, backend="gloo")
    jax_distributed.initialize("localhost:1234", 2, 0)
    (kw,), (jkw,) = calls, jcalls
    assert kw["init_method"] == "file:///tmp/rdv"
    assert (kw["world_size"], kw["rank"]) == (jkw["num_processes"],
                                              jkw["process_id"])
    assert kw["timeout"].total_seconds() == distributed.HEARTBEAT_DEFAULT_S
    with pytest.raises(ValueError, match="process id"):
        distributed.initialize("h:1", 2, 5)


def test_local_batch_slice_partitions_as_jax(monkeypatch):
    """Across every process of a topology the slices tile [0, B), the
    JAX package's slices."""
    for pcount in (1, 2, 4, 8):
        covered = []
        for pid in range(pcount):
            topo = (lambda pid=pid, pcount=pcount: (pid, pcount))
            monkeypatch.setattr(distributed, "process_info", topo)
            monkeypatch.setattr(jax_distributed, "process_info", topo)
            sl = distributed.local_batch_slice(16)
            assert sl == jax_distributed.local_batch_slice(16)
            covered.extend(range(16)[sl])
        assert covered == list(range(16)), (pcount, covered)


def test_local_batch_slice_rejects_indivisible(monkeypatch):
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 3))
    monkeypatch.setattr(jax_distributed, "process_info", lambda: (0, 3))
    with pytest.raises(AssertionError):
        jax_distributed.local_batch_slice(16)
    with pytest.raises(ValueError, match="divide evenly"):
        distributed.local_batch_slice(16)


def test_global_mesh_and_arrays_of_one_process():
    """Alone (no process group): the mesh over every process is one rank
    with no group, an array assembles to this rank's device unchanged (as
    the JAX package's ``assemble_global_array`` on one host), and a shape
    that does not factor the world raises."""
    from raft_tpu_torch.parallel import make_mesh, shard_batch
    mesh = distributed.global_mesh(device="cpu")
    ax = mesh["data"]
    assert (ax.size, ax.index, ax.group) == (1, 0, None)
    local = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    arr = distributed.assemble_global_array(local, mesh)
    assert arr.device == mesh.device
    np.testing.assert_array_equal(arr.numpy(), local)
    np.testing.assert_array_equal(shard_batch(mesh, local).numpy(), local)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(("data", "spatial"), shape=(2, 2), device="cpu")


def test_train_cli_refuses_workers_under_multihost(monkeypatch, tmp_path):
    """``--workers`` without ``--shard-data`` under several processes is
    refused before anything starts, with the JAX package's message."""
    import argparse

    from raft_tpu.config import RAFTConfig as JaxConfig
    from raft_tpu.training import loop as jax_loop
    from raft_tpu_torch.training import __main__ as training_main

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jargs = argparse.Namespace(
        dataset="synthetic", data=None, workers=2, optimizer="adamw",
        num_steps=2, lr=None, batch=4, accum=None, train_size=(32, 48),
        load=None, out=str(tmp_path), trace=None)
    with pytest.raises(ValueError) as want:
        jax_loop.train_cli(jargs, JaxConfig.small_model(iters=2))
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    args = training_main.build_parser().parse_args(
        ["--cpu", "--small", "--iters", "2", "--workers", "2", "--batch",
         "4", "--train-size", "32", "48", "--num-steps", "2", "--out",
         str(tmp_path / "port")])
    with pytest.raises(ValueError) as got:
        training_main.train_cli(args, training_main.make_config(args))
    assert "--workers needs --shard-data" in str(got.value)
    assert str(got.value) == str(want.value)


def _metrics(path):
    recs = [json.loads(ln) for ln in path.read_text().splitlines()
            if ln.strip()]
    recs = [r for r in recs if "step" in r and "event" not in r]
    assert recs, path
    return recs


def _wait(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


TRAIN = ["--cpu", "--dataset", "synthetic", "--small", "--iters", "2",
         "--batch", "4", "--train-size", "32", "48", "--log-every", "1"]


def test_two_process_train_cli_matches_single_process(tmp_path):
    """``-m train`` through the real command line in two gloo processes
    (``--batch`` the global batch, each rank its slice of the same
    stream) matches the single-process run of the same command step by
    step; rank 1 writes nothing."""
    cmd = [sys.executable, "-m", "raft_tpu_torch.cli", "-m", "train",
           *TRAIN, "--num-steps", "3"]
    rdv = tmp_path / "rdv"
    procs = [subprocess.Popen(
        cmd + ["--out", str(tmp_path / f"mh{pid}"), "--coordinator",
               f"file://{rdv}", "--num-processes", "2", "--process-id",
               str(pid)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(RAFT_TPU_HEARTBEAT_TIMEOUT="60"), cwd=REPO)
        for pid in range(2)]
    single = subprocess.Popen(cmd + ["--out", str(tmp_path / "sp")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=REPO)
    outs = _wait(procs + [single], 300)
    for p, out in zip(procs + [single], outs):
        assert p.returncode == 0, out
    assert "multi-host: 2 processes" in outs[0], outs[0]
    assert not (tmp_path / "mh1" / "checkpoints" / "metrics.jsonl").exists()
    mh = _metrics(tmp_path / "mh0" / "checkpoints" / "metrics.jsonl")
    sp = _metrics(tmp_path / "sp" / "checkpoints" / "metrics.jsonl")
    assert [r["step"] for r in mh] == [r["step"] for r in sp] == [0, 1, 2]
    for a, b in zip(mh, sp):
        for k in ("loss", "epe"):
            assert abs(a[k] - b[k]) <= TRAJ_RTOL * max(1.0, abs(b[k])), (a, b)


def test_two_process_failure_fail_fast_and_resume(tmp_path):
    """The fail-fast drill of the JAX package's distributed module, through
    ``python -m raft_tpu_torch.training`` with ``--shard-data``: kill one
    of two training ranks and the survivor exits non-zero within the
    group's timeout (``RAFT_TPU_HEARTBEAT_TIMEOUT``) instead of hanging;
    relaunching both with the same ``--out`` resumes from the newest
    checkpoint and finishes."""
    out = tmp_path / "mh"
    env = _env(RAFT_TPU_HEARTBEAT_TIMEOUT="10")

    def launch(tag, num_steps):
        return [subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.training", *TRAIN,
             "--num-steps", str(num_steps), "--ckpt-every", "3",
             "--shard-data", "--sync-ckpt", "--out", str(out),
             "--coordinator", f"file://{tmp_path / tag}",
             "--num-processes", "2", "--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO) for pid in range(2)]

    procs = launch("rdv1", 100_000)
    try:
        deadline = time.time() + 240
        ckpts = []
        while time.time() < deadline and not ckpts:
            ckpts = glob.glob(str(out / "checkpoints" / "ckpt_*.npz"))
            if procs[0].poll() is not None:
                raise AssertionError(procs[0].communicate()[0])
            time.sleep(0.5)
        assert ckpts, "no checkpoint within 240 s"
        procs[1].send_signal(signal.SIGKILL)
        t0 = time.time()
        out0 = procs[0].communicate(timeout=60)[0]
        assert procs[0].returncode != 0, out0
        assert time.time() - t0 < 30, time.time() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)

    steps = sorted(int(p.rsplit("_", 1)[1].split(".")[0])
                   for p in glob.glob(str(out / "checkpoints" / "ckpt_*.npz")))
    restored = steps[-1]
    procs = launch("rdv2", restored + 4)
    outs = _wait(procs, 300)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert all(f"at step {restored}" in o for o in outs), outs[0][-2000:]
    recs = _metrics(out / "checkpoints" / "metrics.jsonl")
    assert recs[-1]["step"] == restored + 3 and np.isfinite(recs[-1]["loss"])


def test_test_mode_spatial_matches_single_process(tmp_path, capsys):
    """``-m test --spatial 2 --cpu``: two row-sharded CPU ranks write rank
    0's gathered flow, which matches the single-process run; an H that is
    not a multiple of ``required_h_multiple`` is refused as the JAX CLI
    refuses it (exit 2)."""
    flags = ["-m", "test", "--cpu", "--small", "--iters", "2", "--save-flo"]
    assert cli.main(flags + ["--size", "128", "48", "--spatial", "2",
                             "--out", str(tmp_path / "sp")]) == 0
    assert "sequence-parallel: rows sharded over 2" in capsys.readouterr().out
    assert cli.main(flags + ["--size", "128", "48",
                             "--out", str(tmp_path / "one")]) == 0
    name = "raft_flow_raft-small.flo"
    got = read_flo(tmp_path / "sp" / name)
    want = read_flo(tmp_path / "one" / name)
    assert got.shape == want.shape == (128, 48, 2)
    assert np.abs(got - want).max() <= 1e-3 + 1e-3 * np.abs(want).max()
    assert cli.main(flags + ["--size", "96", "48", "--spatial", "2",
                             "--out", str(tmp_path / "bad")]) == 2
    assert "requires H divisible by 128" in capsys.readouterr().out
