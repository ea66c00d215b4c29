"""CPU smoke runs of the port's training, profiling and rendering tools,
each in a subprocess with its own time limit: bench_train, profile_breakdown,
envelope_check, warmstart_bench, every phase of train_chaos, and
make_qualitative (whose PNG must decode back to the panel bit for bit), and
tlm's command line on a training run directory."""

import hashlib
import json

import numpy as np

from torch_tools_smoke import records, run_tool


def test_bench_train_quick(tmp_path):
    out = tmp_path / "bt.jsonl"
    rc, stdout, stderr = run_tool("bench_train", "--quick", "--out", out)
    assert rc == 0, stderr[-3000:]
    (rec,) = records(out)
    assert rec["eager_ms"] > 0 and np.isfinite(rec["loss_last"])
    assert rec["card"] is None and rec["batch"] == 2


def test_profile_breakdown_small(tmp_path):
    out = tmp_path / "pb.jsonl"
    rc, stdout, stderr = run_tool(
        "profile_breakdown", "--size", 32, 48, "--iters", 1, 2, 3,
        "--reps", 2, "--gru-impl", "xla", "--impl", "pallas-win",
        "--out", out)
    assert rc == 0, stderr[-3000:]
    (rec,) = records(out)
    assert sorted(rec["model_ms"]) == ["1", "2", "3"]
    assert set(rec["parts_ms"]) >= {"fnet_x2_frames", "cnet", "loop_setup",
                                    "lookup", "update_block_xla",
                                    "convex_upsample"}


def test_envelope_check_quick(tmp_path):
    out = tmp_path / "env.jsonl"
    rc, stdout, stderr = run_tool("envelope_check", "--quick", "--out", out)
    assert rc == 0, stderr[-3000:]
    stages = [r["stage"] for r in records(out)]
    assert stages == ["memory", "memory", "memory_ratio", "executed_step",
                      "loader"]
    assert records(out)[3]["finite"] and records(out)[3]["accum_steps"] == 2


def test_warmstart_bench_quick(tmp_path):
    out = tmp_path / "ws.jsonl"
    rc, stdout, stderr = run_tool("warmstart_bench", "--quick", "--out", out)
    assert rc == 0, stderr[-3000:]
    (rec,) = records(out)
    assert rec["pairs"] == 2 and rec["cold_pairs_per_s"] > 0
    assert rec["converge"]["policy"] == "converge:1e-2"


def test_train_chaos_every_phase(tmp_path):
    rc, stdout, stderr = run_tool("train_chaos", "--smoke", "--out",
                                  tmp_path / "tc", "--phase-deadline-s", 120,
                                  timeout=200)
    assert rc == 0 and "TRAIN CHAOS PASS" in stdout, \
        stdout[-3000:] + stderr[-3000:]
    verdict = json.loads((tmp_path / "tc" / "TRAIN_CHAOS.json").read_text())
    assert verdict["ok"] and not verdict["problems"]
    assert set(verdict["phases"]) == {"clean", "sync", "nan_loss", "preempt",
                                      "torn_ckpt", "worker_kill",
                                      "worker_stall"}
    assert verdict["phases"]["nan_loss"]["rollbacks"] == 1
    rc, stdout, stderr = run_tool("tlm", "summary", tmp_path / "tc" / "nan")
    # tlm takes no --cpu: argparse rejects the flag
    assert rc == 2 and "--cpu" in stderr


def test_make_qualitative_png_decodes_bitwise(tmp_path):
    png = tmp_path / "q.png"
    rc, stdout, stderr = run_tool("make_qualitative", "--demo-steps", 2,
                                  "--size", 32, 48, "--iters", 2,
                                  "--samples", 2, "--out", png)
    assert rc == 0, stdout[-2000:] + stderr[-3000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert rec["png_roundtrip_bitwise"] and rec["size"] == [68, 192]
    from raft_tpu_torch.imageio import decode_png
    back = decode_png(png.read_bytes())
    assert back.shape == (68, 192, 3)
    assert hashlib.sha256(back.tobytes()).hexdigest() == rec["panel_sha256"]
