"""CPU smoke runs of serve_bench's process-spawning arms: ``--fleet`` at 2
replicas with the kill drill (migration, respawn from the shared engine
cache) and the rolling hot swap, and ``--coldstart`` (a cold boot against
an empty engine cache, then a cached boot of a new server), each in a
subprocess with its own time limit."""

from torch_tools_smoke import records, run_tool


def test_serve_bench_fleet_smoke_two_replicas(tmp_path):
    out = tmp_path / "fleet.jsonl"
    rc, stdout, stderr = run_tool("serve_bench", "--smoke", "--fleet",
                                  "--replicas", "2", "--chaos", "kill",
                                  "--out", out, timeout=240)
    assert rc == 0 and "SMOKE PASS" in stdout, stdout[-3000:] + stderr[-3000:]
    (rec,) = records(out)
    assert rec["replicas"] == 2 and not rec["scaling"]["gated"]
    assert rec["chaos"]["migrated_sessions"] >= 1
    assert rec["chaos"]["flow_matches_replay"] is True
    assert rec["chaos"]["respawn_engine_cache"]["misses"] == 0
    assert all(s == "reloaded" for s in rec["hot_swap"]["rolled"])
    assert rec["hot_swap"]["served_during_roll"] > 0


def test_serve_bench_coldstart_smoke(tmp_path):
    out = tmp_path / "cold.jsonl"
    rc, stdout, stderr = run_tool("serve_bench", "--smoke", "--coldstart",
                                  "--engine-cache-dir", tmp_path / "cache",
                                  "--out", out, timeout=180)
    assert rc == 0 and "SMOKE PASS" in stdout, stdout[-3000:] + stderr[-3000:]
    (rec,) = records(out)
    cold, cached = rec["cold"], rec["cached"]
    assert cold["cache"]["saves"] == cached["cache"]["hits"] > 0
    assert cached["cache"]["misses"] == 0 and cached["compiler_runs"] == 0
    assert rec["density"]["density_ratio"] >= 2.0
    # no compiler runs on the CPU: the boot race is recorded, not gated
    assert rec["faster_gated"] is False
