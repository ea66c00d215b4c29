"""CPU smoke runs of the port's serve_bench arms (``raft_tpu_torch/tools/
serve_bench.py``), each ``--cpu --smoke`` in a subprocess with its own time
limit: the pairwise closed and open loops (coalescing, no capture after
warm-up, the tracing and history overhead controls run, span accounting,
the profiler capture, the budget grid; the smoke's bars on pairs/s and
latency are the card's, see ``TIMING_BARS``), the video
arm (fnet cache, lockstep coalescing, lock order) and the chaos drill
(attributable failures, recovery, sentinels fire and clear)."""

import pytest

from torch_tools_smoke import records, run_tool

ARMS = {
    "closed": (),
    "open": ("--mode", "open", "--rate", "20"),
    "video": ("--video",),
    "chaos": ("--requests", "64", "--chaos",
              "seed=5,engine_error=0.05,latency=0.05,latency_ms=40,"
              "nan=0.05,kill=0.04"),
}


#: The smoke's bars on pairs/s and latency: tracing and metric history
#: under 5% and 2% of pairs/s, and no anomaly sentinel fired in a clean
#: phase (the burn and drift rules read latency against the SLO).  Under
#: the test suite's six workers the host's load moves sub-second phases by
#: more than these bars, so this test leaves them to the card (the tool
#: gates them unchanged there) and holds every other gate of the smoke.
TIMING_BARS = ("tracing costs ", "metric history costs ",
               "anomaly sentinel(s) fired during a clean phase")


def _timing_only_failure(stdout):
    """Whether the smoke failed on the timing bars alone."""
    line = next((ln for ln in stdout.splitlines()
                 if "[bench] SMOKE FAIL: " in ln), None)
    if line is None:
        return False
    problems = line.split("[bench] SMOKE FAIL: ", 1)[1].split("; ")
    return all(p.startswith(TIMING_BARS) for p in problems)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_serve_bench_smoke_arm(arm, tmp_path):
    out = tmp_path / "serve.jsonl"
    rc, stdout, stderr = run_tool("serve_bench", "--smoke", "--out", out,
                                  *ARMS[arm], timeout=150)
    passed = rc == 0 and "SMOKE PASS" in stdout
    pairwise = arm in ("closed", "open")
    assert passed or (pairwise and rc == 1
                      and _timing_only_failure(stdout)), \
        stdout[-3000:] + stderr[-3000:]
    (rec,) = records(out)
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["budget"]["grid_match"] and rec["budget"]["device_kind"] == "cpu"
    if arm == "video":
        assert rec["stream"]["fnet_cache_hits"] > 0
        assert rec["stream"]["device_steps"]["batch_mean"] > 1
    elif arm == "chaos":
        assert sum(rec["chaos"]["injected"].values()) > 0
        assert rec["chaos"]["healthz_after_storm"] == "ok"
    else:
        assert rec["batch_size_mean"] > 1
        assert rec["captures_after_warmup"] == 0
        assert rec["profile_capture"]["trace_events"] > 0
        assert rec["trace_accounting"]["open_traces"] == 0
        for control, keys in (
                ("trace_overhead", ("untraced_pairs_per_sec",
                                    "traced_pairs_per_sec")),
                ("history_overhead", ("history_off_pairs_per_sec",
                                      "history_on_pairs_per_sec"))):
            assert all(rec[control][k] > 0 for k in keys), rec[control]
            assert rec[control]["overhead_pct"] is not None
