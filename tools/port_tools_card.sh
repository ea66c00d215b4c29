#!/usr/bin/env bash
# Every tool of raft_tpu_torch/tools at its full size on the card, one after
# another, from the repository root (about 20 minutes on an H100):
#
#   bash tools/port_tools_card.sh [ARM ...]
#
# With no ARM, all of them; otherwise only the named ones (smoke, serve,
# coldstart, fleet, ragged, train, profile, envelope, warmstart, chaos,
# qualitative).  Each tool's JSON records go to $OUT (default
# build/port_tools_card/; <tool>.jsonl), its output to <name>.log there;
# the last lines of each log and a PASS/FAIL line per run are printed.
# Exits 1 if any run failed.
set -u
OUT=${OUT:-build/port_tools_card}
mkdir -p "$OUT"
ARMS=("$@")
[ ${#ARMS[@]} -eq 0 ] && ARMS=(smoke serve coldstart fleet ragged train \
    profile envelope warmstart chaos qualitative)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
rc=0

run() {   # run NAME TIMEOUT_S module args...
    local name=$1 limit=$2; shift 2
    local t0=$SECONDS
    timeout -k 10 "$limit" python -m "raft_tpu_torch.tools.$@" \
        > "$OUT/$name.log" 2>&1
    local r=$?
    tail -n 4 "$OUT/$name.log" | cut -c1-400
    if [ $r -eq 0 ]; then echo "PASS $name ($((SECONDS - t0)) s)"
    else echo "FAIL $name rc=$r ($((SECONDS - t0)) s)"; rc=1; fi
}

SB="serve_bench --out $OUT/serve_bench.jsonl"
for arm in "${ARMS[@]}"; do
  case $arm in
    smoke)
      run sb-smoke-closed 300 $SB --smoke
      run sb-smoke-open 300 $SB --smoke --mode open --rate 20
      run sb-smoke-video 300 $SB --smoke --video
      run sb-smoke-chaos 300 $SB --smoke --requests 64 --chaos \
          "seed=5,engine_error=0.05,latency=0.05,latency_ms=40,nan=0.05,kill=0.04"
      run sb-smoke-coldstart 300 $SB --smoke --coldstart
      run sb-smoke-fleet 400 $SB --smoke --fleet --replicas 2 --chaos kill
      run sb-smoke-ragged 300 $SB --smoke --ragged-sweep ;;
    serve)
      run sb-closed 300 $SB --size 432 1024 --clients 8 --max-batch 4 \
          --requests 64
      run sb-open 300 $SB --size 432 1024 --clients 8 --max-batch 4 \
          --requests 64 --mode open --rate 10
      run sb-video 300 $SB --size 432 1024 --video --sessions 4 \
          --frames 8 --max-sessions 8 ;;
    coldstart)
      run sb-coldstart 400 $SB --size 432 1024 --max-batch 4 \
          --max-sessions 4 --coldstart --quant int8 ;;
    fleet)
      run sb-fleet 600 $SB --size 432 1024 --max-batch 4 --clients 4 \
          --requests 48 --fleet --replicas 2 --chaos kill ;;
    ragged)
      run sb-ragged 400 $SB --ragged-sweep --requests 48 ;;
    train)
      run bench-train-f32 300 bench_train --out $OUT/bench_train.jsonl
      run bench-train-bf16 300 bench_train --dtype bfloat16 \
          --out $OUT/bench_train.jsonl ;;
    profile)
      run profile-f32 300 profile_breakdown \
          --out $OUT/profile_breakdown.jsonl
      run profile-win 300 profile_breakdown --impl pallas-win \
          --out $OUT/profile_breakdown.jsonl ;;
    envelope)
      run envelope 400 envelope_check --out $OUT/envelope_check.jsonl ;;
    warmstart)
      run warmstart 400 warmstart_bench --out $OUT/warmstart_bench.jsonl ;;
    chaos)
      run train-chaos 400 train_chaos --out "${TMPDIR:-/tmp}/port_train_chaos"
      cp "${TMPDIR:-/tmp}/port_train_chaos/TRAIN_CHAOS.json" "$OUT/" || true ;;
    qualitative)
      run qualitative 400 make_qualitative --demo-steps 300 \
          --out $OUT/qualitative.png ;;
    *) echo "unknown arm $arm"; rc=1 ;;
  esac
done
exit $rc
