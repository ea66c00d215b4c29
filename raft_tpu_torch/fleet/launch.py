"""``-m serve_fleet``: bring up the whole fleet from one command line.

The port's copy of the JAX package's ``fleet/launch.py``.

Composes the three fleet controllers — ReplicaManager (N serve
subprocesses, staggered warmup), FleetRouter (the front door), and the
Autoscaler + RollingUpdater — then serves until SIGINT/SIGTERM.  Every
serve-mode knob is forwarded verbatim to the replicas, so a fleet is
configured exactly like the single replica it multiplies.

The replicas must share ONE set of weights (a migrated session's flow
must equal pairwise no matter which replica computes it), so when no
``--load`` is given the launcher draws the seeded random weights once, on
the CPU (the launcher holds no CUDA context), writes
``<out>/weights_init.npz``, and hands that to every replica.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from pathlib import Path

from ..telemetry.log import get_logger
from .config import FleetConfig
from .controller import Autoscaler, RollingUpdater
from .manager import ReplicaManager
from .router import FleetRouter

_log = get_logger("fleet")

# serve-mode flags forwarded to every replica: (argparse dest, flag).
# Store-true flags forward bare; valued flags forward with their value.
_FORWARDED_FLAGS = (
    ("buckets", "--buckets"), ("max_batch", "--max-batch"),
    ("max_wait_ms", "--max-wait-ms"), ("queue_depth", "--queue-depth"),
    ("deadline_ms", "--deadline-ms"), ("serve_dp", "--serve-dp"),
    ("max_sessions", "--max-sessions"),
    ("session_ttl_s", "--session-ttl-s"), ("chaos", "--chaos"),
    ("breaker_window", "--breaker-window"),
    ("breaker_threshold", "--breaker-threshold"),
    ("breaker_cooldown_s", "--breaker-cooldown-s"),
    ("trace_sample", "--trace-sample"), ("slo_pair_ms", "--slo-pair-ms"),
    ("slo_stream_ms", "--slo-stream-ms"), ("iters", "--iters"),
    ("iters_policy", "--iters-policy"), ("dtype", "--dtype"),
    ("corr_impl", "--corr-impl"), ("corr_lookup", "--corr-lookup"),
    ("gru_impl", "--gru-impl"), ("host", "--host"),
    ("quant", "--quant"),
    ("engine_cache_dir", "--engine-cache-dir"),
    ("history_interval_s", "--history-interval-s"),
    ("history_window", "--history-window"),
    ("anomaly_window_s", "--anomaly-window-s"),
    ("anomaly_baseline_s", "--anomaly-baseline-s"),
)
_FORWARDED_SWITCHES = (
    ("small", "--small"), ("no_warmup", "--no-warmup"), ("cpu", "--cpu"),
    ("rgb", "--rgb"), ("no_anomaly", "--no-anomaly"),
)


def replica_args(args, load_path: str) -> list:
    """Rebuild the serve-mode argv a replica subprocess needs from the
    parsed fleet argv (the forwarding table above, plus the shared
    weights)."""
    out = ["--load", str(load_path)]
    for dest, flag in _FORWARDED_FLAGS:
        val = getattr(args, dest, None)
        if val is not None:
            out += [flag, str(val)]
    for dest, flag in _FORWARDED_SWITCHES:
        if getattr(args, dest, False):
            out.append(flag)
    return out


def ensure_weights(args, config, out_dir: Path) -> str:
    """Path to the fleet's shared weights npz: ``--load`` when given,
    else the seeded random init (``init_raft_torch``'s, drawn in float32
    on the CPU) written to ``<out>/weights_init.npz`` (every replica must
    serve the SAME weights — migration equality depends on it)."""
    if getattr(args, "load", None):
        return str(args.load)
    import torch

    from ..convert.weights import save_params_npz
    from ..models.raft import init_raft_torch
    model = init_raft_torch(config, device="cpu", dtype=torch.float32)
    print("WARNING: no --load given; the fleet serves RANDOM weights",
          file=sys.stderr)
    path = out_dir / "weights_init.npz"
    save_params_npz(model.state_dict(), path)
    _log.info(f"wrote shared init weights to {path}")
    return str(path)


def build_fleet(args, config, run_log=None):
    """Construct (manager, router, autoscaler, updater) — shared by the
    CLI below and in-process callers."""
    out_dir = Path(getattr(args, "out", None) or ".")
    out_dir.mkdir(parents=True, exist_ok=True)
    fconfig = FleetConfig(
        replicas=args.replicas,
        min_replicas=getattr(args, "min_replicas", None) or 1,
        max_replicas=(getattr(args, "max_replicas", None)
                      or max(args.replicas, 2)),
        host=args.host, port=getattr(args, "fleet_port", None) or args.port,
        health_poll_s=getattr(args, "health_poll_s", None) or 1.0,
        autoscale=bool(getattr(args, "autoscale", False)),
        scale_poll_s=getattr(args, "scale_poll_s", None) or 5.0,
        pin_cpus=bool(getattr(args, "pin_cpus", False)),
        trace_sample=getattr(args, "trace_sample", 1.0),
    )
    if getattr(args, "engine_cache_dir", None) is None:
        # fleet default: one SHARED AOT engine cache under the fleet
        # out-dir (serving/aot_cache.py).  Replica 0 builds the kernels and
        # writes the entries; every later spawn — scale-up, chaos respawn,
        # rolling update — loads the kernel objects instead of running the
        # compiler, and the manager skips the stagger once the first
        # replica reports a fully-warm cache.
        args.engine_cache_dir = str(out_dir / "engine-cache")
    weights = ensure_weights(args, config, out_dir)
    manager = ReplicaManager(fconfig, str(out_dir),
                             base_args=replica_args(args, weights),
                             run_log=run_log)
    router = FleetRouter(fconfig, manager, out_dir=str(out_dir),
                         run_log=run_log, verbose=True)
    updater = RollingUpdater(manager, metrics=router.metrics,
                             run_log=run_log)
    router.updater = updater
    scaler = Autoscaler(fconfig, manager, metrics=router.metrics,
                        run_log=run_log, sessions=router.sessions)
    return manager, router, scaler, updater


def serve_fleet_cli(args, config) -> int:
    """-m serve_fleet: spawn replicas, bind the router, serve until
    SIGINT/SIGTERM, tear the fleet down."""
    from ..telemetry import events as tlm_events
    run_log = tlm_events.current()
    manager, router, scaler, _updater = build_fleet(args, config,
                                                    run_log=run_log)
    t0 = time.monotonic()
    print(f"[fleet] spawning {manager.config.replicas} replica(s) "
          f"(staggered warmup)...")
    try:
        manager.start()
    except Exception as e:
        print(f"ERROR: fleet failed to start: {e}")
        manager.stop()
        return 1
    router.start()
    if manager.config.autoscale:
        scaler.start()
    urls = [r.url for r in manager.replicas()]
    print(f"[fleet] router listening on {router.url}  "
          f"replicas={len(urls)} {urls}  "
          f"({time.monotonic() - t0:.1f}s to ready)")
    print(f"[fleet] POST {router.url}/v1/flow  POST {router.url}/v1/stream"
          f"  POST {router.url}/admin/reload (rolling hot-swap)")
    print(f"[fleet] GET {router.url}/healthz   GET {router.url}/metrics"
          f"   autoscale={'on' if manager.config.autoscale else 'off'} "
          f"[{manager.config.min_replicas}, "
          f"{manager.config.max_replicas}]")

    stopped = threading.Event()

    def _stop(signum, frame):
        print(f"\n[fleet] signal {signum}: stopping router + replicas...")

        def teardown():
            scaler.stop()
            router.stop()
            manager.stop()
            stopped.set()
        threading.Thread(target=teardown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    while not stopped.is_set():
        stopped.wait(0.5)
    m = router.metrics
    print(f"[fleet] stopped  migrations="
          f"{int(m['migrations'].value)} "
          f"retries={int(m['retries'].value)} "
          f"hot_swaps={int(m['hot_swaps'].value)}")
    return 0
