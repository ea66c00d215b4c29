"""Fleet controllers: signal-driven autoscaling + rolling weight updates.

The autoscaler consumes signals the serving plane ALREADY exports — no
new replica-side instrumentation: ``raft_slo_burn_rate`` (is any replica
failing its latency objective?), admission queue fill, shed counters
(429/breaker_open), ``raft_breaker_state``, and the replica-side anomaly
sentinels (``raft_anomaly_active`` — a firing rule anywhere in the fleet
counts as pressure, and scale-down waits until every sentinel clears) —
all read from the manager's cached /metrics scrapes.  Decisions are hysteretic and
asymmetric (scale up after ``up_after`` consecutive pressured polls,
down only after ``down_after`` calm ones, cooldown between events), so
one hot poll can't thrash the fleet through spawn/drain cycles that cost
a warmup each.

The rolling updater turns the per-replica ``/admin/reload`` endpoint
(weight hot-swap with no capture, engine.reload) into a fleet primitive:
one replica at a time — soft-drained first (``replica.updating`` steers
NEW pairwise picks away while in-flight work finishes and pinned
sessions keep streaming), swapped, verified, released — so the fleet
never has fewer than N-0 serving replicas and never drops a request.  A
mismatch ABORTS the roll (replicas past the failure keep the old
weights; better a version-split fleet than a half-dead one).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

from ..telemetry.log import get_logger
from .config import FleetConfig
from .manager import ReplicaManager

_log = get_logger("fleet")

RELOAD_TIMEOUT_S = 120.0


def fleet_signals(manager: ReplicaManager,
                  prev_shed: Dict[int, float]) -> dict:
    """Aggregate the autoscaler's inputs from the manager's cached
    scrapes.  ``prev_shed`` carries per-replica shed totals between polls
    (mutated in place) so the shed signal is a rate, not a lifetime
    count."""
    burn = 0.0
    queue_fills = []
    breaker_open = False
    shed_delta = 0.0
    anomalies = 0.0
    for rep in manager.replicas():
        if not rep.routable or not rep.prom:
            continue
        for key, val in rep.prom.items():
            if key.startswith("raft_slo_burn_rate"):
                burn = max(burn, val)
            elif key.startswith("raft_breaker_state") and val >= 2.0:
                breaker_open = True
            elif key.startswith("raft_anomaly_active"):
                anomalies += val
        queue_fills.append(rep.queue_fill())
        shed = sum(v for k, v in rep.prom.items()
                   if k.startswith("raft_serving_requests_total")
                   and ('status="shed"' in k
                        or 'status="breaker_open"' in k))
        last = prev_shed.get(rep.idx)
        if last is not None and shed > last:
            shed_delta += shed - last
        prev_shed[rep.idx] = shed
    return {
        "burn": burn,
        "queue_frac": (sum(queue_fills) / len(queue_fills)
                       if queue_fills else 0.0),
        "breaker_open": breaker_open,
        "shed_rate": shed_delta,
        "anomaly": anomalies,
    }


class Autoscaler:
    """Hysteretic scale controller.  ``signals_fn`` and ``now_fn`` are
    injectable so tests drive synthetic signal traces through
    :meth:`step` with a fake clock — no threads, no replicas."""

    def __init__(self, config: FleetConfig, manager: ReplicaManager,
                 metrics: Optional[dict] = None,
                 signals_fn: Optional[Callable[[], dict]] = None,
                 now_fn: Callable[[], float] = time.monotonic,
                 run_log=None, sessions=None):
        self.config = config
        self.manager = manager
        self.metrics = metrics or {}
        self.now_fn = now_fn
        self.run_log = run_log
        self.sessions = sessions          # FleetSessionMap (TTL reap rider)
        self._prev_shed: Dict[int, float] = {}
        self.signals_fn = signals_fn or (
            lambda: fleet_signals(manager, self._prev_shed))
        self._pressured = 0               # consecutive pressured polls
        self._calm = 0                    # consecutive calm polls
        self._last_event: Optional[float] = None
        self._stop = threading.Event()
        self._thread = None
        self.events = 0

    def _in_cooldown(self) -> bool:
        return (self._last_event is not None
                and self.now_fn() - self._last_event
                < self.config.cooldown_s)

    def step(self) -> Optional[str]:
        """One decision poll.  Returns 'up'/'down' when a scale event
        fired, else None — what the hysteresis tests assert on."""
        cfg = self.config
        sig = self.signals_fn()
        pressured = (sig["burn"] > cfg.up_burn_rate
                     or sig["queue_frac"] > cfg.up_queue_frac
                     or sig["breaker_open"]
                     or sig["shed_rate"] > 0
                     or sig.get("anomaly", 0) > 0)
        calm = (sig["burn"] < cfg.down_burn_rate
                and sig["queue_frac"] < cfg.down_queue_frac
                and not sig["breaker_open"]
                and sig["shed_rate"] == 0
                and sig.get("anomaly", 0) == 0)
        self._pressured = self._pressured + 1 if pressured else 0
        self._calm = self._calm + 1 if calm else 0
        if self.sessions is not None:
            self.sessions.reap(ttl_s=3600.0)
        if self._in_cooldown():
            return None
        desired = self.manager.desired
        if self._pressured >= cfg.up_after and desired < cfg.max_replicas:
            return self._fire("up", desired + 1, sig)
        if self._calm >= cfg.down_after and desired > cfg.min_replicas:
            return self._fire("down", desired - 1, sig)
        return None

    def _fire(self, direction: str, target: int, sig: dict) -> str:
        self.manager.scale_to(target, reason=f"autoscale_{direction}")
        self._pressured = self._calm = 0
        self._last_event = self.now_fn()
        self.events += 1
        if "scale_events" in self.metrics:
            self.metrics["scale_events"].labels(direction).inc()
        _log.info(f"autoscale {direction} -> {target} "
                  f"(burn={sig['burn']:.2f} queue={sig['queue_frac']:.2f} "
                  f"shed={sig['shed_rate']:.0f} "
                  f"breaker={sig['breaker_open']})")
        if self.run_log is not None:
            self.run_log.event("fleet_autoscale", direction=direction,
                               target=target, **{k: v for k, v in sig.items()
                                                 if k != "breaker_open"})
        return direction

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="raft-fleet-autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.scale_poll_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                _log.warning(f"autoscaler step failed: {e}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)


class RollingUpdater:
    """Zero-downtime fleet-wide weight hot-swap, one replica at a time."""

    def __init__(self, manager: ReplicaManager, metrics: Optional[dict] =
                 None, run_log=None):
        self.manager = manager
        self.metrics = metrics or {}
        self.run_log = run_log
        self._roll_lock = threading.Lock()   # one roll at a time

    def _push(self, rep, body: bytes, tag: Optional[str]):
        headers = {"Content-Type": "application/octet-stream"}
        if tag:
            headers["X-Raft-Weight-Tag"] = tag
        req = urllib.request.Request(rep.url + "/admin/reload", data=body,
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=RELOAD_TIMEOUT_S) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = {"error": "unreadable reload response"}
            return e.code, payload

    def _prestage(self, reps) -> Optional[dict]:
        """Write one replica's cache entries (a probe digest per warm key)
        and manifest into the shared AOT cache dir BEFORE the flip
        loop (POST /admin/cache/prestage), so a replica that dies mid-roll
        — or is scaled up right after — boots from a full directory.  The
        directory is keyed by the config hash, not the weights, and the
        probes run on the graphs, so the entries stay valid across the
        swap.  Best-effort: a replica without --engine-cache-dir is
        skipped and the roll proceeds."""
        for rep in reps:
            if not (rep.health or {}).get("engine_cache"):
                continue            # cacheless (or unprobed) replica
            req = urllib.request.Request(
                rep.url + "/admin/cache/prestage", data=b"", method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=RELOAD_TIMEOUT_S) as r:
                    info = json.loads(r.read()).get("cache")
            except Exception as e:  # noqa: BLE001 — best-effort
                _log.warning(f"cache prestage on replica {rep.idx} "
                             f"failed: {e}")
                return None
            _log.info(f"replica {rep.idx} prestaged the AOT cache "
                      f"({info.get('exported')} entries) before "
                      f"the roll")
            if self.run_log is not None:
                self.run_log.event("fleet_cache_prestaged",
                                   replica=rep.idx, **info)
            return info
        return None

    def roll(self, body: bytes, tag: Optional[str] = None) -> list:
        """Push ``body`` (a native params npz) to every routable replica
        in index order.  Each replica is soft-drained (``updating`` —
        the router stops PICKING it; pinned sessions and in-flight work
        continue, which is safe because the swap itself never pauses
        serving), swapped, then released.  Aborts on first failure."""
        results = []
        with self._roll_lock:
            reps = sorted(self.manager.routable(), key=lambda r: r.idx)
            if reps:
                self._prestage(reps)
            aborted = False
            for rep in reps:
                if aborted:
                    results.append({"idx": rep.idx, "status": "skipped"})
                    continue
                rep.updating = True
                try:
                    status, payload = self._push(rep, body, tag)
                except Exception as e:  # noqa: BLE001 — report, don't die
                    status, payload = 502, {"error": str(e)}
                finally:
                    rep.updating = False
                if status == 200:
                    results.append({"idx": rep.idx, "status": "reloaded",
                                    "weights": payload.get("weights")})
                    if "hot_swaps" in self.metrics:
                        self.metrics["hot_swaps"].inc()
                    _log.info(f"replica {rep.idx} hot-swapped "
                              f"({payload.get('weights')})")
                    if self.run_log is not None:
                        self.run_log.event(
                            "fleet_hot_swap", replica=rep.idx, tag=tag,
                            weights=payload.get("weights"))
                else:
                    results.append({"idx": rep.idx, "status": "failed",
                                    "http_status": status,
                                    "error": payload.get("error")})
                    aborted = True
                    _log.error(f"hot-swap failed on replica {rep.idx} "
                               f"({status}): {payload.get('error')} — "
                               f"roll aborted")
                    if self.run_log is not None:
                        self.run_log.event(
                            "fleet_hot_swap_failed", replica=rep.idx,
                            http_status=status, tag=tag)
        return results
