"""Replica manager: spawn, monitor, restart and scale FlowServer replicas.

The port's copy of the JAX package's ``fleet/manager.py``.  Each replica
is a full ``python -m raft_tpu_torch.cli -m serve`` subprocess with its
own port (``--port 0`` — the child picks an ephemeral port and prints it
in the ``[serve] listening on ...`` banner, which the spawner parses from
the replica's log file), its own out-dir (events.jsonl / flightrec.jsonl
nest under the fleet out-dir so ``tlm`` sees one run), and a staggered
warmup so N cold starts don't stampede the host and the card with N
kernel builds and N rounds of captures at once.  The child's output is
unbuffered (its banner must reach the log as it is printed), and it is
told the wall-clock second it was spawned (``RAFT_TPU_SPAWN_T``) so its
``[serve] boot`` line can price its own start.

A poll thread samples every replica's ``/healthz`` and ``/metrics`` on a
fixed cadence; the parsed scrape is cached on the replica record — it is
both the router's load signal and the autoscaler's decision input, one
fetch for both.  A replica whose process exits (chaos kill, OOM) or
fails ``unhealthy_after`` consecutive polls is declared dead: death
listeners fire (the router migrates its sessions on the next advance),
and capacity is respawned when ``restart_dead`` is on.

Thread model: the replica table is guarded by ``ReplicaManager._lock``
(declared in SERVING_LOCK_HIERARCHY after the fleet session locks — a
migrating advance holds its session lock while asking for a healthy
replica).  Spawning and HTTP polls never hold the lock; only table
mutation does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from ..lint.concurrency import guarded_by
from ..telemetry.log import get_logger
from ..telemetry.watchdogs import watched_lock
from .config import FleetConfig

_log = get_logger("fleet")

_BANNER = "[serve] listening on "


def parse_prom_text(text: str) -> Dict[str, float]:
    """Prometheus text exposition -> {'name{labels}': value} (the same
    shape the JAX package's load bench uses) — the fleet's one metric
    parser, feeding both the router's load view and the autoscaler's
    signals."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
        except ValueError:
            continue
    return out


def http_get(url: str, timeout: float):
    """GET ``url`` -> (status, body bytes).  4xx/5xx return their status
    instead of raising (a 503 draining healthz is data, not an error)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class Replica:
    """One managed FlowServer process.  Mutable state is owned by the
    manager and mutated under its lock; readers get snapshots."""

    def __init__(self, idx: int, out_dir: str):
        self.idx = idx
        self.out_dir = out_dir
        self.url: Optional[str] = None
        self.proc = None                  # Popen-shaped: poll/terminate/kill
        self.state = "starting"           # ready|degraded|dead|stopped
        self.consecutive_failures = 0
        self.health: Optional[dict] = None   # last /healthz JSON
        self.prom: Optional[Dict[str, float]] = None  # last /metrics parse
        self.started_at = time.monotonic()
        self.updating = False             # rolling hot-swap soft-drain flag

    @property
    def routable(self) -> bool:
        """Degraded still serves (breaker hiccup / recent batcher restart)
        — only dead/stopped/starting replicas are unroutable."""
        return self.state in ("ready", "degraded")

    def queue_fill(self) -> float:
        """Queued fraction of admission capacity from the last scrape
        (0.0 when unknown — an unscraped replica looks idle, which only
        biases the router TOWARD it and gets corrected one poll later)."""
        if not self.prom:
            return 0.0
        depth = self.prom.get("raft_serving_queue_depth", 0.0)
        limit = self.prom.get("raft_serving_queue_limit", 0.0)
        return depth / limit if limit > 0 else 0.0

    def describe(self) -> dict:
        """healthz-aggregation row (snapshot; no live references)."""
        d = {"idx": self.idx, "url": self.url, "state": self.state,
             "updating": self.updating}
        if self.health:
            d["status"] = self.health.get("status")
            d["queue_depth"] = self.health.get("queue_depth")
            d["weights"] = self.health.get("weights")
        return d


def _default_spawn(replica: Replica, base_args: List[str],
                   config: FleetConfig, cores: Optional[set]):
    """Spawn one serve subprocess and block until its banner names the
    bound (ephemeral) port.  stdout/stderr go to ``<out>/serve.log`` —
    tailed here for the banner, kept afterwards as the replica's log."""
    os.makedirs(replica.out_dir, exist_ok=True)
    log_path = os.path.join(replica.out_dir, "serve.log")
    argv = [sys.executable, "-m", "raft_tpu_torch.cli", "-m", "serve",
            "--port", "0", "--out", replica.out_dir] + list(base_args)
    # -m raft_tpu_torch.cli must resolve no matter where the LAUNCHER was
    # started from (the package is run from a checkout, not installed)
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["PYTHONUNBUFFERED"] = "1"
    env["RAFT_TPU_SPAWN_T"] = repr(time.time())
    preexec = None
    if cores and hasattr(os, "sched_setaffinity"):
        def preexec():                    # runs in the child, pre-exec
            os.sched_setaffinity(0, cores)
    log_f = open(log_path, "w")
    try:
        proc = subprocess.Popen(argv, stdout=log_f, stderr=subprocess.STDOUT,
                                env=env, preexec_fn=preexec)
    finally:
        log_f.close()                     # the child holds its own fd now
    deadline = time.monotonic() + config.spawn_timeout_s
    url = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica {replica.idx} exited with {proc.returncode} "
                f"before binding (see {log_path})")
        try:
            with open(log_path) as f:
                for line in f:
                    if _BANNER in line:
                        url = line.split(_BANNER, 1)[1].split()[0].strip()
                        break
        except OSError:
            pass
        if url:
            return proc, url
        time.sleep(0.1)
    proc.kill()
    raise RuntimeError(f"replica {replica.idx} did not become ready within "
                       f"{config.spawn_timeout_s:.0f}s (see {log_path})")


class ReplicaManager:
    """The fleet's process controller: owns the replica table, the spawn
    policy (staggered warmup, optional CPU pinning), the health/metrics
    poll loop, death -> respawn, and scale_to.  ``spawn_fn(replica) ->
    (proc, url)`` is injectable so tests run in-process fakes."""

    _replicas = guarded_by("_lock")
    _desired = guarded_by("_lock")
    _next_idx = guarded_by("_lock")

    def __init__(self, config: FleetConfig, out_dir: str,
                 base_args: Optional[List[str]] = None,
                 spawn_fn: Optional[Callable] = None, run_log=None):
        self.config = config
        self.out_dir = out_dir
        self.base_args = list(base_args or ())
        self.run_log = run_log
        self._spawn_fn = spawn_fn or self._spawn_subprocess
        self._lock = watched_lock("ReplicaManager._lock")
        self._replicas: Dict[int, Replica] = {}
        self._desired = config.replicas
        self._next_idx = 0
        self._stop = threading.Event()
        self._poll_thread = None
        self._death_cbs: List[Callable] = []
        self._poll_cbs: List[Callable] = []
        self._cores = os.cpu_count() or 1
        self.restarts = 0                 # respawns after unplanned deaths

    # -- spawn / stop ------------------------------------------------------

    def _spawn_subprocess(self, replica: Replica):
        cores = None
        if self.config.pin_cpus and hasattr(os, "sched_setaffinity"):
            # disjoint round-robin core slices: replica i of a fleet that
            # can grow to max_replicas gets every core where
            # core % max_replicas == i % max_replicas
            n = self.config.max_replicas
            cores = {c for c in range(self._cores)
                     if c % n == replica.idx % n} or None
        return _default_spawn(replica, self.base_args, self.config, cores)

    def _event(self, kind: str, **fields) -> None:
        if self.run_log is not None:
            self.run_log.event(kind, **fields)

    def _spawn_one(self) -> Replica:
        """Allocate an index, spawn, and publish the replica.  The table
        holds the 'starting' record while the (long) warmup runs so
        healthz aggregation can show it coming up."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
            rep = Replica(idx, os.path.join(self.out_dir, f"replica-{idx}"))
            self._replicas[idx] = rep
        t0 = time.monotonic()
        try:
            proc, url = self._spawn_fn(rep)
        except Exception:
            with self._lock:
                rep.state = "dead"
            raise
        with self._lock:
            rep.proc, rep.url = proc, url
            rep.state = "ready"
        _log.info(f"replica {idx} ready at {url} "
                  f"({time.monotonic() - t0:.1f}s)")
        self._event("fleet_replica_ready", idx=idx, url=url,
                    spawn_s=round(time.monotonic() - t0, 2))
        return rep

    def start(self) -> None:
        """Bring up the initial fleet (staggered by default) and start
        the health poll loop.  Staggering exists to serialize N cold
        boots (kernel builds, captures) — so when the FIRST replica
        reports it warmed entirely from the shared AOT cache (healthz
        engine_cache: misses == 0), the remaining replicas spawn in
        parallel: they will load the kernel objects, not build them."""
        rest = self.config.replicas
        if self.config.stagger and rest > 0:
            first = self._spawn_one()
            rest -= 1
            if rest > 0 and not self._cache_warm(first):
                for _ in range(rest):
                    self._spawn_one()
                rest = 0
            elif rest > 0:
                _log.info(f"replica {first.idx} booted from the AOT cache "
                          f"(0 misses): skipping staggered warmup for "
                          f"the remaining {rest} replica(s)")
                self._event("fleet_stagger_skipped", warm_idx=first.idx,
                            parallel=rest)
        if rest > 0:
            threads = [threading.Thread(target=self._spawn_one, daemon=True)
                       for _ in range(rest)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(self.config.spawn_timeout_s)
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True,
                                             name="raft-fleet-health")
        self._poll_thread.start()

    def _cache_warm(self, rep: Replica) -> bool:
        """True when ``rep`` reports it warmed entirely from the AOT
        engine cache (healthz engine_cache: hits > 0, misses == 0) —
        the signal that later spawns will load, not build."""
        if not self._probe(rep):
            return False
        ec = (rep.health or {}).get("engine_cache")
        return (bool(ec) and ec.get("misses") == 0
                and ec.get("hits", 0) > 0)

    def stop(self) -> None:
        """Terminate every replica (SIGTERM = graceful drain; SIGKILL
        stragglers) and stop polling."""
        self._stop.set()
        with self._lock:
            reps = list(self._replicas.values())
            for r in reps:
                r.state = "stopped"
        for r in reps:
            if r.proc is not None and r.proc.poll() is None:
                r.proc.terminate()
        deadline = time.monotonic() + 30.0
        for r in reps:
            if r.proc is None:
                continue
            timeout = max(0.1, deadline - time.monotonic())
            try:
                r.proc.wait(timeout=timeout)
            except Exception:
                r.proc.kill()
        if self._poll_thread is not None:
            self._poll_thread.join(5.0)

    def kill(self, idx: int) -> None:
        """Hard-kill one replica (the chaos drill's hammer): SIGKILL, no
        drain, no warning — exactly what the router must survive."""
        with self._lock:
            rep = self._replicas.get(idx)
        if rep is not None and rep.proc is not None:
            rep.proc.kill()
            _log.warning(f"replica {idx} killed (chaos drill)")
            self._event("fleet_replica_killed", idx=idx)

    # -- views -------------------------------------------------------------

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def routable(self) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.routable and not r.updating]

    def get(self, idx: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(idx)

    def ready_count(self) -> int:
        with self._lock:
            return sum(r.routable for r in self._replicas.values())

    def count_state(self, state: str) -> int:
        with self._lock:
            return sum(r.state == state
                       for r in self._replicas.values())

    def describe(self) -> List[dict]:
        with self._lock:
            return [r.describe() for r in self._replicas.values()]

    def on_death(self, cb: Callable) -> None:
        """Register ``cb(replica)`` — fired from the poll thread (no
        manager lock held) when a replica is declared dead."""
        self._death_cbs.append(cb)

    def on_poll(self, cb: Callable) -> None:
        """Register ``cb(replica)`` — fired from the poll thread (no
        manager lock held) after each successful health probe, with the
        fresh ``/healthz`` + ``/metrics`` scrape already on the record.
        The router's fleet time-series ingests here: one fetch feeds the
        load view, the autoscaler, AND the per-replica history."""
        self._poll_cbs.append(cb)

    # -- scaling -----------------------------------------------------------

    def scale_to(self, n: int, reason: str = "manual") -> int:
        """Grow or shrink the fleet to ``n`` routable replicas (clamped
        to [min_replicas, max_replicas]).  Shrink retires the
        highest-index replicas gracefully (SIGTERM -> drain); their
        pinned sessions migrate on their next advance.  Returns the new
        desired count."""
        n = max(self.config.min_replicas, min(self.config.max_replicas, n))
        with self._lock:
            self._desired = n
            live = [r for r in self._replicas.values()
                    if r.state in ("starting", "ready", "degraded")]
            excess = sorted(live, key=lambda r: r.idx)[n:]
            for r in excess:
                r.state = "stopped"
        for r in excess:
            if r.proc is not None and r.proc.poll() is None:
                r.proc.terminate()        # graceful: the server drains
            self._event("fleet_replica_retired", idx=r.idx, reason=reason)
        grow = n - (len(live) - len(excess))
        for _ in range(max(0, grow)):
            self._spawn_one()
        if excess or grow > 0:
            _log.info(f"scaled to {n} replica(s) ({reason}): "
                      f"+{max(0, grow)} / -{len(excess)}")
            self._event("fleet_scaled", desired=n, grew=max(0, grow),
                        shrank=len(excess), reason=reason)
        return n

    @property
    def desired(self) -> int:
        with self._lock:
            return self._desired

    # -- health poll -------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.config.health_poll_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the poll must survive
                _log.warning(f"health poll error: {e}")

    def poll_once(self) -> None:
        """One health sweep over the fleet (also called directly by
        tests to advance fleet state deterministically)."""
        for rep in self.replicas():
            if rep.state in ("stopped", "dead", "starting"):
                if rep.state == "stopped" and rep.proc is not None \
                        and rep.proc.poll() is not None:
                    rep.proc = None       # reaped; keep the record
                continue
            if rep.proc is not None and rep.proc.poll() is not None:
                self._declare_dead(rep, f"process exited "
                                        f"({rep.proc.returncode})")
                continue
            ok = self._probe(rep)
            if ok:
                rep.consecutive_failures = 0
                for cb in self._poll_cbs:
                    try:
                        cb(rep)
                    except Exception as e:  # noqa: BLE001
                        _log.warning(f"poll callback failed: {e}")
            else:
                rep.consecutive_failures += 1
                if rep.consecutive_failures >= self.config.unhealthy_after:
                    self._declare_dead(
                        rep, f"{rep.consecutive_failures} consecutive "
                             f"failed health polls")

    def _probe(self, rep: Replica) -> bool:
        """One /healthz + /metrics sample; returns liveness.  The parsed
        scrape lands on the record for the router and autoscaler."""
        try:
            status, body = http_get(rep.url + "/healthz",
                                    self.config.health_timeout_s)
            health = json.loads(body)
        except Exception:
            return False
        try:
            _, mbody = http_get(rep.url + "/metrics",
                                self.config.health_timeout_s)
            prom = parse_prom_text(mbody.decode())
        except Exception:
            prom = None
        with self._lock:
            rep.health, rep.prom = health, prom
            if rep.state in ("ready", "degraded"):
                if status == 200:
                    rep.state = ("ready" if health.get("status") == "ok"
                                 else "degraded")
                else:                     # 503 draining: still alive
                    rep.state = "degraded"
        return True

    def _declare_dead(self, rep: Replica, why: str) -> None:
        with self._lock:
            if rep.state == "dead":
                return
            rep.state = "dead"
            live = sum(r.state in ("starting", "ready", "degraded")
                       for r in self._replicas.values())
            respawn = (self.config.restart_dead and not self._stop.is_set()
                       and live < self._desired)
            if respawn:
                self.restarts += 1
        _log.error(f"replica {rep.idx} dead: {why}")
        self._event("fleet_replica_dead", idx=rep.idx, why=why)
        for cb in self._death_cbs:
            try:
                cb(rep)
            except Exception as e:  # noqa: BLE001
                _log.warning(f"death callback failed: {e}")
        if respawn:
            self._event("fleet_replica_restarting", dead_idx=rep.idx)
            # respawn off the poll thread: warmup takes tens of seconds
            # and the poll cadence is the fleet's failure-detection clock
            threading.Thread(target=self._respawn, daemon=True,
                             name=f"raft-fleet-respawn-{rep.idx}").start()

    def _respawn(self) -> None:
        try:
            self._spawn_one()
        except Exception as e:  # noqa: BLE001
            _log.error(f"respawn failed: {e}")
