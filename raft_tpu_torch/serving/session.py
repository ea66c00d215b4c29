"""Bounded per-session state for the streaming video path (SERVING.md).

The port's copy of the JAX package's ``serving/session.py``.  The slot
pool's buffers are CUDA tensors (CPU tensors on the CPU) that live as
long as the pool: a commit, a poison and a reset write into them in
place, because the stream batch step's captured graphs read them by
address.

A *session* is one client's video stream.  Its state has two tiers:

* **device tier** — a SLOT in the per-bucket batch buffers of the
  :class:`SlotPool`: the previous frame's encoder maps (``fmap`` + raw
  ``cnet`` output) plus the pre-projected warm-start seed, each stored
  as row ``session.slot`` of a ``[capacity+1, h, w, C]`` device-resident
  buffer.  This is what makes the next advance cost ONE encoder pass and
  exit early under a ``converge`` policy — and, because every session's
  maps live *in batch slots* of one buffer, what lets the batcher
  advance many sessions in ONE device call (the continuous-batching
  stream step, models/raft.make_stream_batch_step_fn): gather rows by
  slot index in, scatter updated rows back.
* **host tier** — the previous frame's pixels plus bookkeeping.  Cheap,
  and exactly what a cold two-encoder restart needs.

``SessionStore`` keeps the host-side records and the LRU/TTL policy,
mapping session id → slot index.  At most ``max_sessions`` sessions hold
a slot; promoting one past the cap *demotes* the least-recently-used
holder (slot freed back to the pool, host record kept), so an advance on
a demoted session degrades transparently to a cold two-encoder restart —
correct flow, no error, just the pairwise cost.  Session records
themselves are capped at ``RECORD_CAP_FACTOR x max_sessions`` (oldest
records evicted outright) and reaped entirely after ``ttl_s`` idle
seconds — TTL reaping FREES the reaped session's slot too, so a
long-lived server can never strand device capacity behind dead records;
an advance on a reaped/unknown id is a 404 — the client reopens.

Thread model: handler threads open/advance/close under the store lock and
hold the per-session lock across a whole advance (one frame in flight per
session); slot promote/demote runs in the batcher thread (via the store),
and the pool's free-list is guarded by its own leaf lock
(``SlotPool._lock``, taken under the store lock on demote/sweep paths —
see SERVING_LOCK_HIERARCHY).  Device BUFFERS are read and written only
under the engine's device lock (the batcher thread at serve time), so
buffer refs need the pool lock only to keep reads atomic against metric
scrapes.  A session may be demoted *between* enqueue and execute — the
coordinator re-checks ``has_features`` at execute time and falls back
cold, which is the designed behavior, not a race.
"""

from __future__ import annotations

import time
import uuid
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..lint.concurrency import guarded_by
from ..telemetry.watchdogs import watched_lock

# Demoted records (host tier only) are kept for graceful cold restarts up
# to this multiple of max_sessions; beyond it the oldest records are
# evicted outright (reason="capacity") and their ids become unknown.
RECORD_CAP_FACTOR = 4


def _put_rows(buf, slots, rows, keep) -> None:
    """``buf[slots] = where(keep, rows, buf[slots])``, in place: a row with
    ``keep`` False writes back the value it gathered."""
    keep = keep.reshape((-1,) + (1,) * (rows.dim() - 1))
    old = buf.index_select(0, slots)
    buf.index_copy_(0, slots, torch.where(keep, rows.to(buf.dtype), old))


def make_slot_commit_fn(quant: bool = False):
    """The slot-pool scatter: ``(fmap_buf, cnet_buf, flow_buf, slots [b],
    fmap_rows [b,...], cnet_rows [b,...], seed_rows [b,...], mask [b])
    -> (fmap_buf, cnet_buf, flow_buf)`` — rows with ``mask=True`` replace
    their slot, everything else (padding rows aimed at the scratch slot,
    rows the non-finite sentinel rejected) writes its OLD value back.

    The write is IN PLACE (``index_copy_`` into the pool's own tensors),
    the counterpart of the JAX package's donated scatter: the returned
    buffers are the ones passed in.  The stream batch step's CUDA graphs
    read these buffers by address (``models/capture.py``), so a commit
    must never rebind or reallocate them.

    Scatter-duplicate discipline: real rows carry unique slot indices
    (one frame in flight per session), and every masked row writes the
    value it gathered — so duplicate indices (padding rows all share the
    scratch slot) always write identical data and the scatter is
    deterministic.  ``slots`` and ``mask`` are tensors on the buffers'
    device (int64, bool); the rows may be in any float dtype.

    With ``quant=True`` (``RAFTConfig.quant='int8'``) the fmap/cnet
    buffers arrive as ``(int8 vals, per-channel float32 scales)`` pairs;
    the incoming rows are quantized ON COMMIT
    (``models/raft.quantize_rows``) and both parts are masked-written.
    The flow seed buffer stays float32.
    """
    def fn(fmap_buf, cnet_buf, flow_buf, slots, fmap_rows, cnet_rows,
           seed_rows, mask):
        if quant:
            from ..models.raft import quantize_rows
            for (vals_buf, scale_buf), rows in ((fmap_buf, fmap_rows),
                                                (cnet_buf, cnet_rows)):
                vals, scales = quantize_rows(rows)
                _put_rows(vals_buf, slots, vals, mask)
                _put_rows(scale_buf, slots, scales, mask)
        else:
            _put_rows(fmap_buf, slots, fmap_rows, mask)
            _put_rows(cnet_buf, slots, cnet_rows, mask)
        _put_rows(flow_buf, slots, seed_rows, mask)
        return fmap_buf, cnet_buf, flow_buf
    return fn


def make_slot_poison_fn(quant: bool = False):
    """Chaos ``session`` arm, slot-pool form: NaN-poison one slot's fmap
    row in place (``(fmap_buf, slots [1]) -> fmap_buf``, a multiply by NaN)
    so the poison propagates through the correlation into the flow output
    — the non-finite sentinel must then catch it and degrade that row
    cold.

    Under ``quant=True`` the int8 value rows cannot hold a NaN, so the
    poison NaNs the slot's float32 SCALE row instead — dequant-on-gather
    (``vals * NaN``) then yields NaN across the whole row, preserving the
    drill's propagation contract."""
    def fn(fmap_buf, slots):
        buf = fmap_buf[1] if quant else fmap_buf
        buf.index_copy_(0, slots, buf.index_select(0, slots) * float("nan"))
        return fmap_buf
    return fn


def slot_shapes(config, capacity: int, h: int, w: int) -> tuple:
    """Shapes and dtypes of one bucket's pool buffers, ``[capacity+1, …]``
    (the extra row is the scratch slot padding rows aim at): the fmap
    rows (``fnet_dim`` channels) and the raw context rows (``cnet_dim``)
    in the compute dtype, as ``encode_frame`` returns them, and the
    float32 warm-start seed.  Under ``quant='int8'`` the fmap and cnet
    entries are ``((shape, int8), (scales shape, float32))`` pairs.
    Each entry is ``(shape, dtype)``."""
    from ..models.raft import compute_dtype
    cap1, h8, w8 = capacity + 1, h // 8, w // 8
    cdt = compute_dtype(config)

    def rows(c):
        if config.quant_slots:
            return (((cap1, h8, w8, c), torch.int8),
                    ((cap1, c), torch.float32))
        return ((cap1, h8, w8, c), cdt)
    return (rows(config.fnet_dim), rows(config.cnet_dim),
            ((cap1, h8, w8, 2), torch.float32))


def zero_slot_buffers(shapes, device) -> tuple:
    """Fresh zeroed buffers of :func:`slot_shapes` on ``device``."""
    def make(spec):
        if isinstance(spec[0], tuple) and isinstance(spec[0][0], tuple):
            return tuple(make(s) for s in spec)
        shape, dtype = spec
        return torch.zeros(shape, dtype=dtype, device=device)
    return tuple(make(s) for s in shapes)


def buffer_tensors(bufs) -> list:
    """Every tensor of a pool's buffers (an int8 entry is a pair)."""
    out = []
    for b in bufs:
        out.extend(b if isinstance(b, (tuple, list)) else (b,))
    return out


class SlotPool:
    """Device-resident batch slots for the streaming sessions, per bucket.

    Pure bookkeeping plus buffer references: a free-list of
    ``capacity`` slot indices per bucket (index ``capacity`` is the
    reserved SCRATCH row padding rows of a batched step aim at), and the
    three device buffers (fmap / cnet / warm-start seed) the serving
    engine's warmed stream steps gather from and commits write into.
    The pool itself never touches the device — buffers are allocated by
    the engine's ``szero`` key at warmup, installed here once, and from
    then on updated in place (commit, poison, reset), never replaced: the
    stream batch step's captured graphs read them by address.

    Thread model: the free-list mutates under ``_lock`` from the store's
    promote/demote/sweep paths (store lock held — the declared
    store → pool edge); the lock makes ref reads atomic for scrape-time
    gauges.

    **Ragged arena mode** (``arena=(max_h, max_w)``): every bucket key
    collapses onto the single max-box arena — sessions of EVERY declared
    resolution share ONE free-list and ONE set of ``[capacity+1, max_h,
    max_w, C]`` buffers, each slot a corner-anchored zero-embedded page
    (ops/corr.mask_ragged_rows is the layout contract).  Callers keep
    passing their *routed* bucket; the pool maps it, so the store/stream
    plumbing is bucket-agnostic.  A slot → extent map records each
    live page's real ``(h, w)`` so scrape-time gauges and the budget
    analyzer can price arena occupancy in live pixels, not box pixels.
    """

    _free = guarded_by("_lock")
    _bufs = guarded_by("_lock")
    _extents = guarded_by("_lock")

    def __init__(self, capacity: int,
                 arena: Optional[Tuple[int, int]] = None):
        if capacity < 1:
            raise ValueError(f"slot pool capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self.scratch = capacity          # the padding row, never allocated
        self.arena = None if arena is None else (int(arena[0]),
                                                 int(arena[1]))
        self._lock = watched_lock("SlotPool._lock")
        self._free: Dict[Tuple[int, int], list] = {}
        self._bufs: Dict[Tuple[int, int], Optional[tuple]] = {}
        # (mapped bucket, slot) -> live (h, w) of the page in that slot.
        self._extents: Dict[Tuple[Tuple[int, int], int],
                            Tuple[int, int]] = {}

    def _b(self, bucket: Tuple[int, int]) -> Tuple[int, int]:
        """Map a routed bucket to its storage key: identity in dense
        mode, the shared max-box arena in ragged mode."""
        return bucket if self.arena is None else self.arena

    @guarded_by("_lock")
    def _bucket_locked(self, bucket: Tuple[int, int]) -> list:
        bucket = self._b(bucket)
        free = self._free.get(bucket)
        if free is None:
            free = self._free.setdefault(bucket,
                                         list(range(self.capacity - 1,
                                                    -1, -1)))
            self._bufs.setdefault(bucket, None)
        return free

    def alloc(self, bucket: Tuple[int, int]) -> Optional[int]:
        """Pop a free slot index, or None when every slot of this bucket
        is held by an in-flight session (the caller stays cold)."""
        with self._lock:
            free = self._bucket_locked(bucket)
            return free.pop() if free else None

    def free(self, bucket: Tuple[int, int], slot: int) -> None:
        with self._lock:
            self._bucket_locked(bucket).append(slot)
            self._extents.pop((self._b(bucket), slot), None)

    def in_use(self, bucket: Tuple[int, int]) -> int:
        """Slots allocated in this bucket (the raft_stream_slots_in_use
        gauge; scrape-time callback).  In arena mode every bucket maps to
        the shared arena, so any declared bucket reports the arena-wide
        count."""
        with self._lock:
            free = self._free.get(self._b(bucket))
            return 0 if free is None else self.capacity - len(free)

    def set_extent(self, bucket: Tuple[int, int], slot: int,
                   extent: Tuple[int, int]) -> None:
        """Record the live (h, w) of the page now resident in ``slot``
        (stream coordinator, at attach/commit).  Cleared by :meth:`free`."""
        with self._lock:
            self._extents[(self._b(bucket), slot)] = (int(extent[0]),
                                                      int(extent[1]))

    def extent(self, bucket: Tuple[int, int],
               slot: int) -> Optional[Tuple[int, int]]:
        with self._lock:
            return self._extents.get((self._b(bucket), slot))

    def used_pixels(self, bucket: Tuple[int, int]) -> int:
        """Sum of live page pixels resident in this (mapped) bucket's
        buffers — the ragged-occupancy numerator for gauges and the
        budget analyzer; box pixels x in_use is the denominator."""
        b = self._b(bucket)
        with self._lock:
            return sum(h * w for (bk, _), (h, w) in self._extents.items()
                       if bk == b)

    def buffers(self, bucket: Tuple[int, int]):
        """(fmap_buf, cnet_buf, flow_buf) or None before install."""
        with self._lock:
            return self._bufs.get(self._b(bucket))

    def install(self, bucket: Tuple[int, int], bufs: tuple) -> None:
        """Install this bucket's device buffers (engine warmup, or the
        first stream call of a server that skipped warmup)."""
        with self._lock:
            self._bucket_locked(bucket)
            self._bufs[self._b(bucket)] = tuple(bufs)

    def seed_row(self, bucket: Tuple[int, int],
                 slot: int) -> Optional[np.ndarray]:
        """Host copy of one slot's warm-start seed ([1, h, w, 2]) — the
        solo cold/warm paths and tests read it; the batched step gathers
        it in-device instead."""
        bufs = self.buffers(bucket)
        if bufs is None:
            return None
        return bufs[2][slot].cpu().numpy()[None]


class Session:
    """One client stream's cached state.  Mutated only while its ``lock``
    is held (handler thread) or from the batcher thread during execute.
    Device-tier maps live in the slot pool at row ``slot``; the record
    itself is host-side."""

    __slots__ = ("id", "bucket", "lock", "created_at", "last_used",
                 "frames", "last_image", "slot")

    def __init__(self, sid: str, bucket: Tuple[int, int]):
        self.id = sid
        self.bucket = bucket
        # budget None: the handler deliberately holds this across a whole
        # advance (queue wait + device call) — serializing frames within a
        # session is the lock's JOB, not a hold-time bug
        self.lock = watched_lock("Session.lock", budget_s=None)
        self.created_at = self.last_used = time.monotonic()
        self.frames = 0                  # advances served (pairs)
        self.last_image = None           # [1, BH, BW, 3] float32, host
        self.slot = None                 # pool slot index, or None (cold)

    @property
    def has_features(self) -> bool:
        return self.slot is not None


class SessionStore:
    """LRU + TTL bounded session registry (one per FlowServer), mapping
    sid → host record → pool slot index.

    ``_lock`` guards the registry itself (``_sessions`` order and
    membership); per-``Session`` state is serialized by ``Session.lock``
    plus the single batcher thread (see the module docstring).  The store
    only ever *probes* ``Session.lock.locked()`` under its own lock —
    never acquires it — so the two can't order-invert.  Every slot
    transition (promote / demote / sweep / close / record-cap evict)
    happens under the store lock, so pool accounting can never leak a
    slot behind a dropped record."""

    _sessions = guarded_by("_lock")

    def __init__(self, max_sessions: int, ttl_s: float,
                 pool: Optional[SlotPool] = None):
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1 to build a store, "
                             f"got {max_sessions}")
        if not ttl_s > 0:
            raise ValueError(f"session_ttl_s must be > 0, got {ttl_s}")
        self.max_sessions = max_sessions
        self.record_cap = RECORD_CAP_FACTOR * max_sessions
        self.ttl_s = ttl_s
        self.pool = pool if pool is not None else SlotPool(max_sessions)
        self._lock = watched_lock("SessionStore._lock")
        self._sessions: "OrderedDict[str, Session]" = OrderedDict()
        # set by make_stream_metrics: a labeled counter with reason=
        # lru (slot demoted), ttl (record reaped), capacity (record
        # evicted outright).  None until wired — the store works bare.
        self.evictions = None

    # -- accounting (live gauge callbacks, sampled at scrape time) ---------

    def active_count(self) -> int:
        """Sessions holding a device slot (the --max-sessions bound)."""
        with self._lock:
            return sum(1 for s in self._sessions.values() if s.has_features)

    def resident_count(self) -> int:
        """Session records resident, demoted included."""
        with self._lock:
            return len(self._sessions)

    def _evict(self, reason: str) -> None:
        if self.evictions is not None:
            self.evictions.labels(reason).inc()

    @guarded_by("_lock")
    def _drop_slot_locked(self, s: Session) -> None:
        """Free a session's slot back to the pool (store lock held — the
        declared store → pool hierarchy edge)."""
        if s.slot is not None:
            self.pool.free(s.bucket, s.slot)
            s.slot = None

    # -- lifecycle ---------------------------------------------------------

    def open(self, bucket: Tuple[int, int]) -> Session:
        """Create a fresh session record (a slot attaches on first
        encode).  Enforces the record cap by evicting the oldest
        not-in-flight records outright."""
        s = Session(uuid.uuid4().hex, bucket)
        with self._lock:
            while len(self._sessions) >= self.record_cap:
                victim = self._pop_lru_locked()
                if victim is None:       # everything in flight: admit anyway
                    break
                self._evict("capacity")
            self._sessions[s.id] = s
        return s

    def get(self, sid: str) -> Optional[Session]:
        """Look up + touch (LRU order and TTL clock)."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                s.last_used = time.monotonic()
                self._sessions.move_to_end(sid)
            return s

    def close(self, sid: str) -> Optional[Session]:
        """Pop the record and free its slot.  A session closed while its
        advance is still in flight keeps the slot until the handler
        releases the session lock and calls :meth:`reclaim_if_closed` —
        freeing it mid-execute would let a new session's promote reuse a
        row the batcher is about to scatter into."""
        with self._lock:
            s = self._sessions.pop(sid, None)
            if s is not None and not s.lock.locked():
                self._drop_slot_locked(s)
            return s

    def reclaim_if_closed(self, s: Session) -> None:
        """Handler-side epilogue of an advance: if the session was closed
        (or reaped) while its frame was in flight, free the slot the
        deferred close left behind."""
        with self._lock:
            if s.id not in self._sessions and not s.lock.locked():
                self._drop_slot_locked(s)

    def sweep(self, now: Optional[float] = None) -> int:
        """Reap records idle past the TTL (skipping in-flight sessions)
        and FREE their device slots back to the pool — a reaped session
        must never strand slot capacity; called opportunistically from
        the request path — no sweeper thread to leak."""
        now = time.monotonic() if now is None else now
        reaped = 0
        with self._lock:
            for sid in [sid for sid, s in self._sessions.items()
                        if now - s.last_used > self.ttl_s
                        and not s.lock.locked()]:
                self._drop_slot_locked(self._sessions.pop(sid))
                self._evict("ttl")
                reaped += 1
        return reaped

    # -- the device-slot bound --------------------------------------------

    def promote(self, session: Session) -> Optional[int]:
        """Give ``session`` a device slot (batcher thread, at commit
        time): demote LRU slot-holders until a slot is free — the
        device-memory bound the store exists for — then allocate.  A
        session that already holds a slot keeps it (the common advance
        path: its rows are updated in place by the commit scatter).
        Returns the slot, or None when every slot is pinned by an
        in-flight session (the caller stays cold — correct, just the
        pairwise cost)."""
        with self._lock:
            session.last_used = time.monotonic()
            if session.slot is not None:
                return session.slot
            holders = [s for s in self._sessions.values()
                       if s.has_features and s is not session]
            excess = len(holders) + 1 - self.max_sessions
            for s in holders:            # OrderedDict order = LRU first
                if excess <= 0:
                    break
                if s.lock.locked():      # mid-advance: not a demotion target
                    continue
                self._drop_slot_locked(s)
                self._evict("lru")
                excess -= 1
            session.slot = self.pool.alloc(session.bucket)
            return session.slot

    def demote(self, session: Session, reason: str) -> None:
        """Drop one session's device slot (faulted warm step: the
        degrade-to-cold rung of the ladder).  A no-op on an already-cold
        session, so a bucket-wide recovery followed by per-row degrade
        bookkeeping never double-counts an eviction."""
        with self._lock:
            if session.slot is not None:
                self._drop_slot_locked(session)
                self._evict(reason)

    def demote_all(self, reason: str = "degraded") -> int:
        """Drop EVERY session's device slot (records kept): the circuit
        breaker's degrade hook.  When the breaker opens the engine is
        sick — cached per-session device state from before the storm is
        not worth trusting, and dropping it routes every surviving
        session through the transparent cold-restart path once the
        breaker closes (correct flow, pairwise cost, no error).
        In-flight sessions are skipped, same as LRU demotion."""
        n = 0
        with self._lock:
            for s in self._sessions.values():
                if s.has_features and not s.lock.locked():
                    self._drop_slot_locked(s)
                    self._evict(reason)
                    n += 1
        return n

    def demote_bucket(self, bucket: Tuple[int, int],
                      reason: str = "degraded") -> int:
        """Drop EVERY session slot of ONE bucket — in-flight sessions
        INCLUDED.  This is the recovery hook after a failed commit
        (the engine zeroes the bucket's buffers, whose rows may be torn):
        any session keeping its slot would gather zeros on its next
        advance and serve finite garbage, so the usual skip-the-locked
        convention must not apply.  Safe to override it here: this runs
        only on the single batcher thread — the one thread that gathers
        — so no step can be mid-gather while the slots are dropped;
        queued advances re-check ``has_features`` at execute time and
        fall back cold."""
        n = 0
        with self._lock:
            for s in self._sessions.values():
                if s.bucket == bucket and s.has_features:
                    self._drop_slot_locked(s)
                    self._evict(reason)
                    n += 1
        return n

    @guarded_by("_lock")
    def _pop_lru_locked(self) -> Optional[Session]:
        for sid, s in self._sessions.items():
            if not s.lock.locked():
                s = self._sessions.pop(sid)
                self._drop_slot_locked(s)
                return s
        return None
