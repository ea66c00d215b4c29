"""Closed-loop serving in process: ``FlowServer.infer`` under N clients.

The traffic file gives the clients, the frame size, the bucket, the
pool of seeded pairs, their motion, the ``ServeConfig`` settings, the
warm-up requests per client and how many device calls the check samples.
Each client is a video pipeline: it sends its next pair when the last
reply returns, cycling through the pool (client c sends pairs c, c + N,
...).  A request is timed from the client's call to its return.

Set-up: the port and the weights, the pool (made on the device, held on
the host as the clients' arrays), the server's warm-up (one captured
graph per batch step of the bucket), then ``warm_requests`` per client
through the whole path.  The window opens when every client starts and
closes when the last request sent before ``--seconds`` has returned;
``pairs_per_s`` is the pairs completed over that time, ``latency_p95_ms``
the 95th percentile over all of them.

After the window (the server stopped, its graphs and weights freed), a
seeded reservoir sample of the window's device calls is checked against
the plain reference, every request of each sampled call (so every row of
a batch is read), computed from the pool's frames and the benchmark's
weights.  A request's gap is the widest gap of its served flow, as a
share of the reference flow's largest component (at least 1 px);
``flow_gap`` is the widest over the sampled requests.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import counts, device as devmod, frames
from ..harness import Check, Outcome, Run
from ..reference import raft as ref
from ..trace import DeviceTrace
from ..weights import make_weights

MOTION_DIM = 128        # B2's motion input: the motion encoder's 126 + flow


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Load:
    """N closed-loop clients of one server, each sending its next pair
    when its last returns; request k of client c sends pool pair
    (c + N k).  Keeps every request's record and a seeded reservoir
    sample of ``keep`` device calls (an ``execute`` span id, shared by
    co-batched requests), with the served flow of each of their
    requests."""

    def __init__(self, server, im1: np.ndarray, im2: np.ndarray,
                 keep: int, seed: int):
        self.server, self.im1, self.im2 = server, im1, im2
        self.keep = keep
        self.rng = np.random.default_rng(seed)
        self.lock = threading.Lock()
        self.records: List[tuple] = []
        self.errors: List[str] = []
        self.calls_seen = set()
        self.sample: Dict[int, list] = {}
        self.t_start = self.t_stop = 0.0

    def _offer(self, call, idx: int, flow: np.ndarray) -> None:
        if call not in self.calls_seen:
            self.calls_seen.add(call)
            if len(self.sample) < self.keep:
                self.sample[call] = []
            else:
                j = int(self.rng.integers(len(self.calls_seen)))
                if j < self.keep:
                    del self.sample[list(self.sample)[j]]
                    self.sample[call] = []
        if call in self.sample:
            self.sample[call].append((idx, np.array(flow)))

    def _send(self, idx: int, t_ref: float, record: bool) -> None:
        try:
            req = self.server.infer(self.im1[idx], self.im2[idx],
                                    finish_trace=False)
        except Exception as e:          # shed, timeout, error: a failure
            with self.lock:
                self.errors.append(f"{type(e).__name__}: {e}")
            return
        t1 = time.perf_counter()
        rec = req.trace.finish()        # every request is traced
        if record:
            spans = _spans(rec)
            with self.lock:
                self.records.append((t_ref, t1) + spans)
                self._offer(spans[1], idx, req.result)

    def closed(self, clients: int, count=None, seconds=0.0,
               record=True) -> None:
        """Each client sends ``count`` requests, or sends while the window
        of ``seconds`` is open."""
        n_pool = len(self.im1)

        def opened():
            self.t_start = time.perf_counter()
            self.t_stop = self.t_start + seconds
        barrier = threading.Barrier(clients, action=opened)

        def client(c):
            barrier.wait()
            k = 0
            while (k < count) if count is not None else \
                    (time.perf_counter() < self.t_stop):
                idx = (c + clients * k) % n_pool
                k += 1
                self._send(idx, time.perf_counter(), record)
        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"flowbench-client-{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def sampled(self) -> List[tuple]:
        """(pool index, served flow) of every request of the sampled calls."""
        return [req for call in self.sample.values() for req in call]


def _spans(rec) -> tuple:
    """What a request's trace holds for the readers, as a tuple of plain
    numbers (which the collector stops tracking): its ``queue_wait`` in
    seconds, its ``execute`` span's id (shared by co-batched requests),
    that call's real and padded rows and its seconds."""
    wait = call = real = padded = secs = None
    for s in rec["spans"]:
        if s["name"] == "queue_wait":
            wait = s["dur_ms"] / 1e3
        elif s["name"] == "execute":
            call, real, padded = s["span"], s.get("batch_real"), \
                s.get("batch_padded")
            secs = s["dur_ms"] / 1e3
    return wait, call, real, padded, secs


def summarize(records) -> dict:
    """Per request: queue wait; per device call: the batch's real and
    padded rows and the ``execute`` span's seconds."""
    calls = {r[3]: r[4:] for r in records if r[3] is not None}
    return {"queue_wait_s": [r[2] for r in records if r[2] is not None],
            "device_calls": list(calls.values())}


def _pad(x: torch.Tensor, bucket) -> torch.Tensor:
    """[H, W, 3] -> [1, bh, bw, 3], replicate padding split between the
    sides (the official RAFT ``InputPadder``'s 'sintel' mode)."""
    H, W = x.shape[:2]
    ph, pw = bucket[0] - H, bucket[1] - W
    y = F.pad(x.permute(2, 0, 1)[None],
              (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), mode="replicate")
    return y.permute(0, 2, 3, 1)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def check(cfg: dict, sd: dict, im1: np.ndarray, im2: np.ndarray, sample,
          bucket, dev, calibrate: bool, control: bool = False):
    """The reference on every sampled request: (gaps, window positions
    per row and iteration, calibration readings).  With ``control`` the
    control stands in the program's place: each served flow is replaced
    by the reference's in TF32."""
    iters = cfg["model"]["iters"]
    H, W = im1.shape[1:3]
    t, l = (bucket[0] - H) // 2, (bucket[1] - W) // 2
    h8, w8 = bucket[0] // 8, bucket[1] // 8
    levels = counts.level_sizes(h8, w8, cfg["model"]["corr_levels"])
    gaps, positions, readings, refs = [], [], [], {}
    for idx, served in sample:
        if idx not in refs:             # a pool pair sampled again
            x1 = _pad(torch.from_numpy(im1[idx]).to(dev), bucket)
            x2 = _pad(torch.from_numpy(im2[idx]).to(dev), bucket)
            coords, low, high = [], None, None
            with torch.no_grad(), devmod.precision(tf32=False):
                want = ref.forward(sd, cfg["model"], x1, x2, iters,
                                   coords_out=coords)[0, t:t + H, l:l + W]
            pos = [counts.corr_positions(c.permute(0, 2, 3, 1), levels,
                                         cfg["model"]["corr_radius"])
                   for c in coords]
            if calibrate or control:
                with torch.no_grad(), devmod.precision(tf32=True):
                    low = ref.forward(sd, cfg["model"], x1, x2,
                                      iters)[0, t:t + H, l:l + W]
            if calibrate:
                with torch.no_grad():
                    high = ref.forward({k: v.double() for k, v in sd.items()},
                                       cfg["model"], x1.double(), x2.double(),
                                       iters)[0, t:t + H, l:l + W]
            refs[idx] = (want, pos, low, high)
        want, pos, low, high = refs[idx]
        got = low if control else torch.from_numpy(served).to(dev)
        gaps.append(_gap(got, want))
        positions += pos
        if calibrate:
            readings.append((_gap(low, want), _gap(want.double(), high),
                             _gap(got.double(), high)))
    return gaps, positions, readings


def run(r: Run) -> Outcome:
    cfg = merged(r.cell.config, r.overrides.get("config", {}))
    tr = merged(r.cell.traffic, r.overrides.get("traffic", {}))
    dev = torch.device(r.device)
    from raft_tpu_torch import RAFT, RAFTConfig
    from raft_tpu_torch.serving.config import ServeConfig
    from raft_tpu_torch.serving.server import FlowServer

    if r.device == "cuda":
        torch.cuda.init()
    devmod.print_peaks(r.device)
    mc = cfg["model"]
    rc = RAFTConfig(**mc)
    sd = make_weights(cfg, r.seed, dev)
    model = RAFT(rc).to(dev).eval()
    model.load_state_dict(sd)
    H, W = tr["frame"]
    bucket = tuple(tr["bucket"])
    im1, im2, _, _ = frames.make_pairs(tr["pool_pairs"], H, W, r.seed, dev,
                                       tr["motion"])
    host1, host2 = im1.cpu().numpy(), im2.cpu().numpy()
    del im1, im2
    server = FlowServer(rc, model, ServeConfig(buckets=(bucket,),
                                               **tr["serve"]),
                        iters=mc["iters"])
    if r.fault in ("answer", "row"):
        _plant_altered_answer(server, r.fault)
    server.start()
    tracer = None
    try:
        loop = Load(server, host1, host2, tr["check_calls"], r.seed)
        loop.closed(tr["clients"], count=tr["warm_requests"], record=False)
        loop.errors.clear()
        devmod.reset_peak(r.device)
        if r.trace and r.device == "cuda":
            tracer = DeviceTrace()
            tracer.start()
        t_open = time.time()
        loop.closed(tr["clients"], seconds=r.seconds)
        devmod.sync(r.device)
        trace = tracer.stop() if tracer is not None else None
        info = devmod.describe(r.device, trace)
    finally:
        server.stop()
    loop.server = None
    del server, model
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()

    records = loop.records
    lat = np.array([r[1] - r[0] for r in records])
    window_s = (max(r[1] for r in records) - loop.t_start) if records \
        else float(r.seconds)
    e2e = {"setup_s": t_open - (r.t_process or t_open)}
    if records:
        e2e["pairs_per_s"] = len(records) / window_s
        e2e["latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    gaps, positions, control = check(cfg, sd, host1, host2, loop.sampled(),
                                     bucket, dev, r.calibrate,
                                     control=r.fault == "control")
    h8, w8 = bucket[0] // 8, bucket[1] // 8
    fdim = 128 if mc["small"] else 256
    pos_row = float(np.mean(positions)) if positions else None
    readings = dict(summarize(records), pairs=len(records), window_s=window_s,
                    flops_per_pair=counts.model_flops(mc, *bucket, mc["iters"]),
                    b1_row_s=None if pos_row is None else counts.lookup_bound_s(
                        1, h8, w8, fdim, mc["corr_levels"], mc["corr_radius"],
                        pos_row),
                    b2_row_s=(counts.gru_bound_s(1, h8, w8, mc["hidden_dim"],
                                                 MOTION_DIM)
                              if mc.get("gru_impl") == "pallas" else None))
    checks = [Check("flow_gap", max(gaps) if gaps else float("inf"),
                    float(r.cell.limits["flow_gap"]))]
    rows = np.bincount([c[0] for c in readings["device_calls"]], minlength=5)
    print(f"flowbench window: {len(records)} requests in {window_s:.3f} s, "
          f"device calls by real rows 1-4 {rows[1:].tolist()}; checked "
          f"{len(gaps)} requests of {len(loop.sample)} calls",
          file=sys.stderr)
    calibration = {}
    if r.calibrate:
        calibration = {"flow_gap_program": gaps,
                       "flow_gap_control": [c[0] for c in control],
                       "flow_gap_reference_f64": [c[1] for c in control],
                       "flow_gap_program_f64": [c[2] for c in control]}
    return Outcome(attempted=len(records) + len(loop.errors),
                   failed=len(loop.errors), end_to_end=e2e, checks=checks,
                   readings=readings, device=info, trace=trace,
                   calibration=calibration)


def _plant_altered_answer(server, fault: str) -> None:
    """The tests' faults: the engine's output flows are altered where they
    are produced, half a pixel on an 8 x 8 patch of every row ('answer')
    or of the last row of each device call alone ('row')."""
    run_engine = server.engine.run
    rows = slice(None) if fault == "answer" else slice(-1, None)

    def altered(bucket, im1, im2, *sizes):
        flow = np.array(run_engine(bucket, im1, im2, *sizes))
        flow[rows, :8, :8, 0] += 0.5
        return flow
    server.engine.run = altered
