#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is not 0:

1. device: CUDA must be available; prints the card's name and power limit
   (nvidia-smi).  TF32 is switched off for matmuls and cuDNN, so every
   comparison below is float32 end to end; cuDNN runs in benchmark mode.
2. build: compiles the three kernel sources of raft_tpu_torch/csrc (nvcc,
   one process each, into build/raft_tpu_torch/) and prints the build time
   and ptxas's report.
3. kernels vs plain, at the main paths' shapes, each held to its plain
   PyTorch version at rtol = atol = 1e-5: the correlation lookup on a
   [1, 54, 128, 256] query map and its 4-level pyramid (coords with noise
   of +-(r+3) px and a share of queries wholly outside the map); the
   window-scheduled lookup on the same inputs (also held to the first
   lookup's output) and on windows scattered over the whole map; the
   ragged lookup on a [3, 55, 156, 256] max box with live sizes8
   [[54, 128], [46, 155], [48, 64]], on both kinds of coords (live queries
   held, dead ones exactly 0); the SepConvGRU at 54x128 and at 2x37x45 (no tile
   divides it).
4. main path: raft-things (full width and depth, seeded random weights) on
   4 seeded frame pairs at 432x1024, batch 1, 12 iterations, through
   make_inference_fn with corr_impl='pallas', gru_impl='pallas'.  The flows
   must be finite, every iteration must have launched both kernels (launch
   counters).  The same pairs through the plain versions
   (corr_impl='blockwise', corr_lookup='onehot', gru_impl='xla') must agree
   within 1e-3 + 1e-3 * max|flow| at every iteration (kernel and plain step
   from the same state) and end to end over 3 iterations; the 12-iteration
   end-to-end difference is printed beside that of a 1e-7 input
   perturbation, since the random-weight recurrence is chaotic.
5. window main path: 2 of those pairs with pallas_p_select='window'; the
   window kernel must run once per iteration and the first lookup never;
   the same parity as phase 4.
6. ragged path: one batch of 3 in a 440x1248 max box (Sintel 436x1024,
   KITTI 375x1242, FlyingChairs 384x512) through make_ragged_inference_fn,
   12 iterations: the ragged kernel once per iteration, the GRU kernel 4
   times, the other lookups never; finite flows on each live crop; the
   parity of phase 4 against the plain ragged configuration on each live
   crop; each item alone (batch 1, same box) against its row of the batch
   over 3 iterations, at the same bound; random pixels in the dead region
   leave every live crop bitwise equal (cuDNN deterministic).
7. times (CUDA events, after warm-up): each kernel per call beside its
   plain version and its bound; median request latency and pairs/s; the
   ragged batch's median and pairs/s beside the three pairs run one by one
   (printed, not held).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  No single PyTorch call computes any of the
kernels' functions, so library_ms is null.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
H_IMG, W_IMG, ITERS, N_PAIRS = 432, 1024, 12, 4
N_WINDOW = 2                 # phase 5 requests
BOX = (440, 1248)            # phase 6 max box and its live crops
CROPS = ((436, 1024), (375, 1242), (384, 512))   # Sintel, KITTI, FlyingChairs
TOL = 1e-5


def _time_ms(fn, warmup: int, reps: int) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= TOL + TOL * want.abs()).all())
    print(f"{name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(rtol=atol={TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def _corr_positions(coords: torch.Tensor, sizes, radius: int) -> int:
    """In-map (2r+2)^2 window positions over every (query, level): the dot
    products these coordinates need.  ``sizes``: the levels' (h, w), or
    the live crop's at each level."""
    win = 2 * radius + 2
    offs = torch.arange(win, device=coords.device)
    total = 0
    for lvl, (h2, w2) in enumerate(sizes):
        c = coords.reshape(-1, 2) / (2.0 ** lvl)
        ix0 = torch.floor(c[:, 0]).clamp(-1e8, 1e8).long() - radius
        iy0 = torch.floor(c[:, 1]).clamp(-1e8, 1e8).long() - radius
        nx = ((ix0[:, None] + offs >= 0) & (ix0[:, None] + offs < w2)).sum(1)
        ny = ((iy0[:, None] + offs >= 0) & (iy0[:, None] + offs < h2)).sum(1)
        total += int((nx * ny).sum())
    return total


def _gru_taps(H: int, W: int) -> int:
    """In-image (pixel, tap) pairs of one 1x5 pass plus one 5x1 pass."""
    def per_axis(n):
        return sum(1 for x in range(n) for d in range(5) if 0 <= x + d - 2 < n)
    return per_axis(W) * H + per_axis(H) * W


def _bound_ms(nbytes: int, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _within(name: str, fk: torch.Tensor, fp: torch.Tensor, crops=None):
    """|kernel - plain| over the full-model bound 1e-3 + 1e-3 * max|flow|,
    the worst item's; ``crops``: each item's live (h, w), else the whole
    map."""
    if crops is None:
        crops = [tuple(fk.shape[1:3])] * fk.shape[0]
    worst, msg = -1.0, ""
    for b, (h, w) in enumerate(crops):
        a, p = fk[b, :h, :w], fp[b, :h, :w]
        err = float((a - p).abs().max())
        bound = 1e-3 + 1e-3 * float(p.abs().max())
        if err / bound > worst:
            worst, msg = err / bound, f"{name}: max|diff| {err:.3e}, bound {bound:.3e}"
    return worst, msg


def _launches(*wrappers) -> dict:
    return {w.__name__.replace("_cuda", ""): w.launches for w in wrappers}


def _reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def main() -> int:
    # -- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from raft_tpu_torch import (RAFTConfig, embed_to_shape, init_raft_torch,
                                make_inference_fn, make_ragged_inference_fn)
    from raft_tpu_torch import _build
    from raft_tpu_torch.ops import corr_cuda, gru_cuda
    from raft_tpu_torch.models.raft import (encode_pair, gru_step, prepare_loop,
                                            raft_forward)
    from raft_tpu_torch.ops.coords import coords_grid
    from raft_tpu_torch.ops.corr import (fmap2_pyramid, live_mask,
                                         lookup_blockwise_onehot,
                                         lookup_ragged_plain,
                                         lookup_window_plain, mask_ragged_rows,
                                         ragged_pyramid)
    from raft_tpu_torch.ops.upsample import convex_upsample_flow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # with TF32 off, cuDNN's heuristic choice for the 3x3 256-channel convs
    # of the motion encoder at batch >= 3 on the 55x156 grid is an FFT
    # engine that takes ~250 ms per call; benchmark mode picks a ~0.8 ms one
    torch.backends.cudnn.benchmark = True
    print("tf32: off for matmuls and cuDNN (parity is float32 end to end); "
          "cudnn.benchmark on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    kernels = (corr_cuda.corr_lookup_cuda, corr_cuda.corr_window_cuda,
               corr_cuda.corr_ragged_cuda, gru_cuda.sep_conv_gru_cuda)

    # -- 2. build ------------------------------------------------------
    secs = _build.build_all()
    print(f"build: {secs:.1f} s into {_build.build_dir()}")
    print(_build.compiler_report())

    # -- 3. kernels vs plain at the main paths' shapes --------------------
    rng = np.random.RandomState(0)
    h8, w8, C, L, r = H_IMG // 8, W_IMG // 8, 256, 4, 4

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def noisy_coords(B, H, W):
        noise = rng.uniform(-(r + 3), r + 3, (B, H, W, 2))
        far = rng.rand(B, H, W) < 0.125               # wholly outside the map
        noise[far] += np.array([-300.0, 700.0])
        return (coords_grid(B, H, W, device=dev) + dev_t(noise)).contiguous()

    fmap1 = dev_t(rng.randn(1, h8, w8, C))
    levels = [lv.contiguous() for lv in
              fmap2_pyramid(dev_t(rng.randn(1, h8, w8, C)), L)]
    coords = noisy_coords(1, h8, w8)
    corr_k = corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r)
    corr_p = lookup_blockwise_onehot(fmap1, levels, coords, r)
    corr_err = _compare("corr_lookup [1,54,128,256] L=4 r=4", corr_k, corr_p)
    win_k = corr_cuda.corr_window_cuda(fmap1, levels, coords, r)
    win_err = _compare("corr_window [1,54,128,256] L=4 r=4", win_k,
                       lookup_window_plain(fmap1, levels, coords, r))
    _compare("corr_window against corr_lookup's output", win_k, corr_k)
    # windows scattered over the whole map, as random-weight flows give:
    # the kernel reads f2 from global memory instead of staging a box
    wild = (coords_grid(1, h8, w8, device=dev) + dev_t(rng.uniform(
        -w8, w8, (1, h8, w8, 2)))).contiguous()
    win_err = max(win_err, _compare(
        "corr_window, windows scattered over the map",
        corr_cuda.corr_window_cuda(fmap1, levels, wild, r),
        lookup_window_plain(fmap1, levels, wild, r)))

    hb, wb = BOX[0] // 8, BOX[1] // 8
    sizes8 = torch.tensor([[h // 8, w // 8] for h, w in CROPS],
                          dtype=torch.int32, device=dev)
    rf1 = mask_ragged_rows(dev_t(rng.randn(3, hb, wb, C)), sizes8).contiguous()
    rlevels = [lv.contiguous() for lv in
               ragged_pyramid(dev_t(rng.randn(3, hb, wb, C)), sizes8, L)]
    rcoords = noisy_coords(3, hb, wb)
    rag_k = corr_cuda.corr_ragged_cuda(rf1, rlevels, rcoords, sizes8, r)
    rag_p = lookup_ragged_plain(rf1, rlevels, rcoords, sizes8, r)
    live8 = live_mask(sizes8, hb, wb)
    rag_err = _compare(f"corr_ragged [3,{hb},{wb},256] sizes8 "
                       f"{sizes8.tolist()} live queries", rag_k[live8], rag_p[live8])
    rwild = (coords_grid(3, hb, wb, device=dev) + dev_t(rng.uniform(
        -wb, wb, (3, hb, wb, 2)))).contiguous()
    rag_err = max(rag_err, _compare(
        "corr_ragged, windows scattered over the map, live queries",
        corr_cuda.corr_ragged_cuda(rf1, rlevels, rwild, sizes8, r)[live8],
        lookup_ragged_plain(rf1, rlevels, rwild, sizes8, r)[live8]))
    dead_max = float(rag_k[~live8].abs().max())
    print(f"corr_ragged dead queries: {int((~live8).sum())}, max|out| {dead_max}")
    if dead_max != 0.0:
        raise AssertionError("corr_ragged: dead queries are not exact zeros")

    gen = torch.Generator().manual_seed(0)
    cfg_k = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    model = init_raft_torch(cfg_k, generator=gen, device=dev)
    fw = gru_cuda.fuse_gru_weights(model.update_block.gru, 128, 128)

    def gru_inputs(B, H, W):
        return (dev_t(np.tanh(rng.randn(B, H, W, 128))),
                dev_t(np.maximum(rng.randn(B, H, W, 128), 0.0)),
                (dev_t(0.5 * rng.randn(B, H, W, 384)),
                 dev_t(0.5 * rng.randn(B, H, W, 384))))

    gru_err = 0.0
    for B, H, W in ((1, h8, w8), (2, 37, 45)):
        h, mot, ctx = gru_inputs(B, H, W)
        got = gru_cuda.sep_conv_gru_cuda(fw, h, mot, ctx)
        want = gru_cuda.sep_conv_gru_plain(fw, h, mot, ctx)
        gru_err = max(gru_err, _compare(f"sep_conv_gru [{B},{H},{W},128]", got, want))

    # -- 4. main path: a few requests ------------------------------------
    def frame_pair(H, W, i):
        im1 = rng.rand(1, H, W, 3).astype(np.float32)
        im2 = np.roll(im1, (i + 1, 2 * i + 3), axis=(1, 2))
        im2 = np.clip(im2 + 0.02 * rng.randn(*im2.shape), 0, 1).astype(np.float32)
        return im1, im2

    pairs = [frame_pair(H_IMG, W_IMG, i) for i in range(N_PAIRS)]
    infer_k = make_inference_fn(cfg_k, iters=ITERS)
    cfg_p = RAFTConfig.full(corr_impl="blockwise", corr_lookup="onehot",
                            gru_impl="xla")
    infer_p = make_inference_fn(cfg_p, iters=ITERS)

    _reset(*kernels)
    flows_k = [infer_k(model, a, b) for a, b in pairs]
    torch.cuda.synchronize()
    launches = _launches(*kernels)
    print(f"main path: {N_PAIRS} requests at {H_IMG}x{W_IMG}, {ITERS} iters; "
          f"launches {launches}")
    for f in flows_k:
        if tuple(f.shape) != (1, H_IMG, W_IMG, 2) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"bad flow: shape {tuple(f.shape)}, finite "
                                 f"{bool(torch.isfinite(f).all())}")
    want = {"corr_lookup": N_PAIRS * ITERS, "corr_window": 0, "corr_ragged": 0,
            "sep_conv_gru": N_PAIRS * ITERS * gru_cuda.LAUNCHES_PER_CALL}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # Held to the plain versions at the full-model bound of the JAX suite
    # (tests/test_torch_golden.py).  The random-weight recurrence amplifies
    # any float32 difference ~7x per iteration (the plain path with 1e-7
    # of input noise diverges as far as the kernel path), so the bound is
    # applied (a) to every one of the 12 iterations, each kernel step and
    # plain step taken from the same state, and (b) end to end over 3
    # iterations, the horizon the JAX suite's full-model bound holds at.
    def step_parity(cfg_k, cfg_p, t1, t2, sizes=None, crops=None):
        """Worst (ratio, message) over the iterations, each kernel step and
        plain step taken from the same state."""
        sizes8 = None
        if sizes is not None:
            t1, t2 = mask_ragged_rows(t1, sizes), mask_ragged_rows(t2, sizes)
            sizes8 = sizes // 8
        fm1, fm2, net, inp = encode_pair(model, t1, t2, cfg_k)
        loop_k = prepare_loop(model, fm1, fm2, inp, cfg_k, sizes8)
        loop_p = prepare_loop(model, fm1, fm2, inp, cfg_p, sizes8)
        c0, coords1, worst = loop_k.coords0, loop_k.coords0, (0.0, "")
        for it in range(ITERS):
            net_k, ck, mk = gru_step(model, cfg_k, loop_k, net, coords1)
            _, cp, mp = gru_step(model, cfg_p, loop_p, net, coords1)
            worst = max(worst, _within(
                f"iteration {it}", convex_upsample_flow(ck - c0, mk),
                convex_upsample_flow(cp - c0, mp), crops))
            net, coords1 = net_k, ck
        return worst

    with torch.no_grad():
        for i, (a, b) in enumerate(pairs):
            t1 = torch.from_numpy(a).to(dev)
            t2 = torch.from_numpy(b).to(dev)
            worst = step_parity(cfg_k, cfg_p, t1, t2)
            e2e = _within("3 iterations end to end",
                          make_inference_fn(cfg_k, iters=3)(model, a, b),
                          make_inference_fn(cfg_p, iters=3)(model, a, b))
            print(f"pair {i}: every iteration, worst {worst[1]}; {e2e[1]}")
            if worst[0] > 1.0 or e2e[0] > 1.0:
                raise AssertionError(f"pair {i}: kernel path disagrees with "
                                     f"the plain path")
        # not held, printed: how the random-weight recurrence amplifies a
        # float32 difference, next to the plain path's own sensitivity
        t1, t2 = (torch.from_numpy(x).to(dev) for x in pairs[0])
        noisy = t1 + 1e-7 * torch.from_numpy(
            rng.randn(*pairs[0][0].shape).astype(np.float32)).to(dev)

        def flows(cfg, x1):
            return raft_forward(model, x1, t2, cfg, iters=ITERS,
                                all_flows=True).flow_iters

        fk, fp, fp_again, fp_noisy = (flows(cfg_k, t1), flows(cfg_p, t1),
                                      flows(cfg_p, t1), flows(cfg_p, noisy))

        def ratios(x):
            return " ".join(f"{_within('', x[i], fp[i])[0]:.2g}" for i in range(ITERS))

        print(f"pair 0, {ITERS} iterations end to end, |diff| / bound per "
              f"iteration (not held: the random-weight recurrence is "
              f"chaotic): kernel vs plain [{ratios(fk)}]; plain on frame 1 "
              f"+ 1e-7 noise vs plain [{ratios(fp_noisy)}]; plain rerun max "
              f"|diff| {float((fp_again - fp).abs().max()):.3g}; final "
              f"{_within('kernel vs plain', fk[-1], fp[-1])[1]}")

    # -- 5. window main path ---------------------------------------------
    cfg_w = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                            pallas_p_select="window")
    infer_w = make_inference_fn(cfg_w, iters=ITERS)
    _reset(*kernels)
    flows_w = [infer_w(model, a, b) for a, b in pairs[:N_WINDOW]]
    torch.cuda.synchronize()
    launches_w = _launches(*kernels)
    print(f"window path: {N_WINDOW} requests at {H_IMG}x{W_IMG}, {ITERS} "
          f"iters; launches {launches_w}")
    want = {"corr_lookup": 0, "corr_window": N_WINDOW * ITERS, "corr_ragged": 0,
            "sep_conv_gru": N_WINDOW * ITERS * gru_cuda.LAUNCHES_PER_CALL}
    if launches_w != want:
        raise AssertionError(f"window path launch counts {launches_w} != {want}")
    with torch.no_grad():
        for i, ((a, b), f) in enumerate(zip(pairs, flows_w)):
            if not bool(torch.isfinite(f).all()):
                raise AssertionError(f"window path pair {i}: non-finite flow")
            worst = step_parity(cfg_w, cfg_p, torch.from_numpy(a).to(dev),
                                torch.from_numpy(b).to(dev))
            e2e = _within("3 iterations end to end",
                          make_inference_fn(cfg_w, iters=3)(model, a, b),
                          make_inference_fn(cfg_p, iters=3)(model, a, b))
            print(f"window pair {i}: every iteration, worst {worst[1]}; {e2e[1]}")
            if worst[0] > 1.0 or e2e[0] > 1.0:
                raise AssertionError(f"window pair {i}: kernel path disagrees "
                                     f"with the plain path")

    # -- 6. ragged path: Sintel, KITTI and Chairs frames in one batch -----
    crops = [frame_pair(h, w, 5 + i) for i, (h, w) in enumerate(CROPS)]
    rim1 = np.concatenate([embed_to_shape(c[0], BOX) for c in crops])
    rim2 = np.concatenate([embed_to_shape(c[1], BOX) for c in crops])
    sizes = np.array(CROPS, np.int32)
    infer_r = make_ragged_inference_fn(cfg_k, iters=ITERS)
    _reset(*kernels)
    flow_r = infer_r(model, rim1, rim2, sizes)
    torch.cuda.synchronize()
    launches_r = _launches(*kernels)
    print(f"ragged path: batch of 3 in a {BOX[0]}x{BOX[1]} box, live "
          f"{[list(c) for c in CROPS]}, {ITERS} iters; launches {launches_r}")
    want = {"corr_lookup": 0, "corr_window": 0, "corr_ragged": ITERS,
            "sep_conv_gru": ITERS * gru_cuda.LAUNCHES_PER_CALL}
    if launches_r != want:
        raise AssertionError(f"ragged path launch counts {launches_r} != {want}")
    for b, (h, w) in enumerate(CROPS):
        if not bool(torch.isfinite(flow_r[b, :h, :w]).all()):
            raise AssertionError(f"ragged item {b}: non-finite flow on its crop")
    ragged_k = make_ragged_inference_fn(cfg_k, iters=3)
    with torch.no_grad():
        sz = torch.from_numpy(sizes).to(dev)
        worst = step_parity(cfg_k, cfg_p, torch.from_numpy(rim1).to(dev),
                            torch.from_numpy(rim2).to(dev), sz, CROPS)
        mixed = ragged_k(model, rim1, rim2, sizes)
        e2e = _within("3 iterations end to end", mixed,
                      make_ragged_inference_fn(cfg_p, iters=3)(
                          model, rim1, rim2, sizes), CROPS)
        print(f"ragged batch, each live crop: every iteration, worst "
              f"{worst[1]}; {e2e[1]}")
        if worst[0] > 1.0 or e2e[0] > 1.0:
            raise AssertionError("ragged kernel path disagrees with the plain "
                                 "ragged path")
        for b, (h, w) in enumerate(CROPS):
            solo = ragged_k(model, rim1[b:b + 1], rim2[b:b + 1], sizes[b:b + 1])
            sm = _within(f"item {b} solo vs mixed, 3 iterations", solo,
                         mixed[b:b + 1], [(h, w)])
            print(sm[1])
            if sm[0] > 1.0:
                raise AssertionError(f"ragged item {b}: solo disagrees with mixed")
        # garbage in the dead region changes nothing, bit for bit
        torch.backends.cudnn.deterministic = True
        junk1, junk2 = (rng.rand(*rim1.shape).astype(np.float32) for _ in range(2))
        for b, (h, w) in enumerate(CROPS):
            junk1[b, :h, :w], junk2[b, :h, :w] = rim1[b, :h, :w], rim2[b, :h, :w]
        clean = infer_r(model, rim1, rim2, sizes)
        dirty = infer_r(model, junk1, junk2, sizes)
        torch.backends.cudnn.deterministic = False
        same = [bool(torch.equal(clean[b, :h, :w], dirty[b, :h, :w]))
                for b, (h, w) in enumerate(CROPS)]
        print(f"ragged batch with random pixels in the dead region: live crops "
              f"bitwise equal {same}")
        if not all(same):
            raise AssertionError("dead-region pixels changed a live crop's flow")

    # -- 7. times ----------------------------------------------------------
    corr_ms = _time_ms(lambda: corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r), 3, 50)
    corr_plain_ms = _time_ms(lambda: lookup_blockwise_onehot(fmap1, levels, coords, r), 1, 10)
    level_hw = [(lv.shape[1], lv.shape[2]) for lv in levels]
    corr_bytes = 4 * (fmap1.numel() + sum(lv.numel() for lv in levels)
                      + coords.numel() + corr_k.numel())
    corr_flops = 2 * C * _corr_positions(coords, level_hw, r) + 7 * corr_k.numel()
    corr_bound, corr_by = _bound_ms(corr_bytes, corr_flops)

    win_ms = _time_ms(lambda: corr_cuda.corr_window_cuda(fmap1, levels, coords, r), 3, 50)
    win_plain_ms = _time_ms(lambda: lookup_window_plain(fmap1, levels, coords, r), 1, 5)

    rag_ms = _time_ms(lambda: corr_cuda.corr_ragged_cuda(rf1, rlevels, rcoords, sizes8, r), 3, 50)
    rag_plain_ms = _time_ms(lambda: lookup_ragged_plain(rf1, rlevels, rcoords, sizes8, r), 1, 5)
    rag_pos = 0
    for b, (h, w) in enumerate(sizes8.tolist()):
        clip = [(min(lv.shape[1], h >> i), min(lv.shape[2], w >> i))
                for i, lv in enumerate(rlevels)]
        rag_pos += _corr_positions(rcoords[b][live8[b]], clip, r)
    rag_bytes = 4 * (rf1.numel() + sum(lv.numel() for lv in rlevels)
                     + rcoords.numel() + sizes8.numel() + rag_k.numel())
    rag_flops = 2 * C * rag_pos + 7 * int(live8.sum()) * L * (2 * r + 1) ** 2
    rag_bound, rag_by = _bound_ms(rag_bytes, rag_flops)

    h, mot, ctx = gru_inputs(1, h8, w8)
    gru_ms = _time_ms(lambda: gru_cuda.sep_conv_gru_cuda(fw, h, mot, ctx), 3, 50)
    gru_plain_ms = _time_ms(lambda: gru_cuda.sep_conv_gru_plain(fw, h, mot, ctx), 2, 10)
    macs_per_tap = 256 * 256 + (128 + 128) * 128     # launch A + launch B
    gru_flops = 2 * macs_per_tap * _gru_taps(h8, w8) + 20 * h.numel() * 2
    gru_bytes = 4 * (h.numel() * 2 + mot.numel() + ctx[0].numel() + ctx[1].numel()
                     + sum(v.numel() for v in fw.values()))
    gru_bound, gru_by = _bound_ms(gru_bytes, gru_flops)
    print(f"corr_lookup: {corr_ms:.4f} ms/call (plain {corr_plain_ms:.4f}), bound "
          f"{corr_bound:.4f} ms by {corr_by} ({corr_flops / 1e9:.3f} GFLOP, "
          f"{corr_bytes / 1e6:.1f} MB)")
    print(f"corr_window: {win_ms:.4f} ms/call (plain {win_plain_ms:.4f}), bound "
          f"{corr_bound:.4f} ms by {corr_by} (the inputs and work of corr_lookup)")
    print(f"corr_ragged: {rag_ms:.4f} ms/call (plain {rag_plain_ms:.4f}), bound "
          f"{rag_bound:.4f} ms by {rag_by} ({rag_flops / 1e9:.3f} GFLOP, "
          f"{rag_bytes / 1e6:.1f} MB)")
    print(f"sep_conv_gru: {gru_ms:.4f} ms/call (plain {gru_plain_ms:.4f}), bound "
          f"{gru_bound:.4f} ms by {gru_by} ({gru_flops / 1e9:.3f} GFLOP, "
          f"{gru_bytes / 1e6:.1f} MB)")
    print("library_ms: null for all — no single PyTorch call computes a "
          "windowed correlation lookup or a SepConvGRU iteration")

    def call_ms(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(model, *args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    call_ms(infer_k, *pairs[0])
    lat_k = [call_ms(infer_k, *pairs[i % N_PAIRS]) for i in range(8)]
    call_ms(infer_p, *pairs[0])
    lat_p = [call_ms(infer_p, *pairs[i % N_PAIRS]) for i in range(4)]
    med_k, med_p = statistics.median(lat_k), statistics.median(lat_p)
    print(f"e2e {H_IMG}x{W_IMG} batch 1, {ITERS} iters: kernels median "
          f"{med_k:.2f} ms/request ({1e3 / med_k:.2f} pairs/s); plain median "
          f"{med_p:.2f} ms/request ({1e3 / med_p:.2f} pairs/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    call_ms(infer_w, *pairs[0])
    med_w = statistics.median([call_ms(infer_w, *pairs[i % N_PAIRS]) for i in range(8)])
    print(f"e2e {H_IMG}x{W_IMG} batch 1, {ITERS} iters, pallas_p_select='window': "
          f"median {med_w:.2f} ms/request ({1e3 / med_w:.2f} pairs/s)")

    call_ms(infer_r, rim1, rim2, sizes)
    lat_r = [call_ms(infer_r, rim1, rim2, sizes) for _ in range(6)]
    med_r = statistics.median(lat_r)
    live_share = sum(h * w for h, w in CROPS) / (len(CROPS) * BOX[0] * BOX[1])
    seq = []
    for (a, b), (h, w) in zip(crops, CROPS):
        hw8 = (-(-h // 8) * 8, -(-w // 8) * 8)
        a8, b8 = embed_to_shape(a, hw8), embed_to_shape(b, hw8)
        call_ms(infer_k, a8, b8)
        seq.append(statistics.median([call_ms(infer_k, a8, b8) for _ in range(4)]))
    print(f"ragged batch of 3 in {BOX[0]}x{BOX[1]}, {ITERS} iters: median "
          f"{med_r:.2f} ms/batch ({3e3 / med_r:.2f} pairs/s), live-pixel share "
          f"{live_share:.3f}; not held: the 3 pairs one by one through "
          f"make_inference_fn at their sizes padded to multiples of 8: "
          f"{' + '.join(f'{x:.2f}' for x in seq)} = {sum(seq):.2f} ms "
          f"({3e3 / sum(seq):.2f} pairs/s)")

    # where a request's time goes: stages by CUDA events, kernels and the
    # device's idle share by torch.profiler
    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    a, b = (torch.from_numpy(x).to(dev) for x in pairs[0])
    with torch.no_grad():
        e0 = ev()
        fm1, fm2, net, inp = encode_pair(model, a, b, cfg_k)
        e1 = ev()
        loop = prepare_loop(model, fm1, fm2, inp, cfg_k)
        e2 = ev()
        c1 = loop.coords0
        for _ in range(ITERS):
            net, c1, mk = gru_step(model, cfg_k, loop, net, c1)
        e3 = ev()
        convex_upsample_flow(c1 - loop.coords0, mk)
        e4 = ev()
    torch.cuda.synchronize()
    stages = {"encoders": e0.elapsed_time(e1), "loop_setup": e1.elapsed_time(e2),
              "iterations": e2.elapsed_time(e3), "upsample": e3.elapsed_time(e4)}
    print("stages ms/request: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    # the two lookups on this request's own coordinates: at the first
    # iteration (flow 0, coherent windows) and after the last (the random
    # weights' flow of hundreds of pixels, incoherent windows)
    mf1 = fm1.permute(0, 2, 3, 1).contiguous()
    mlev = [lv.contiguous() for lv in fmap2_pyramid(fm2.permute(0, 2, 3, 1).contiguous(), L)]
    for label, cc in (("first iteration", loop.coords0), ("after the last", c1.contiguous())):
        print(f"main-path coords, {label} (max|flow| "
              f"{float((cc - loop.coords0).abs().max()):.1f}): corr_window "
              f"{_time_ms(lambda: corr_cuda.corr_window_cuda(mf1, mlev, cc, r), 3, 30):.4f}"
              f" ms/call, corr_lookup "
              f"{_time_ms(lambda: corr_cuda.corr_lookup_cuda(mf1, mlev, cc, r), 3, 30):.4f}"
              f" ms/call")
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, plural, n, run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s0 = ev()
            for _ in range(n):
                run()
            s1 = ev()
            torch.cuda.synchronize()
        window = s0.elapsed_time(s1)
        kern = [k for k in prof.key_averages()
                if k.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(k.self_device_time_total for k in kern) / 1e3
        print(f"profiler: {n} {plural}, {window:.2f} ms window, kernels busy "
              f"{busy:.2f} ms, device idle share {1 - busy / window:.3f}")
        for k in sorted(kern, key=lambda k: -k.self_device_time_total)[:10]:
            print(f"  {k.self_device_time_total / (n * 1e3):8.3f} ms/{label} "
                  f"{k.count / n:6.1f} launches/{label}  {k.key[:90]}")

    it_pairs = iter(pairs[:2])
    profiled("request", "requests", 2, lambda: infer_k(model, *next(it_pairs)))
    profiled("batch", "ragged batches", 2, lambda: infer_r(model, rim1, rim2, sizes))
    # why cudnn.benchmark is on: the motion encoder's convc2 at batch 3 and
    # about the ragged box's grid, by cuDNN's heuristic choice and
    # benchmarked.  Plans are cached by shape whatever the mode, so each
    # mode gets a grid no earlier call used.
    conv = model.update_block.encoder.convc2
    conv_ms = {}
    with torch.no_grad():
        for bench, w in ((False, wb + 4), (True, wb + 8)):
            x = torch.randn(3, conv.in_channels, hb, w, device=dev).contiguous(
                memory_format=torch.channels_last)
            torch.backends.cudnn.benchmark = bench
            conv_ms[bench] = (w, _time_ms(lambda: conv(x), 1, 2))
    torch.backends.cudnn.benchmark = True
    print(f"cuDNN FP32 conv {conv.in_channels}->{conv.out_channels} 3x3, "
          f"batch 3: heuristic choice at {hb}x{conv_ms[False][0]} "
          f"{conv_ms[False][1]:.3f} ms/call, benchmark mode at "
          f"{hb}x{conv_ms[True][0]} {conv_ms[True][1]:.3f} ms/call")
    print(json.dumps({"e2e": {"latency_ms_median": med_k, "pairs_per_s": 1e3 / med_k,
                              "latency_ms_all": lat_k, "plain_latency_ms_median": med_p,
                              "plain_pairs_per_s": 1e3 / med_p,
                              "window_latency_ms_median": med_w,
                              "ragged_batch_ms_median": med_r,
                              "ragged_pairs_per_s": 3e3 / med_r,
                              "ragged_batch_ms_all": lat_r,
                              "ragged_live_pixel_share": live_share,
                              "one_by_one_ms": seq}}))

    def entry(name, source, replaces, runs, err, ms, plain_ms, bound, by):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None}

    print(json.dumps({"kernels": [
        entry("corr_lookup", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:349", launches["corr_lookup"],
              corr_err, corr_ms, corr_plain_ms, corr_bound, corr_by),
        entry("sep_conv_gru", "raft_tpu_torch/csrc/sep_conv_gru.cu",
              "raft_tpu/ops/gru_pallas.py:242", launches["sep_conv_gru"],
              gru_err, gru_ms, gru_plain_ms, gru_bound, gru_by),
        entry("corr_window", "raft_tpu_torch/csrc/corr_window.cu",
              "raft_tpu/ops/corr_pallas.py:342", launches_w["corr_window"],
              win_err, win_ms, win_plain_ms, corr_bound, corr_by),
        entry("corr_ragged", "raft_tpu_torch/csrc/corr_window.cu",
              "raft_tpu/ops/corr_pallas.py:604", launches_r["corr_ragged"],
              rag_err, rag_ms, rag_plain_ms, rag_bound, rag_by),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
