#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is not 0:

1. device: CUDA must be available; prints the card's name and power limit
   (nvidia-smi).  TF32 is switched off for matmuls and cuDNN in the whole
   process (the float32 entry points also turn it off themselves: phase
   6e), so every comparison below is float32 end to end; cuDNN runs in
   benchmark mode.
2. build: compiles the two kernel sources of raft_tpu_torch/csrc (nvcc,
   one process each, all started together, into build/raft_tpu_torch/) and
   prints the build time and ptxas's report.
3. kernels vs plain, at the main paths' shapes, each held to its plain
   PyTorch version at rtol = atol = 1e-5: the correlation lookup on a
   [1, 54, 128, 256] query map and its 4-level pyramid (coords with noise
   of +-(r+3) px and a share of queries wholly outside the map); the
   window-scheduled lookup on the same inputs and on windows scattered over
   the whole map, in both dtypes (its output bitwise equal to the first
   lookup's on the same inputs: it runs the first lookup's kernel); the
   ragged lookup on a [3, 55, 156, 256] max box with live sizes8
   [[54, 128], [46, 155], [48, 64]], on both kinds of coords (live queries
   held, dead ones exactly 0), and with a fourth item live [3, 5] whose
   levels 2-3 hold no live row (exact zeros; NaN outside every crop leaves
   the output bitwise equal: nothing outside a crop is read); the
   SepConvGRU at 54x128, 2x37x45 and 2x23x70 (no tile divides the last
   two).  The packed lookup (pallas_pack=True, one launch over every level)
   under 'all' and 'window' on the [1, 54, 128, 256] maps (levels 1-3
   narrow) with both kinds of coords and on a FlyingChairs-width
   [1, 48, 64, 256] map (every level narrow), each against its plain
   version and against the first lookup's output; a 0x0 level gives exact
   zeros.  The bfloat16 instantiations (corr_precision='default' operands)
   of the four lookups against their plain versions on the same bfloat16
   operands at 1e-5, and the bfloat16-I/O GRU against its plain version
   within 1 bf16 ulp of max|h| (both compute in float32 and round once: a
   sum that lands at a rounding boundary may round the other way), at all
   three GRU shapes.  The first lookup, both entries, also on scattered
   windows, on a quarter of the queries scattered among coherent ones,
   with the left half of the grid wholly off the map, at radius 15 and at
   C = 100.  Every case of the four lookups that share corr_lookup.cu's
   tile body (first, window, ragged, packed) is held with its tiles sent by
   their window boxes, all on the MMA path and all on the gather (the tiles
   on each path printed).
4. main path: raft-things (full width and depth, seeded random weights) on
   4 seeded frame pairs at 432x1024, batch 1, 12 iterations, through
   raft_forward (the eager forward that make_inference_fn captures; every
   launch count and parity check of phases 4-6h runs eager) with
   corr_impl='pallas', gru_impl='pallas'.  The flows
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
   KITTI 375x1242, FlyingChairs 384x512), eager with sizes, 12 iterations: the ragged kernel once per iteration, the GRU kernel 4
   times, the other lookups never; finite flows on each live crop; the
   parity of phase 4 against the plain ragged configuration on each live
   crop; each item alone (batch 1, same box) against its row of the batch
   over 3 iterations, at the same bound; random pixels in the dead region
   leave every live crop bitwise equal (cuDNN deterministic).
6b. P32 path (pallas_pack=True): 2 of those pairs under p_select 'all'
   and 'window'; per iteration one launch of the packed lookup and none of
   the other lookups; the same parity as phase 4.
6c. BF path: the bench's pallas-bf16corr-ctx-gru-winpack configuration
   (compute_dtype='bfloat16', corr_precision='default', pallas_pack=True,
   p_select='window', p_blk 1024) on a bfloat16 copy of the model, 2 pairs:
   finite flows, the bfloat16 kernels' launches.  Per iteration the kernel
   step is held to the plain bfloat16 step from the same state, within the
   plain bfloat16 step's own distance from the plain float32 step from
   that state (the kernels change only the order of float32 sums, so they
   must stay below what bfloat16 itself changes).  One request each of
   pallas-bf16corr-ctx-gru (no pack, p_select 'all') and of its -win twin
   (p_select 'window') drives the bfloat16 first and window lookups.
   Then the ragged batch of phase 6 under bfloat16 and
   'default', held the same way on each live crop.
6d. C1 weights: the seeded weights with every conv bias and batch-norm
   beta drawn from U(-0.25, 0.25), every gamma from U(0.75, 1.25) and the
   running statistics away from identity; one request each of the float32
   main path and of BF (launch counts), each held per iteration as in
   phases 4 and 6c.
6e. C2: under PyTorch's default switches (cuDNN TF32 on) a 3-iteration
   float32 request through make_inference_fn (captured under them) gives,
   within the bound of phase 4, the flow of the same request with TF32 off
   in the process, and leaves the switches as the caller set them; the
   same forward with cuDNN TF32 on is printed beside it.
6f. capture: the f32 main path, BF, pallas-bf16corr-ctx-gru and the ragged
   batch in f32 and in bf16, each through its factory (make_inference_fn,
   make_ragged_inference_fn: a CUDA graph captured at the first call,
   replayed after it), 2 requests (the ragged batch 1): one capture, whose
   launch counts are twice an eager request's (the warm-up and the
   captured forward) and the replays' none; each replay equal to the eager
   forward of the same request bitwise (else within phase 4's bound, the
   reason printed), an earlier result left as it was by later replays; the
   graph pool's size.  A second key (a 384x512 pair; the ragged box at
   batch 2) captures a second graph and the first still replays right;
   new sizes in the same box replay with no new capture; after an
   in-place load_state_dict of the C1 weights the replay follows them, and
   after the model's storages move the next call captures anew.
6g. raft-small: corr_lookup at raft-small's shape ([1, 54, 128, 128],
   4 levels, radius 3) held three ways to its plain version in both
   entries (noisy and scattered coords), timed beside its plain version
   and its bound; the window and the packed lookups ('all', 'window') on
   the same maps and the ragged lookup on phase 3's box at C = 128, both
   entries, held three ways likewise; RAFTConfig.small_model(corr_impl=
   'pallas') on 2 pairs, 12 iterations, float32 and bfloat16 ('default'
   corr): one corr_lookup launch per iteration, no GRU kernel (its 3x3
   ConvGRU is stock PyTorch); per iteration and over 3 iterations held to
   small_model(corr_impl='blockwise') as in phase 4 (bf16 as in phase 6c);
   each captured equal to eager; then one float32 request each under
   pallas_p_select='window', pallas_pack=True and on phase 6's ragged
   batch: its kernel once per iteration and no other, per iteration held
   to 'blockwise' as in phase 4.
6h. dense: RAFTConfig.full() and RAFTConfig.small_model() as they stand
   (corr_impl='dense', 'onehot', the plain GRU) on 2 pairs: no kernel
   launched, finite flows, the peak memory of a request and the dense
   pyramid's bytes; per iteration held to corr_impl='pallas' on the same
   weights as in phase 4; each captured equal to eager.
6i. converge (6c): a batch of 2 (pairs 0 and 1) at 432x1024, 12
   iterations, f32 main and BF, under converge:eps:min_iters with eps
   picked from an eager run's per-iteration dn (each row's mean flow-update
   norm, computed as the loop computes it) so that the rows freeze at
   different iterations: eager iters_used as predicted, the kernels
   launched once per iteration that ran, each kernel step at the batch of
   2 held to the plain step from the same state (phase 4's bound; BF as in
   6c), the plain path's dn and the iters_used it gives printed;
   make_counted_inference_fn
   captured as three graphs (prologue, one masked iteration, epilogue):
   bitwise equal to eager, iteration replays = max(iters_used), the capture
   counting two iterations' launches and replays none; converge:0 captured
   bitwise equal to the fixed policy's graph, with 12 replays;
   converge:1e9:6 (every row stops at iteration 6, half the loop) with 6
   replays; make_ragged_counted_inference_fn under converge:1e9:3 on
   phase 6's ragged batch (B4), captured bitwise equal to eager.
6j. stream (6d): a 4-frame sequence (a seeded texture translated by
   (3, 5) px a frame, with noise), f32 main and BF: make_encode_fn, then 3
   solo steps (make_stream_step_fn, the warm start's seed from the last
   flow_lr), eager (launch counts) and captured (bitwise equal; the
   capture counting twice a step's launches, replays none);
   make_stream_batch_step_fn on 4 slots of a 5-row pool (one padding row on
   the scratch slot); the same pool as int8 rows (quantize_rows); the
   ragged stream batch on phase 6's box (B4).  On each of these paths, at
   its own batch and from the features it computed (the int8 rows
   dequantized on both sides), every iteration's kernel step is held to
   the plain step from the same state, at phase 4's bound in f32 and as in
   6c in bf16.  Besides, each solo step is held to the pairwise request on
   the same frames and seed, each real batch row to its solo step and each
   ragged crop to the pairwise ragged request, per iteration from the same
   state (two encoder passes' features) at phase 4's bound in f32 and, in
   bf16, within twice the bf16 step's own distance from the f32 step
   (ROADMAP's bf16 finding of the check: bf16 convs differ between batch
   widths), and over 3 iterations (held in f32, printed in bf16); the
   int8 batch's distance from the unquantized one printed; the solo and
   the batch step under converge:1e9:3 (three
   graphs each, the encoder pass in the prologue: iters_used 3, the
   padding row 0, 3 iteration replays); every captured step bitwise equal
   to its eager run.
6k. 6e rest: one request each of corr_impl='blockwise' with
   corr_lookup='gather' (no kernel) and of gru_ctx_hoist=False (B1 and the
   un-hoisted plain GRU), per iteration held to the f32 main path,
   captured equal to eager.
7. times (CUDA events, after warm-up): each kernel per call beside its
   plain version and its bound — the packed lookup beside the first and
   the window lookups on the same inputs, each bfloat16
   instantiation beside its float32 kernel; the two paths and the
   MMA_RATIO threshold of the first and the packed lookups on phase 3's
   noisy and scattered coords and on the main path's own at its first
   iteration, after 3 and after 12 (the packed lookup's narrow levels also
   each alone), and of the ragged lookup
   on phase 3's box and on the ragged batch's own coords (the first lookup
   beside it); median request latency and pairs/s of the main, window,
   P32 and BF paths, of pallas-bf16corr-ctx-gru and of its -win twin, of
   the ragged batch in float32 and in bfloat16, of raft-small in both
   dtypes and of the two dense configurations, each captured (its factory)
   and eager (raft_forward), in turns; the ragged batch beside the three
   pairs run one by one (printed, not held); BF's loop set-up eager and as
   a graph of its own; the clone of a captured call's output (the f32 main
   path's flow, flow_lr and iters_used); the device idle share (torch.profiler) of the f32
   main path, BF, pallas-bf16corr-ctx-gru and the ragged batch in both
   dtypes, captured and eager; the new paths of 6i-6k in turns, captured
   and eager: converge beside the fixed policy's graph and converge:0 (its
   excess over the fixed graph per iteration: a replay launch and its flag
   read), the solo stream step beside the pairwise request, the batch step
   beside 3 solo steps, int8 slots, the ragged stream batch, 'blockwise' +
   'gather' and the un-hoisted GRU; the total wall time.

Before the last two lines the e2e JSON record (PERF.md §2 says what each
key means); the line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.  No single PyTorch call computes any of the
kernels' functions, so library_ms is null.  A bound is the larger of the
bytes over the memory rate and the operations over the card's rate for
them, each product priced at the fastest route the card offers at its
accuracy (RATES): bfloat16 x bfloat16 one BF16 MMA (989 TFLOP/s),
bfloat16 x float32 three BF16 MMAs of bfloat16 pieces (989/3), float32 x
float32 3xTF32 (495/3), elementwise and bilinear arithmetic the FP32 rate
(67), whatever route a kernel takes.
cuDNN's benchmark mode is on from phase 1, before the first float32 or
bfloat16 call of any shape.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA's data sheet, dense).  A product is priced at the
# card's fastest route at that product's accuracy:
RATES = {"bf16": 989e12,              # bf16 x bf16: one BF16 MMA, f32 sums
         "bf16xf32": 989e12 / 3,      # f32 operand in three bf16 pieces
         "f32xf32": 495e12 / 3,       # 3xTF32: hi*hi' + hi*lo' + lo*hi'
         "fp32": 67e12}               # elementwise, bilinear: FP32 cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
H_IMG, W_IMG, ITERS, N_PAIRS = 432, 1024, 12, 4
N_WINDOW = 2                 # phase 5, 6b and 6c requests
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


def _compare_ulp(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """bfloat16 outputs within 1 bf16 ulp (8 significant bits) of max|want|."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    ok = bool(torch.isfinite(got).all()) and err <= ulp
    print(f"{name}: max_abs_err {err:.3e}, 1 bf16 ulp of max|h| {ulp:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


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


def _gru_flops(B: int, H: int, W: int, hid: int, mot: int, bf16_io: bool):
    """The operations of one SepConvGRU call by RATES kind: each in-image
    tap of the 1x5 and the 5x1 pass multiplies [h, motion] by the z|r
    weights and [r*h, motion] by the q weights, plus ~20 elementwise FLOPs
    per output of each pass.  With bfloat16 I/O the weights are
    bf16-rounded, so a product of them with h (pass 1) or motion is one of
    two bfloat16 values; r*h and h1, the pass-2 input, are float32."""
    def per_axis(n):
        return sum(1 for x in range(n) for d in range(5) if 0 <= x + d - 2 < n)
    t1, t2 = B * per_axis(W) * H, B * per_axis(H) * W
    zr_h, zr_m = hid * 2 * hid, mot * 2 * hid      # MACs per tap
    q_h, q_m = hid * hid, mot * hid
    elementwise = 20 * B * H * W * hid * 2
    if not bf16_io:
        return {"f32xf32": 2 * (t1 + t2) * (zr_h + zr_m + q_h + q_m),
                "fp32": elementwise}
    return {"bf16": 2 * (t1 * (zr_h + zr_m + q_m) + t2 * (zr_m + q_m)),
            "bf16xf32": 2 * (t1 * q_h + t2 * (zr_h + q_h)),
            "fp32": elementwise}


def _bound_ms(nbytes: int, ops: dict):
    """(ms, by): the larger of the bytes over the memory rate and the
    operations over their RATES."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(n / RATES[kind] for kind, n in ops.items())
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


def _corr_bound(f1, levels, coords, radius, positions=None, n_out=None,
                reads=None):
    """(bound ms, by) of a lookup on these inputs: ``reads`` bytes read
    once (None: f1, the levels and coords in full), the output written
    once; 2 FLOPs per channel of each in-map window position
    (``positions``, counted from ``coords`` when None), float32 x float32
    products or, for bfloat16 operands, bfloat16 x bfloat16 ones, and 7
    FP32 FLOPs per bilinear output (``n_out``, every query's when None)."""
    out_numel = coords.numel() // 2 * len(levels) * (2 * radius + 1) ** 2
    n_out = out_numel if n_out is None else n_out
    if positions is None:
        positions = _corr_positions(
            coords, [(x.shape[1], x.shape[2]) for x in levels], radius)
    if reads is None:
        reads = (f1.element_size() * (f1.numel() + sum(x.numel() for x in levels))
                 + 4 * coords.numel())
    nbytes = reads + 4 * out_numel
    dots = 2 * f1.shape[-1] * positions
    kind = "bf16" if f1.dtype == torch.bfloat16 else "f32xf32"
    return _bound_ms(nbytes, {kind: dots, "fp32": 7 * n_out})


def gru_inputs(rng, dev, B: int, H: int, W: int):
    """Seeded SepConvGRU operands on a [B, H, W] grid: h, motion and the two
    hoisted context terms (hidden, motion and context 128), float32."""
    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return (dev_t(np.tanh(rng.randn(B, H, W, 128))),
            dev_t(np.maximum(rng.randn(B, H, W, 128), 0.0)),
            (dev_t(0.5 * rng.randn(B, H, W, 384)),
             dev_t(0.5 * rng.randn(B, H, W, 384))))


def kernel_inputs(rng, dev, C: int = 256, L: int = 4, r: int = 4) -> dict:
    """Phase 3's seeded kernel inputs at the main paths' shapes, drawn from
    ``rng`` in this order (tools/port_kernel_ab.py times kernels on them
    too): a [1, 54, 128, C] fmap1 and the L-level pyramid of another map;
    coords with noise of +-(r+3) px and an eighth of the queries wholly
    outside the map; windows scattered over the whole map; the ragged
    [3, 55, 156, C] box masked to CROPS // 8 (``sizes8``) with both kinds of
    coords; the GRU's operands on the 54x128 grid."""
    from raft_tpu_torch.ops.coords import coords_grid
    from raft_tpu_torch.ops.corr import (fmap2_pyramid, mask_ragged_rows,
                                         ragged_pyramid)
    h8, w8, hb, wb = H_IMG // 8, W_IMG // 8, BOX[0] // 8, BOX[1] // 8

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def noisy(B, H, W):
        noise = rng.uniform(-(r + 3), r + 3, (B, H, W, 2))
        far = rng.rand(B, H, W) < 0.125               # wholly outside the map
        noise[far] += np.array([-300.0, 700.0])
        return (coords_grid(B, H, W, device=dev) + dev_t(noise)).contiguous()

    def scattered(B, H, W):                           # as random-weight flows give
        return (coords_grid(B, H, W, device=dev) + dev_t(rng.uniform(
            -W, W, (B, H, W, 2)))).contiguous()

    x = {"fmap1": dev_t(rng.randn(1, h8, w8, C))}
    x["levels"] = [lv.contiguous() for lv in
                   fmap2_pyramid(dev_t(rng.randn(1, h8, w8, C)), L)]
    x["coords"] = noisy(1, h8, w8)
    x["wild"] = scattered(1, h8, w8)
    x["sizes8"] = torch.tensor([[h // 8, w // 8] for h, w in CROPS],
                               dtype=torch.int32, device=dev)
    x["rf1"] = mask_ragged_rows(dev_t(rng.randn(3, hb, wb, C)),
                                x["sizes8"]).contiguous()
    x["rlevels"] = [lv.contiguous() for lv in ragged_pyramid(
        dev_t(rng.randn(3, hb, wb, C)), x["sizes8"], L)]
    x["rcoords"] = noisy(3, hb, wb)
    x["rwild"] = scattered(3, hb, wb)
    x["gru"] = gru_inputs(rng, dev, 1, h8, w8)
    return x


def _launches(*wrappers) -> dict:
    return {w.__name__.replace("_cuda", ""): w.launches for w in wrappers}


def _reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from raft_tpu_torch import (RAFTConfig, embed_to_shape, encode_frame,
                                forward_from_features, init_raft_torch,
                                make_counted_inference_fn, make_encode_fn,
                                make_inference_fn,
                                make_ragged_counted_inference_fn,
                                make_ragged_inference_fn,
                                make_ragged_stream_batch_step_fn,
                                make_stream_batch_step_fn, make_stream_step_fn,
                                warm_start_seed)
    from raft_tpu_torch import quantize_rows as rt_quantize_rows
    from raft_tpu_torch import _build
    from raft_tpu_torch.ops import corr_cuda, gru_cuda
    from raft_tpu_torch.models.capture import capture
    from raft_tpu_torch.models.raft import _gather_rows as gather_rows
    from raft_tpu_torch.models.raft import _update as raft_update
    from raft_tpu_torch.models.raft import (encode_pair, gru_step, prepare_loop,
                                            raft_forward, split_context,
                                            upsample_flow)
    from raft_tpu_torch.ops.conv import to_nchw
    from raft_tpu_torch.ops.coords import coords_grid
    from raft_tpu_torch.ops.corr import (build_pyramid, fmap2_pyramid, live_mask,
                                         lookup_blockwise_onehot,
                                         lookup_operands, lookup_packed_plain,
                                         lookup_ragged_plain,
                                         lookup_window_plain, mask_ragged_rows,
                                         packed_levels_from, ragged_pyramid)
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
               corr_cuda.corr_ragged_cuda, corr_cuda.corr_packed_cuda,
               gru_cuda.sep_conv_gru_cuda)

    def eager_fn(cfg, iters):
        """``fn(model, image1, image2[, sizes]) -> flow``, the eager forward
        the inference functions capture: ``raft_forward`` on the card, TF32
        off as in the whole process.  Launch counts and parity run on it."""
        def fn(mdl, im1, im2, sizes=None):
            t1, t2 = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in (im1, im2))
            sz = None if sizes is None else torch.as_tensor(sizes, device=dev)
            with torch.no_grad():
                return raft_forward(mdl, t1, t2, cfg, iters=iters, sizes=sz).flow
        return fn

    # -- 2. build ------------------------------------------------------
    secs = _build.build_all()
    print(f"build: {secs:.1f} s into {_build.build_dir()}")
    print(_build.compiler_report())

    # -- 3. kernels vs plain at the main paths' shapes --------------------
    rng = np.random.RandomState(0)
    h8, w8, C, L, r = H_IMG // 8, W_IMG // 8, 256, 4, 4

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    k_in = kernel_inputs(rng, dev, C, L, r)
    nn_ = (2 * r + 1) ** 2
    fmap1, levels, coords, wild = (k_in[k] for k in ("fmap1", "levels", "coords", "wild"))
    corr_k = corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r)
    corr_p = lookup_blockwise_onehot(fmap1, levels, coords, r)
    corr_err = _compare("corr_lookup [1,54,128,256] L=4 r=4", corr_k, corr_p)

    def three_ways(label, run, want_, nlev, sel=None):
        """``run(mma_ratio, stats)`` over ``nlev`` levels held to ``want_``
        (on ``sel`` only, when given) with its tiles sent by their window
        boxes, all on the MMA path and all on the gather; prints the tiles
        of each path."""
        worst_ = 0.0
        for how, ratio in (("by box", None), ("MMA", float("inf")), ("gather", 0.0)):
            st = torch.zeros(2 * nlev, dtype=torch.int32, device=dev)
            got_ = run(ratio, st)
            if sel is not None:
                got_, w_ = got_[sel], want_[sel]
            else:
                w_ = want_
            worst_ = max(worst_, _compare(
                f"{label}, tiles {how} (MMA/gather "
                f"{st.view(nlev, 2).sum(0).tolist()})", got_, w_))
        return worst_

    # the window-scheduled lookup (B3) runs the first lookup's kernel under
    # entries of its own: held three ways to its plain version (the TPU's
    # schedule), on noisy and on scattered windows, in both dtypes, and
    # bitwise equal to the first lookup's output on the same inputs
    win_err, win_bf_err = 0.0, 0.0
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16 " if dt == torch.bfloat16 else ""
        a_, l_ = fmap1.to(dt), [x.to(dt) for x in levels]
        for label, cc in (("noisy", coords), ("scattered", wild)):
            e = three_ways(
                f"corr_window {tag}[1,54,128,256] L=4 r=4, {label} coords",
                lambda ratio, st: corr_cuda.corr_window_cuda(
                    a_, l_, cc, r, mma_ratio=ratio, stats=st),
                lookup_window_plain(a_, l_, cc, r), L)
            if dt == torch.float32:
                win_err = max(win_err, e)
            else:
                win_bf_err = max(win_bf_err, e)
            same = torch.equal(corr_cuda.corr_window_cuda(a_, l_, cc, r),
                               corr_cuda.corr_lookup_cuda(a_, l_, cc, r))
            print(f"corr_window {tag}{label} coords: bitwise equal to "
                  f"corr_lookup's output on the same inputs: {same}")
            if not same:
                raise AssertionError("corr_window and corr_lookup differ")

    hb, wb = BOX[0] // 8, BOX[1] // 8
    sizes8, rf1, rlevels, rcoords, rwild = (
        k_in[k] for k in ("sizes8", "rf1", "rlevels", "rcoords", "rwild"))
    live8 = live_mask(sizes8, hb, wb)

    def ragged_held(label, f1_, lvs, cc, s8, live, rr=r):
        """The ragged lookup three ways on its live queries; its dead
        queries exact zeros every time."""
        def run(ratio, st):
            got_ = corr_cuda.corr_ragged_cuda(f1_, lvs, cc, s8, rr, mma_ratio=ratio,
                                              stats=st)
            if float(got_[~live].abs().max()) != 0.0:
                raise AssertionError(f"{label}: dead queries are not exact zeros")
            return got_
        return three_ways(f"{label}, live queries", run,
                          lookup_ragged_plain(f1_, lvs, cc, s8, rr), len(lvs), live)

    rag_err = max(ragged_held(
        f"corr_ragged [3,{hb},{wb},256] sizes8 {sizes8.tolist()}, {label} coords",
        rf1, rlevels, cc, sizes8, live8)
        for label, cc in (("noisy", rcoords), ("scattered", rwild)))
    print(f"corr_ragged dead queries: {int((~live8).sum())}, exact zeros in "
          f"every case above")

    # a fourth item so small (live [3, 5]) that levels 2 and 3 hold no live
    # row of it: they give exact zeros.  The kernel reads nothing outside an
    # item's crop: with NaN in every dead position of f1 and of each level,
    # its output stays bitwise the same (drawn from a seed of its own).
    rng7 = np.random.RandomState(7)
    s4 = torch.tensor(sizes8.tolist() + [[3, 5]], dtype=torch.int32, device=dev)
    live4 = live_mask(s4, hb, wb)
    f1_4 = mask_ragged_rows(dev_t(rng7.randn(4, hb, wb, C)), s4).contiguous()
    lv_4 = [lv.contiguous() for lv in
            ragged_pyramid(dev_t(rng7.randn(4, hb, wb, C)), s4, L)]
    noise4 = rng7.uniform(-(r + 3), r + 3, (4, hb, wb, 2))
    noise4[rng7.rand(4, hb, wb) < 0.125] += np.array([-300.0, 700.0])
    c4 = (coords_grid(4, hb, wb, device=dev) + dev_t(noise4)).contiguous()
    nan = float("nan")
    p1_4 = torch.where(live4[..., None], f1_4, nan).contiguous()
    plv_4 = [torch.where(live_mask(torch.div(s4, 2 ** i, rounding_mode="floor"),
                                   lv.shape[1], lv.shape[2])[..., None], lv,
                         nan).contiguous() for i, lv in enumerate(lv_4)]
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16 " if dt == torch.bfloat16 else ""
        a4, l4 = f1_4.to(dt), [x.to(dt) for x in lv_4]
        e = ragged_held(f"corr_ragged {tag}[4,{hb},{wb},256], a 4th item live [3, 5]",
                        a4, l4, c4, s4, live4)
        if dt == torch.float32:
            rag_err = max(rag_err, e)
        for ratio in (None, float("inf"), 0.0):
            clean = corr_cuda.corr_ragged_cuda(a4, l4, c4, s4, r, mma_ratio=ratio)
            poisoned = corr_cuda.corr_ragged_cuda(
                p1_4.to(dt), [x.to(dt) for x in plv_4], c4, s4, r, mma_ratio=ratio)
            torch.cuda.synchronize()
            coarse = float(clean[3, :, :, 2 * nn_:].abs().max())
            same = bool(torch.equal(clean, poisoned))
            print(f"corr_ragged {tag}4 items, mma_ratio {ratio}: item 3's levels "
                  f"2-3 max|out| {coarse}; NaN outside every crop changes "
                  f"nothing: {same}")
            if coarse != 0.0 or not same:
                raise AssertionError("corr_ragged read outside a live crop")

    gen = torch.Generator().manual_seed(0)
    cfg_k = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    model = init_raft_torch(cfg_k, generator=gen, device=dev)
    fw = gru_cuda.fuse_gru_weights(model.update_block.gru, 128, 128)
    kw = gru_cuda.prepare_gru_weights(fw, torch.float32)
    # the bfloat16 entry: bf16 copies of the bf16-rounded weights
    fw_bf = {k: v.bfloat16().float() for k, v in fw.items()}
    kw_bf = gru_cuda.prepare_gru_weights(fw_bf, torch.bfloat16)
    # cases added after the runs above draw from a seed of their own, so
    # that the frames below stay those of the runs before them
    rng6 = np.random.RandomState(6)

    # the GRU at the main path's grid, at 2x37x45 and at 2x23x70 (no tile
    # divides either); the bfloat16-I/O entry on the last two here, at the
    # main path's grid below
    gru_err, gru_bf_err = 0.0, 0.0
    for B, H, W in ((1, h8, w8), (2, 37, 45), (2, 23, 70)):
        h, mot, ctx = (k_in["gru"] if B == 1 else
                       gru_inputs(rng if H == 37 else rng6, dev, B, H, W))
        got = gru_cuda.sep_conv_gru_cuda(kw, h, mot, ctx)
        want = gru_cuda.sep_conv_gru_plain(fw, h, mot, ctx)
        gru_err = max(gru_err, _compare(f"sep_conv_gru [{B},{H},{W},128]", got, want))
        if B == 2:
            h_b, m_b, c_b = h.bfloat16(), mot.bfloat16(), tuple(c.bfloat16() for c in ctx)
            gru_bf_err = max(gru_bf_err, _compare_ulp(
                f"sep_conv_gru bf16 I/O [{B},{H},{W},128]",
                gru_cuda.sep_conv_gru_cuda(kw_bf, h_b, m_b, c_b),
                gru_cuda.sep_conv_gru_plain(fw_bf, h_b, m_b, c_b)))

    # the narrow-level (row-packed) lookup and the bfloat16 instantiations,
    # drawn from their own seed so that the frames below stay those of the
    # runs before them
    rng5 = np.random.RandomState(5)

    def noisy_coords5(B, H, W):
        noise = rng5.uniform(-(r + 3), r + 3, (B, H, W, 2))
        noise[rng5.rand(B, H, W) < 0.125] += np.array([-300.0, 700.0])
        return (coords_grid(B, H, W, device=dev) + dev_t(noise)).contiguous()

    first = packed_levels_from([lv.shape[2] for lv in levels])   # 1 at 54x128

    def packed_held(label, f1_, lvs, cc, ps, rr=r):
        return three_ways(label, lambda ratio, st: corr_cuda.corr_packed_cuda(
            f1_, lvs, cc, rr, ps, mma_ratio=ratio, stats=st),
            lookup_packed_plain(f1_, lvs, cc, rr, ps), len(lvs))

    pack_err = 0.0
    for ps in ("all", "window"):
        for label, cc in (("noisy", coords), ("scattered", wild)):
            pack_err = max(pack_err, packed_held(
                f"corr_packed {ps} [1,54,128,256] levels {first}-{L - 1} "
                f"narrow, {label} coords", fmap1, levels, cc, ps))
        _compare(f"corr_packed {ps} against corr_lookup's output",
                 corr_cuda.corr_packed_cuda(fmap1, levels, coords, r, ps), corr_k)
    hc, wc = 384 // 8, 512 // 8                  # FlyingChairs: W_0 = 64 packs
    cf1 = dev_t(rng5.randn(1, hc, wc, C))
    clevels = [lv.contiguous() for lv in fmap2_pyramid(dev_t(rng5.randn(1, hc, wc, C)), L)]
    ccoords = noisy_coords5(1, hc, wc)
    if packed_levels_from([lv.shape[2] for lv in clevels]) != 0:
        raise AssertionError("the FlyingChairs-width map should pack at level 0")
    for ps in ("all", "window"):
        pack_err = max(pack_err, packed_held(
            f"corr_packed {ps} [1,{hc},{wc},256] every level narrow", cf1,
            clevels, ccoords, ps))
        _compare(f"corr_packed {ps} [1,{hc},{wc},256] against corr_lookup's output",
                 corr_cuda.corr_packed_cuda(cf1, clevels, ccoords, r, ps),
                 corr_cuda.corr_lookup_cuda(cf1, clevels, ccoords, r))

    # a level pooled away to nothing (0x0) gives zeros and reads nothing
    zlevels = levels + [torch.empty((1, 0, 0, C), device=dev)]
    for ps in ("all", "window"):
        zmax = float(corr_cuda.corr_packed_cuda(fmap1, zlevels, coords, r, ps)
                     [..., L * nn_:].abs().max())
        print(f"corr_packed {ps}, a 0x0 fifth level: max|out| {zmax}")
        if zmax != 0.0:
            raise AssertionError("corr_packed: a 0x0 level is not exact zeros")

    # bfloat16 operands (corr_precision='default'): each lookup against its
    # plain version on the same bfloat16 operands
    bf1, blevels = fmap1.bfloat16(), [lv.bfloat16() for lv in levels]
    bf_err = {
        "corr_lookup": _compare(
            "corr_lookup bf16 [1,54,128,256]",
            corr_cuda.corr_lookup_cuda(bf1, blevels, coords, r),
            lookup_blockwise_onehot(bf1, blevels, coords, r)),
        "corr_window": win_bf_err,
        "corr_packed": max(
            packed_held(f"corr_packed {ps} bf16 [1,54,128,256], {label} coords",
                        bf1, blevels, cc, ps)
            for ps in ("all", "window") for label, cc in (("noisy", coords),
                                                          ("scattered", wild)))}
    rbf1, rblevels = rf1.bfloat16(), [lv.bfloat16() for lv in rlevels]
    bf_err["corr_ragged"] = max(ragged_held(
        f"corr_ragged bf16 [3,55,156,256], {label} coords", rbf1, rblevels, cc,
        sizes8, live8) for label, cc in (("noisy", rcoords), ("scattered", rwild)))
    # the GRU with bfloat16 I/O
    gh = dev_t(np.tanh(rng5.randn(1, h8, w8, 128))).bfloat16()
    gmot = dev_t(np.maximum(rng5.randn(1, h8, w8, 128), 0.0)).bfloat16()
    gctx = tuple(dev_t(0.5 * rng5.randn(1, h8, w8, 384)).bfloat16() for _ in range(2))
    bf_err["sep_conv_gru"] = max(gru_bf_err, _compare_ulp(
        "sep_conv_gru bf16 I/O [1,54,128,128]",
        gru_cuda.sep_conv_gru_cuda(kw_bf, gh, gmot, gctx),
        gru_cuda.sep_conv_gru_plain(fw_bf, gh, gmot, gctx)))

    # the first lookup beyond phase 3's coords, both entries, each case
    # held with the tiles as their boxes send them, all on the MMA path and
    # all on the gather: windows scattered over the map; a quarter of the
    # queries scattered among coherent ones; the left half of the grid
    # wholly outside the map; radius 15 (the gather only); C = 100 (not a
    # multiple of 16: the MMA path pads K with zeros; the bfloat16 entry,
    # C not a multiple of its 8-channel vectors, gathers by channel)
    def b1_held(label, f1_, lvs, cc, rr):
        return three_ways(f"corr_lookup {label}", lambda ratio, st:
                          corr_cuda.corr_lookup_cuda(f1_, lvs, cc, rr, mma_ratio=ratio,
                                                     stats=st),
                          lookup_blockwise_onehot(f1_, lvs, cc, rr), len(lvs))

    sel = torch.from_numpy(rng6.rand(1, h8, w8, 1) < 0.25).to(dev)
    mixed = torch.where(sel, wild, coords).contiguous()
    half_off = coords.clone()
    half_off[:, :, : w8 // 2] += 5000.0          # whole 8x8 tiles off the map
    f1_27, f2_27 = (dev_t(rng6.randn(1, 27, 64, 256)) for _ in range(2))
    cc_r15 = (coords_grid(1, 27, 64, device=dev)
              + dev_t(rng6.uniform(-18, 18, (1, 27, 64, 2)))).contiguous()
    f1_100, f2_100 = (dev_t(rng6.randn(1, 27, 64, 100)) for _ in range(2))
    cc_100 = (coords_grid(1, 27, 64, device=dev)
              + dev_t(rng6.uniform(-(r + 3), r + 3, (1, 27, 64, 2)))).contiguous()
    b1_cases = (
        ("[1,54,128,256] noisy", fmap1, levels, coords, r),
        ("[1,54,128,256] scattered", fmap1, levels, wild, r),
        ("[1,54,128,256] a quarter scattered", fmap1, levels, mixed, r),
        ("[1,54,128,256] left half off the map", fmap1, levels, half_off, r),
        ("[1,27,64,256] L=2 r=15", f1_27, fmap2_pyramid(f2_27, 2), cc_r15, 15),
        ("[1,27,64,100] L=4 r=4", f1_100, fmap2_pyramid(f2_100, L), cc_100, r))
    for dt in (torch.float32, torch.bfloat16):
        for label, f1_, lvs, cc, rr in b1_cases:
            e = b1_held(("bf16 " if dt == torch.bfloat16 else "") + label, f1_.to(dt),
                        [x.to(dt).contiguous() for x in lvs], cc, rr)
            if dt == torch.float32:
                corr_err = max(corr_err, e)
            else:
                bf_err["corr_lookup"] = max(bf_err["corr_lookup"], e)

    # -- 4. main path: a few requests ------------------------------------
    def frame_pair(H, W, i):
        im1 = rng.rand(1, H, W, 3).astype(np.float32)
        im2 = np.roll(im1, (i + 1, 2 * i + 3), axis=(1, 2))
        im2 = np.clip(im2 + 0.02 * rng.randn(*im2.shape), 0, 1).astype(np.float32)
        return im1, im2

    pairs = [frame_pair(H_IMG, W_IMG, i) for i in range(N_PAIRS)]
    run_k = eager_fn(cfg_k, ITERS)
    cfg_p = RAFTConfig.full(corr_impl="blockwise", corr_lookup="onehot",
                            gru_impl="xla")
    run_p = eager_fn(cfg_p, ITERS)

    _reset(*kernels)
    flows_k = [run_k(model, a, b) for a, b in pairs]
    torch.cuda.synchronize()
    launches = _launches(*kernels)
    print(f"main path: {N_PAIRS} requests at {H_IMG}x{W_IMG}, {ITERS} iters; "
          f"launches {launches}")
    for f in flows_k:
        if tuple(f.shape) != (1, H_IMG, W_IMG, 2) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"bad flow: shape {tuple(f.shape)}, finite "
                                 f"{bool(torch.isfinite(f).all())}")
    want = {"corr_lookup": N_PAIRS * ITERS, "corr_window": 0, "corr_ragged": 0,
            "corr_packed": 0,
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
    def step_parity(cfg_k, cfg_p, t1, t2, sizes=None, crops=None, mdl=model):
        """Worst (ratio, message) over the iterations, each kernel step and
        plain step taken from the same state, from the encoders' features
        of the frames."""
        sizes8 = None
        if sizes is not None:
            t1, t2 = mask_ragged_rows(t1, sizes), mask_ragged_rows(t2, sizes)
            sizes8 = sizes // 8
        fm1, fm2, net, inp = encode_pair(mdl, t1, t2, cfg_k)
        return core_parity(cfg_k, cfg_p, (fm1, fm2, inp), net, None, sizes8,
                           crops, mdl)

    def core_parity(cfg_k, cfg_p, feats, net, init=None, sizes8=None,
                    crops=None, mdl=model):
        """As step_parity, from the features ``feats`` = (fmap1, fmap2, inp)
        NCHW, ``net`` and the seed ``init`` (None: zero flow): the
        streaming entries' and a slot pool's rows."""
        loop_k = prepare_loop(mdl, *feats, cfg_k, sizes8)
        loop_p = prepare_loop(mdl, *feats, cfg_p, sizes8)
        c0, worst = loop_k.coords0, (0.0, "")
        coords1 = c0 if init is None else c0 + init.float()
        for it in range(ITERS):
            net_k, ck, mk = gru_step(mdl, cfg_k, loop_k, net, coords1)
            _, cp, mp = gru_step(mdl, cfg_p, loop_p, net, coords1)
            worst = max(worst, _within(
                f"iteration {it}", upsample_flow(cfg_k, ck - c0, mk),
                upsample_flow(cfg_p, cp - c0, mp), crops))
            net, coords1 = net_k, ck
        return worst

    with torch.no_grad():
        for i, (a, b) in enumerate(pairs):
            t1 = torch.from_numpy(a).to(dev)
            t2 = torch.from_numpy(b).to(dev)
            worst = step_parity(cfg_k, cfg_p, t1, t2)
            e2e = _within("3 iterations end to end",
                          eager_fn(cfg_k, 3)(model, a, b),
                          eager_fn(cfg_p, 3)(model, a, b))
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
    run_w = eager_fn(cfg_w, ITERS)
    _reset(*kernels)
    flows_w = [run_w(model, a, b) for a, b in pairs[:N_WINDOW]]
    torch.cuda.synchronize()
    launches_w = _launches(*kernels)
    print(f"window path: {N_WINDOW} requests at {H_IMG}x{W_IMG}, {ITERS} "
          f"iters; launches {launches_w}")
    want = {"corr_lookup": 0, "corr_window": N_WINDOW * ITERS, "corr_ragged": 0,
            "corr_packed": 0,
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
                          eager_fn(cfg_w, 3)(model, a, b),
                          eager_fn(cfg_p, 3)(model, a, b))
            print(f"window pair {i}: every iteration, worst {worst[1]}; {e2e[1]}")
            if worst[0] > 1.0 or e2e[0] > 1.0:
                raise AssertionError(f"window pair {i}: kernel path disagrees "
                                     f"with the plain path")

    # -- 6. ragged path: Sintel, KITTI and Chairs frames in one batch -----
    crops = [frame_pair(h, w, 5 + i) for i, (h, w) in enumerate(CROPS)]
    rim1 = np.concatenate([embed_to_shape(c[0], BOX) for c in crops])
    rim2 = np.concatenate([embed_to_shape(c[1], BOX) for c in crops])
    sizes = np.array(CROPS, np.int32)
    run_r = eager_fn(cfg_k, ITERS)
    _reset(*kernels)
    flow_r = run_r(model, rim1, rim2, sizes)
    torch.cuda.synchronize()
    launches_r = _launches(*kernels)
    print(f"ragged path: batch of 3 in a {BOX[0]}x{BOX[1]} box, live "
          f"{[list(c) for c in CROPS]}, {ITERS} iters; launches {launches_r}")
    want = {"corr_lookup": 0, "corr_window": 0, "corr_ragged": ITERS,
            "corr_packed": 0,
            "sep_conv_gru": ITERS * gru_cuda.LAUNCHES_PER_CALL}
    if launches_r != want:
        raise AssertionError(f"ragged path launch counts {launches_r} != {want}")
    for b, (h, w) in enumerate(CROPS):
        if not bool(torch.isfinite(flow_r[b, :h, :w]).all()):
            raise AssertionError(f"ragged item {b}: non-finite flow on its crop")
    ragged_k = eager_fn(cfg_k, 3)
    with torch.no_grad():
        sz = torch.from_numpy(sizes).to(dev)
        worst = step_parity(cfg_k, cfg_p, torch.from_numpy(rim1).to(dev),
                            torch.from_numpy(rim2).to(dev), sz, CROPS)
        mixed = ragged_k(model, rim1, rim2, sizes)
        e2e = _within("3 iterations end to end", mixed,
                      eager_fn(cfg_p, 3)(model, rim1, rim2, sizes), CROPS)
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
        clean = run_r(model, rim1, rim2, sizes)
        dirty = run_r(model, junk1, junk2, sizes)
        torch.backends.cudnn.deterministic = False
        same = [bool(torch.equal(clean[b, :h, :w], dirty[b, :h, :w]))
                for b, (h, w) in enumerate(CROPS)]
        print(f"ragged batch with random pixels in the dead region: live crops "
              f"bitwise equal {same}")
        if not all(same):
            raise AssertionError("dead-region pixels changed a live crop's flow")

    # -- 6b. P32 path: pallas_pack=True under 'all' and 'window' -----------
    def drive(label, infer, mdl, reqs, want):
        """Run ``infer`` on each request with every count reset just
        before; check the launch counts (``want``, others 0) and that every
        flow is finite on its crop; returns the counts."""
        _reset(*kernels)
        outs = [infer(mdl, *req) for req in reqs]
        torch.cuda.synchronize()
        got = _launches(*kernels)
        print(f"{label}: launches {got}")
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise AssertionError(f"{label}: launch counts {got} != {full}")
        for o, req in zip(outs, reqs):
            crops_ = ([tuple(o.shape[1:3])] * o.shape[0] if len(req) == 2
                      else [tuple(x) for x in req[2]])
            for b, (h, w) in enumerate(crops_):
                if not bool(torch.isfinite(o[b, :h, :w]).all()):
                    raise AssertionError(f"{label}: non-finite flow")
        return got

    gru_per_iter = gru_cuda.LAUNCHES_PER_CALL
    n_it = N_WINDOW * ITERS
    launches_p32, run_p32 = {}, {}
    for ps in ("all", "window"):
        cfg_pk = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                                 pallas_pack=True, pallas_p_select=ps)
        run_p32[ps] = eager_fn(cfg_pk, ITERS)
        launches_p32[ps] = drive(
            f"P32 path, p_select={ps!r}: {N_WINDOW} requests at "
            f"{H_IMG}x{W_IMG}, {ITERS} iters", run_p32[ps], model,
            pairs[:N_WINDOW], {"corr_packed": n_it,
                               "sep_conv_gru": n_it * gru_per_iter})
        with torch.no_grad():
            for i, (a, b) in enumerate(pairs[:N_WINDOW]):
                worst = step_parity(cfg_pk, cfg_p, torch.from_numpy(a).to(dev),
                                    torch.from_numpy(b).to(dev))
                e2e = _within("3 iterations end to end",
                              eager_fn(cfg_pk, 3)(model, a, b),
                              eager_fn(cfg_p, 3)(model, a, b))
                print(f"P32 {ps} pair {i}: every iteration, worst {worst[1]}; {e2e[1]}")
                if worst[0] > 1.0 or e2e[0] > 1.0:
                    raise AssertionError(f"P32 {ps} pair {i}: kernel path "
                                         f"disagrees with the plain path")

    # -- 6c. BF path: bfloat16 compute, 'default' corr, pack + window ------
    cfg_bf = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                             compute_dtype="bfloat16", corr_precision="default",
                             pallas_pack=True, pallas_p_select="window",
                             pallas_p_blk=1024)
    # the same seeded weights as `model`, rounded to bfloat16 once
    model_bf = init_raft_torch(cfg_bf, generator=torch.Generator().manual_seed(0),
                               device=dev)
    run_bf = eager_fn(cfg_bf, ITERS)
    launches_bf = drive(
        f"BF path: {N_WINDOW} requests at {H_IMG}x{W_IMG}, {ITERS} iters",
        run_bf, model_bf, pairs[:N_WINDOW],
        {"corr_packed": n_it, "sep_conv_gru": n_it * gru_per_iter})
    cfg_bfc = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              compute_dtype="bfloat16", corr_precision="default")
    run_bfc = eager_fn(cfg_bfc, ITERS)
    launches_bfc = drive(
        f"pallas-bf16corr-ctx-gru: 1 request at {H_IMG}x{W_IMG}, {ITERS} iters",
        run_bfc, model_bf, pairs[:1],
        {"corr_lookup": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    cfg_bfw = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              compute_dtype="bfloat16", corr_precision="default",
                              pallas_p_select="window", pallas_p_blk=1024)
    run_bfw = eager_fn(cfg_bfw, ITERS)
    launches_bfw = drive(
        f"pallas-bf16corr-ctx-gru-win: 1 request at {H_IMG}x{W_IMG}, {ITERS} iters",
        run_bfw, model_bf, pairs[:1],
        {"corr_window": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    cfg_pb = RAFTConfig.full(corr_impl="blockwise", corr_lookup="onehot",
                             gru_impl="xla", compute_dtype="bfloat16",
                             corr_precision="default")

    def bf16_step_parity(cfg_k, t1, t2, sizes=None, crops=None,
                         mdl_bf=model_bf, mdl=model, cfg_b=cfg_pb, cfg_f=cfg_p):
        """Worst (ratio, message) over the iterations of |kernel step -
        plain bf16 step| / |plain bf16 step - plain float32 step|, all three
        steps taken from the kernel path's state (the float32 step on the
        float32 model ``mdl``, the features and the state upcast), on each
        crop."""
        sizes8 = None
        if sizes is not None:
            t1, t2 = mask_ragged_rows(t1, sizes), mask_ragged_rows(t2, sizes)
            sizes8 = sizes // 8
        fm1, fm2, net, inp = encode_pair(mdl_bf, t1, t2, cfg_k)
        return bf16_core_parity(cfg_k, (fm1, fm2, inp), net, None, sizes8,
                                crops, mdl_bf, mdl, cfg_b, cfg_f)

    def bf16_core_parity(cfg_k, feats, net, init=None, sizes8=None,
                         crops=None, mdl_bf=model_bf, mdl=model, cfg_b=cfg_pb,
                         cfg_f=cfg_p):
        """As bf16_step_parity, from the bfloat16 features ``feats`` =
        (fmap1, fmap2, inp) NCHW, ``net`` and the seed ``init``."""
        loop_k = prepare_loop(mdl_bf, *feats, cfg_k, sizes8)
        loop_b = prepare_loop(mdl_bf, *feats, cfg_b, sizes8)
        loop_f = prepare_loop(mdl, *(x.float() for x in feats), cfg_f, sizes8)
        c0, worst = loop_k.coords0, (0.0, "")
        coords1 = c0 if init is None else c0 + init.float()
        B, h8, w8, _ = c0.shape
        crops = crops or [(8 * h8, 8 * w8)] * B
        for it in range(ITERS):
            net_k, ck, mk = gru_step(mdl_bf, cfg_k, loop_k, net, coords1)
            _, cb, mb = gru_step(mdl_bf, cfg_b, loop_b, net, coords1)
            _, cf, mf = gru_step(mdl, cfg_f, loop_f, net.float(), coords1)
            fk, fb, ff = (upsample_flow(cfg_k, c - c0, m) for c, m in
                          ((ck, mk), (cb, mb), (cf, mf)))
            for b, (h, w) in enumerate(crops):
                dk = float((fk[b, :h, :w] - fb[b, :h, :w]).abs().max())
                env = float((fb[b, :h, :w] - ff[b, :h, :w]).abs().max())
                ratio = dk / max(env, 1e-30)
                if ratio > worst[0] or not worst[1]:
                    worst = (ratio, f"iteration {it} item {b}: kernel vs "
                             f"plain bf16 {dk:.3e}, plain bf16 vs plain f32 "
                             f"{env:.3e}")
            net, coords1 = net_k, ck
        return worst

    with torch.no_grad():
        for i, (a, b) in enumerate(pairs[:N_WINDOW]):
            worst = bf16_step_parity(cfg_bf, torch.from_numpy(a).to(dev),
                                     torch.from_numpy(b).to(dev))
            print(f"BF pair {i}: per-iteration steps, worst {worst[1]} "
                  f"(ratio {worst[0]:.3f})")
            if not worst[0] <= 1.0:
                raise AssertionError(f"BF pair {i}: the kernel step departs "
                                     f"from the plain bf16 step further than "
                                     f"bf16 does from float32")
    cfg_rbf = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              compute_dtype="bfloat16", corr_precision="default")
    run_rbf = eager_fn(cfg_rbf, ITERS)
    launches_rbf = drive(
        f"BF ragged batch of 3 in {BOX[0]}x{BOX[1]}, {ITERS} iters",
        run_rbf, model_bf, [(rim1, rim2, sizes)],
        {"corr_ragged": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    with torch.no_grad():
        worst = bf16_step_parity(cfg_rbf, torch.from_numpy(rim1).to(dev),
                                 torch.from_numpy(rim2).to(dev),
                                 torch.from_numpy(sizes).to(dev), CROPS)
    print(f"BF ragged batch, each live crop: per-iteration steps, worst "
          f"{worst[1]} (ratio {worst[0]:.3f})")
    if not worst[0] <= 1.0:
        raise AssertionError("BF ragged batch: the kernel step departs from "
                             "the plain bf16 step further than bf16 does "
                             "from float32")

    # -- 6d. non-zero biases and batch-norm affines -------------------------
    # the seeded weights of `model` with every conv bias and batch-norm beta
    # drawn from U(-0.25, 0.25), every gamma from U(0.75, 1.25) and the
    # running statistics away from identity, with numpy from a seed of their
    # own: the f32 main path and BF, each step held as in phases 4 and 6c
    model_c1 = init_raft_torch(cfg_k, generator=torch.Generator().manual_seed(0),
                               device=dev)
    rng_c1 = np.random.RandomState(1000)
    with torch.no_grad():
        for name, t in model_c1.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if "norm" in name or "downsample.1" in name:
                lo, hi = {"weight": (0.75, 1.25), "bias": (-0.25, 0.25),
                          "running_mean": (-0.05, 0.05),
                          "running_var": (0.9, 1.1)}[leaf]
            elif leaf == "bias":
                lo, hi = -0.25, 0.25
            else:
                continue
            t.copy_(dev_t(rng_c1.uniform(lo, hi, tuple(t.shape))))
    model_c1_bf = init_raft_torch(cfg_bf, device=dev)
    model_c1_bf.load_state_dict(model_c1.state_dict())
    drive("C1 weights, main path: 1 request", run_k, model_c1, pairs[:1],
          {"corr_lookup": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    drive("C1 weights, BF: 1 request", run_bf, model_c1_bf, pairs[:1],
          {"corr_packed": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    with torch.no_grad():
        t1, t2 = (torch.from_numpy(x).to(dev) for x in pairs[0])
        worst = step_parity(cfg_k, cfg_p, t1, t2, mdl=model_c1)
        worst_bf = bf16_step_parity(cfg_bf, t1, t2, mdl_bf=model_c1_bf,
                                    mdl=model_c1)
    print(f"C1 weights, main path pair 0: every iteration, worst {worst[1]}; "
          f"BF pair 0: per-iteration steps, worst {worst_bf[1]} (ratio "
          f"{worst_bf[0]:.3f})")
    if worst[0] > 1.0 or not worst_bf[0] <= 1.0:
        raise AssertionError("C1 weights: a kernel path disagrees with its "
                             "plain path")

    # -- 6e. TF32 under PyTorch's defaults ------------------------------------
    # the float32 entry points turn TF32 off themselves: under PyTorch's
    # default switches (cuDNN TF32 on) a 3-iteration request gives the flow
    # of the same request with TF32 off in the whole process, and the
    # caller's switches are as they were after it; not held, printed: the
    # same forward through raft_forward with cuDNN TF32 on
    # (a factory of its own, whose graph is captured under those switches)
    cudnn_, matmul_ = torch.backends.cudnn, torch.backends.cuda.matmul
    a, b = pairs[0]
    off = eager_fn(cfg_k, 3)(model, a, b)
    cudnn_.allow_tf32, matmul_.allow_tf32 = True, False     # PyTorch's defaults
    dflt = make_inference_fn(cfg_k, iters=3)(model, a, b)
    flags_after = (cudnn_.allow_tf32, matmul_.allow_tf32)
    with torch.no_grad():
        tf32 = raft_forward(model, torch.from_numpy(a).to(dev),
                            torch.from_numpy(b).to(dev), cfg_k, iters=3).flow
    cudnn_.allow_tf32 = matmul_.allow_tf32 = False
    held = _within("3 iterations under the default switches vs TF32 off",
                   dflt, off)
    print(f"C2: {held[1]} (bitwise equal {torch.equal(dflt, off)}); the "
          f"switches after the call {flags_after} (set (True, False)); not "
          f"held: {_within('the same forward with cuDNN TF32 on', tf32, off)[1]}")
    if held[0] > 1.0 or flags_after != (True, False):
        raise AssertionError("C2: the float32 entry point ran with TF32 or "
                             "did not restore the caller's switches")

    # -- 6f. the inference functions as captured CUDA graphs ---------------
    # each path through its factory (captured at the first call, replayed
    # after it) beside the eager raft_forward of the same requests: the
    # replay equals eager bitwise (else within phase 4's bound, the reason
    # printed); a capture counts its eager warm-up's launches and the
    # captured forward's, a replay none
    def held_replay(label, got, want, crops=None):
        torch.cuda.synchronize()
        if torch.equal(got, want):
            print(f"{label}: replay bitwise equal to eager")
            return
        ratio, msg = _within(label, got, want, crops)
        print(f"{label}: replay NOT bitwise equal to eager; {msg} (ratio "
              f"{ratio:.3g}); reason: the graph's kernels differ from the "
              f"eager run's (a cuDNN engine chosen anew, or a sum of "
              f"another order)")
        if ratio > 1.0:
            raise AssertionError(f"{label}: replay disagrees with eager")

    def captured_drive(label, fn, run, mdl, reqs, crops=None):
        """Every request of ``reqs`` through the factory ``fn`` (one
        capture, then replays) and through ``run`` (eager): counts, one
        graph, each replay held to eager; the graph pool's size, as the
        device memory reserved after the capture less before it (the
        allocator's free cache emptied on both sides).  Returns the
        eager flows."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        _reset(*kernels)
        first = fn(mdl, *reqs[0])
        torch.cuda.synchronize()
        at_capture = _launches(*kernels)
        torch.cuda.empty_cache()
        pool_mib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 20
        outs = [first] + [fn(mdl, *req) for req in reqs[1:]]
        torch.cuda.synchronize()
        replays = {k: v - at_capture[k] for k, v in _launches(*kernels).items()}
        _reset(*kernels)
        want = [run(mdl, *req) for req in reqs]
        torch.cuda.synchronize()
        eager1 = {k: v // len(reqs) for k, v in _launches(*kernels).items()}
        print(f"{label}: {len(reqs)} requests, graphs {fn.graphs.graph_count()}, "
              f"captures {fn.graphs.captures}; launches at the capture "
              f"{at_capture} (an eager request: {eager1}), at the replays "
              f"{replays}; graph pool {pool_mib:.0f} MiB reserved")
        if (fn.graphs.captures != 1 or fn.graphs.graph_count() != 1
                or at_capture != {k: 2 * v for k, v in eager1.items()}
                or any(replays.values())):
            raise AssertionError(f"{label}: not one capture of the eager "
                                 f"path's launches")
        # every output is the caller's own: the later replays left the
        # earlier results as they were
        for i, (o, w) in enumerate(zip(outs, want)):
            held_replay(f"{label}, request {i}", o, w, crops)
        return want, pool_mib

    infer_k = make_inference_fn(cfg_k, iters=ITERS)
    infer_bf = make_inference_fn(cfg_bf, iters=ITERS)
    infer_bfc = make_inference_fn(cfg_bfc, iters=ITERS)
    infer_r = make_ragged_inference_fn(cfg_k, iters=ITERS)
    infer_rbf = make_ragged_inference_fn(cfg_rbf, iters=ITERS)
    pool_mib = {}
    for label, fn, run, mdl, reqs, crops_ in (
            ("captured f32 main", infer_k, run_k, model, pairs[:2], None),
            ("captured BF", infer_bf, run_bf, model_bf, pairs[:2], None),
            ("captured pallas-bf16corr-ctx-gru", infer_bfc, run_bfc, model_bf,
             pairs[:2], None),
            ("captured ragged f32", infer_r, run_r, model,
             [(rim1, rim2, sizes)], CROPS),
            ("captured ragged bf16", infer_rbf, run_rbf, model_bf,
             [(rim1, rim2, sizes)], CROPS)):
        pool_mib[label.split(" ", 1)[1]] = captured_drive(
            label, fn, run, mdl, reqs, crops_)[1]

    # a second key captures a second graph, and the first still replays
    # right: a FlyingChairs-size pair (384x512) beside 432x1024; the ragged
    # box at batch 2 beside batch 3
    a, b = pairs[0]
    small_pair = (a[:, :384, :512].copy(), b[:, :384, :512].copy())
    held_replay("captured f32 main, a 384x512 pair (second graph)",
                infer_k(model, *small_pair), run_k(model, *small_pair))
    held_replay("captured f32 main, 432x1024 again after it",
                infer_k(model, a, b), run_k(model, a, b))
    held_replay("captured ragged f32, batch of 2 in the box (second graph)",
                infer_r(model, rim1[:2], rim2[:2], sizes[:2]),
                run_r(model, rim1[:2], rim2[:2], sizes[:2]), CROPS[:2])
    held_replay("captured ragged f32, batch of 3 again after it",
                infer_r(model, rim1, rim2, sizes), run_r(model, rim1, rim2, sizes),
                CROPS)
    # other crops in the same box: sizes are an input, no new capture
    crops2 = ((400, 1000), (320, 1248), (440, 640))
    sizes2 = np.array(crops2, np.int32)
    held_replay(f"captured ragged f32, new sizes {[list(c) for c in crops2]}",
                infer_r(model, rim1, rim2, sizes2), run_r(model, rim1, rim2, sizes2),
                crops2)
    graphs_k, graphs_r = infer_k.graphs, infer_r.graphs
    print(f"captured f32 main: graphs {graphs_k.graph_count()}, captures "
          f"{graphs_k.captures}; captured ragged: graphs {graphs_r.graph_count()}, "
          f"captures {graphs_r.captures} (new sizes captured nothing)")
    if (graphs_k.captures, graphs_r.captures) != (2, 2):
        raise AssertionError("a second key did not capture once, or new sizes "
                             "captured")
    # weights: an in-place load is seen by the next replay; a parameter's
    # storage moved makes the next call capture anew
    model_w = init_raft_torch(cfg_k, generator=torch.Generator().manual_seed(0),
                              device=dev)
    infer_wt = make_inference_fn(cfg_k, iters=ITERS)
    before = infer_wt(model_w, a, b)
    model_w.load_state_dict(model_c1.state_dict())
    held_replay("captured f32 main after an in-place load of the C1 weights",
                infer_wt(model_w, a, b), run_k(model_c1, a, b))
    held_replay("  the result taken before the load, unchanged", before,
                flows_k[0])
    captures_in_place = infer_wt.graphs.captures
    # every storage moved (the old ones held, so no address is reused)
    old_storage = [t.data for t in model_w.state_dict().values()]
    model_w.cpu()
    model_w.to(dev)
    held_replay("captured f32 main after the model moved (storages changed)",
                infer_wt(model_w, a, b), run_k(model_c1, a, b))
    print(f"weights: captures after the in-place load {captures_in_place} "
          f"(1 wanted), after the move {infer_wt.graphs.captures} (2 wanted)")
    if (captures_in_place, infer_wt.graphs.captures) != (1, 2):
        raise AssertionError("the weight rule of the capture does not hold")
    del model_w, infer_wt, old_storage

    # -- 6g. raft-small: RAFTConfig.small_model(corr_impl='pallas') --------
    # B1 at the small shape (r = 3, C = 128) held to its plain version, both
    # entries, its tiles by box, all on the MMA path, all on the gather
    rng8 = np.random.RandomState(8)
    rs, cs = 3, 128
    s_f1 = dev_t(rng8.randn(1, h8, w8, cs))
    s_levels = [lv.contiguous() for lv in fmap2_pyramid(dev_t(rng8.randn(1, h8, w8, cs)), L)]
    s_noise = rng8.uniform(-(rs + 3), rs + 3, (1, h8, w8, 2))
    s_noise[rng8.rand(1, h8, w8) < 0.125] += np.array([-300.0, 700.0])
    s_coords = (coords_grid(1, h8, w8, device=dev) + dev_t(s_noise)).contiguous()
    s_wild = (coords_grid(1, h8, w8, device=dev) + dev_t(rng8.uniform(
        -w8, w8, (1, h8, w8, 2)))).contiguous()
    small_b1 = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16 " if dt == torch.bfloat16 else ""
        a_, l_ = s_f1.to(dt), [x.to(dt) for x in s_levels]
        err_ = max(b1_held(f"{tag}[1,54,128,128] L=4 r=3 (raft-small), {label}",
                           a_, l_, cc, rs)
                   for label, cc in (("noisy", s_coords), ("scattered", s_wild)))
        ms_ = _time_ms(lambda: corr_cuda.corr_lookup_cuda(a_, l_, s_coords, rs), 3, 50)
        plain_ms_ = _time_ms(lambda: lookup_blockwise_onehot(a_, l_, s_coords, rs), 1, 5)
        bound_ = _corr_bound(a_, l_, s_coords, rs)
        small_b1[dt] = (err_, ms_, plain_ms_) + bound_
        print(f"corr_lookup {tag}at raft-small's shape [1,54,128,128] L=4 r=3: "
              f"{ms_:.4f} ms/call (plain {plain_ms_:.4f}), bound {bound_[0]:.4f} "
              f"ms by {bound_[1]}, max_abs_err {err_:.3e}")
    corr_err = max(corr_err, small_b1[torch.float32][0])
    bf_err["corr_lookup"] = max(bf_err["corr_lookup"], small_b1[torch.bfloat16][0])
    # B3, B4 and B5 at the small shape likewise, both entries: the window
    # and the packed lookups ('all' and 'window') on the maps above, the
    # ragged lookup on phase 3's box at C = 128 (live queries held, dead
    # ones exact zeros)
    s_rf1 = mask_ragged_rows(dev_t(rng8.randn(3, hb, wb, cs)), sizes8).contiguous()
    s_rlevels = [lv.contiguous() for lv in ragged_pyramid(
        dev_t(rng8.randn(3, hb, wb, cs)), sizes8, L)]
    for dt in (torch.float32, torch.bfloat16):
        tag = "bf16 " if dt == torch.bfloat16 else ""
        a_, l_ = s_f1.to(dt), [x.to(dt) for x in s_levels]
        ra_, rl_ = s_rf1.to(dt), [x.to(dt) for x in s_rlevels]
        errs = {"corr_window": 0.0, "corr_packed": 0.0, "corr_ragged": 0.0}
        for label, cc in (("noisy", s_coords), ("scattered", s_wild)):
            shape = f"{tag}[1,54,128,128] L=4 r=3 (raft-small), {label} coords"
            errs["corr_window"] = max(errs["corr_window"], three_ways(
                f"corr_window {shape}", lambda ratio, st, cc=cc:
                corr_cuda.corr_window_cuda(a_, l_, cc, rs, mma_ratio=ratio, stats=st),
                lookup_window_plain(a_, l_, cc, rs), L))
            for ps in ("all", "window"):
                errs["corr_packed"] = max(errs["corr_packed"], packed_held(
                    f"corr_packed {ps} {shape}", a_, l_, cc, ps, rs))
        for label, cc in (("noisy", rcoords), ("scattered", rwild)):
            errs["corr_ragged"] = max(errs["corr_ragged"], ragged_held(
                f"corr_ragged {tag}[3,{hb},{wb},128] r=3 (raft-small) sizes8 "
                f"{sizes8.tolist()}, {label} coords", ra_, rl_, cc, sizes8,
                live8, rs))
        print(f"raft-small shape, {tag or 'f32 '}window / packed / ragged "
              f"lookups: max_abs_err {errs}")
        if dt == torch.float32:
            win_err = max(win_err, errs["corr_window"])
            pack_err = max(pack_err, errs["corr_packed"])
            rag_err = max(rag_err, errs["corr_ragged"])
        else:
            for k, e in errs.items():
                bf_err[k] = max(bf_err[k], e)

    cfg_s = RAFTConfig.small_model(corr_impl="pallas")
    cfg_sp = RAFTConfig.small_model(corr_impl="blockwise")
    cfg_sb = RAFTConfig.small_model(corr_impl="pallas", compute_dtype="bfloat16",
                                    corr_precision="default")
    cfg_sbp = RAFTConfig.small_model(corr_impl="blockwise", compute_dtype="bfloat16",
                                     corr_precision="default")
    model_s = init_raft_torch(cfg_s, generator=torch.Generator().manual_seed(0),
                              device=dev)
    model_sb = init_raft_torch(cfg_sb, generator=torch.Generator().manual_seed(0),
                               device=dev)
    run_s, run_sb = eager_fn(cfg_s, ITERS), eager_fn(cfg_sb, ITERS)
    n_it = N_WINDOW * ITERS
    launches_s = drive(f"raft-small f32: {N_WINDOW} requests at {H_IMG}x{W_IMG}, "
                       f"{ITERS} iters", run_s, model_s, pairs[:N_WINDOW],
                       {"corr_lookup": n_it})
    launches_sb = drive(f"raft-small bf16 ('default' corr): {N_WINDOW} requests",
                        run_sb, model_sb, pairs[:N_WINDOW], {"corr_lookup": n_it})
    with torch.no_grad():
        for i, (a, b) in enumerate(pairs[:N_WINDOW]):
            t1, t2 = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
            worst = step_parity(cfg_s, cfg_sp, t1, t2, mdl=model_s)
            e2e = _within("3 iterations end to end", eager_fn(cfg_s, 3)(model_s, a, b),
                          eager_fn(cfg_sp, 3)(model_s, a, b))
            worst_bf = bf16_step_parity(cfg_sb, t1, t2, mdl_bf=model_sb,
                                        mdl=model_s, cfg_b=cfg_sbp, cfg_f=cfg_sp)
            print(f"raft-small pair {i}: f32 every iteration, worst {worst[1]}; "
                  f"{e2e[1]}; bf16 per-iteration steps, worst {worst_bf[1]} "
                  f"(ratio {worst_bf[0]:.3f})")
            if worst[0] > 1.0 or e2e[0] > 1.0 or not worst_bf[0] <= 1.0:
                raise AssertionError(f"raft-small pair {i}: the kernel path "
                                     f"disagrees with the plain path")
    infer_s = make_inference_fn(cfg_s, iters=ITERS)
    infer_sb = make_inference_fn(cfg_sb, iters=ITERS)
    for label, fn, run, mdl in (("raft-small f32", infer_s, run_s, model_s),
                                ("raft-small bf16", infer_sb, run_sb, model_sb)):
        held_replay(f"captured {label}", fn(mdl, *pairs[0]), run(mdl, *pairs[0]))
    # the small model on the window, packed and ragged lookups: one request
    # each (the ragged batch of phase 6), its kernel once per iteration and
    # no other, per iteration held to small_model(corr_impl='blockwise') as
    # in phase 4
    for label, cfg_x, reqs, kernel, crops_x in (
            ("window", RAFTConfig.small_model(corr_impl="pallas",
                                              pallas_p_select="window"),
             pairs[:1], "corr_window", None),
            ("packed", RAFTConfig.small_model(corr_impl="pallas", pallas_pack=True),
             pairs[:1], "corr_packed", None),
            ("ragged", cfg_s, [(rim1, rim2, sizes)], "corr_ragged", CROPS)):
        drive(f"raft-small f32 {label}: 1 request, {ITERS} iters",
              eager_fn(cfg_x, ITERS), model_s, reqs, {kernel: ITERS})
        req = reqs[0]
        with torch.no_grad():
            worst = step_parity(
                cfg_x, cfg_sp, torch.from_numpy(req[0]).to(dev),
                torch.from_numpy(req[1]).to(dev),
                None if crops_x is None else torch.from_numpy(req[2]).to(dev),
                crops_x, mdl=model_s)
        print(f"raft-small {label}: every iteration, worst {worst[1]}")
        if worst[0] > 1.0:
            raise AssertionError(f"raft-small {label}: the kernel path "
                                 f"disagrees with the plain path")

    # -- 6h. corr_impl='dense': RAFTConfig.full() and small_model() as they
    # stand, held per iteration to corr_impl='pallas' on the same weights
    cfg_d, cfg_ds = RAFTConfig.full(), RAFTConfig.small_model()
    run_d, run_ds = eager_fn(cfg_d, ITERS), eager_fn(cfg_ds, ITERS)
    for label, run, mdl in (("dense raft-things", run_d, model),
                            ("dense raft-small", run_ds, model_s)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        drive(f"{label}: {N_WINDOW} requests at {H_IMG}x{W_IMG}, {ITERS} iters "
              f"(no kernel on this path)", run, mdl, pairs[:N_WINDOW], {})
        print(f"{label}: peak device memory of a request "
              f"{(torch.cuda.max_memory_allocated() - held0) / 2 ** 20:.0f} MiB "
              f"above the {held0 / 2 ** 20:.0f} MiB held before it")
    with torch.no_grad():
        fm1, fm2, _, _ = encode_pair(model, *(torch.from_numpy(x).to(dev)
                                              for x in pairs[0]), cfg_d)
        pyr = build_pyramid(*lookup_operands(fm1.permute(0, 2, 3, 1),
                                             fm2.permute(0, 2, 3, 1), L))
        pyramid_mb = sum(x.numel() * x.element_size() for x in pyr) / 1e6
        print(f"dense pyramid at {H_IMG}x{W_IMG}, batch 1: levels "
              f"{[list(x.shape) for x in pyr]}, {pyramid_mb:.1f} MB "
              f"(level 0 {pyr[0].numel() * 4 / 1e6:.1f} MB)")
        del pyr, fm1, fm2
        for label, c_d, c_k, mdl in (
                ("dense raft-things", cfg_d, RAFTConfig.full(corr_impl="pallas"), model),
                ("dense raft-small", cfg_ds, cfg_s, model_s)):
            for i, (a, b) in enumerate(pairs[:N_WINDOW]):
                worst = step_parity(c_d, c_k, torch.from_numpy(a).to(dev),
                                    torch.from_numpy(b).to(dev), mdl=mdl)
                print(f"{label} pair {i} vs corr_impl='pallas': every "
                      f"iteration, worst {worst[1]}")
                if worst[0] > 1.0:
                    raise AssertionError(f"{label}: dense disagrees with pallas")
    infer_d = make_inference_fn(cfg_d, iters=ITERS)
    infer_ds = make_inference_fn(cfg_ds, iters=ITERS)
    for label, fn, run, mdl in (("dense raft-things", infer_d, run_d, model),
                                ("dense raft-small", infer_ds, run_ds, model_s)):
        held_replay(f"captured {label}", fn(mdl, *pairs[0]), run(mdl, *pairs[0]))

    # -- 6i. the converge policy (6c) ----------------------------------------
    # a batch of 2 (pairs 0 and 1) whose eps, picked from an eager run's
    # per-iteration dn (the mean L2 norm of each row's flow update, computed
    # as the loop computes it), freezes the rows at different iterations:
    # eager (launch counts: the iterations that ran), captured (three graphs:
    # bitwise equal to eager, iteration replays = max(iters_used)), and
    # converge:0 captured bitwise equal to the fixed policy's graph
    im1_2 = np.concatenate([pairs[0][0], pairs[1][0]])
    im2_2 = np.concatenate([pairs[0][1], pairs[1][1]])
    new_launches = {"f32": {}, "bf16": {}}          # new paths' eager launches

    def add_launches(dtype_key, got):
        for k, v in got.items():
            new_launches[dtype_key][k] = new_launches[dtype_key].get(k, 0) + v

    def dn_trajectory(mdl, cfg, t1, t2):
        with torch.no_grad():
            fm1, fm2, net, inp = encode_pair(mdl, t1, t2, cfg)
            loop = prepare_loop(mdl, fm1, fm2, inp, cfg)
            c1, dns = loop.coords0, []
            for _ in range(ITERS):
                net, delta, _ = raft_update(mdl, cfg, loop, net, c1)
                c1 = c1 + delta
                dns.append(delta.square().sum(dim=-1).sqrt().mean(dim=(1, 2)))
        return torch.stack(dns).cpu().numpy()             # [ITERS, B]

    def freeze_iters(dn, eps, m):
        """Each row's iters_used under converge:eps:m, given its dn."""
        return [next((i + 1 for i in range(m - 1, ITERS) if dn[i, b] < eps),
                     ITERS) for b in range(dn.shape[1])]

    def pick_policy(dn):
        """(eps, min_iters, iters_used, relative gap): the rows freeze at
        different iterations, the last before ITERS where it can be, with
        the largest relative distance of any dn from eps."""
        best = None
        for m in range(1, ITERS + 1):
            vals = np.unique(dn[m - 1:])
            for lo, hi in zip(vals, vals[1:]):
                eps = float(np.float32(0.5 * (lo + hi)))
                used = freeze_iters(dn, eps, m)
                if len(set(used)) < 2:
                    continue
                gap = float(np.abs(dn - eps).min() / eps)
                score = (max(used) < ITERS, gap)
                if best is None or score > best[0]:
                    best = (score, eps, m, used)
        if best is None:
            raise AssertionError(f"no eps freezes the rows apart: dn {dn.tolist()}")
        return best[1], best[2], best[3], best[0][1]

    conv_fns, conv_launches = {}, {}
    for label, cfg_b, mdl in (("f32", cfg_k, model), ("bf", cfg_bf, model_bf)):
        t1, t2 = (torch.from_numpy(x).to(dev) for x in (im1_2, im2_2))
        dn = dn_trajectory(mdl, cfg_b, t1, t2)
        eps, m, used, gap = pick_policy(dn)
        policy = f"converge:{eps!r}:{m}"
        cfg_c = dataclasses.replace(cfg_b, iters_policy=policy)
        _reset(*kernels)
        with torch.no_grad():
            out_e = raft_forward(mdl, t1, t2, cfg_c, iters=ITERS)
        torch.cuda.synchronize()
        got = _launches(*kernels)
        conv_launches[label] = got
        add_launches("bf16" if label == "bf" else "f32", got)
        used_e = out_e.iters_used.tolist()
        lookup = "corr_packed" if label == "bf" else "corr_lookup"
        want = {k: 0 for k in got}
        want.update({lookup: max(used), "sep_conv_gru": max(used) * gru_per_iter})
        print(f"converge {label}: batch of 2 at {H_IMG}x{W_IMG}, {policy} (dn per "
              f"iteration and row {np.round(dn, 3).tolist()}, nearest dn "
              f"{gap:.3g} of eps away): iters_used eager {used_e} (predicted "
              f"{used}); launches {got}")
        if used_e != used or got != want or not bool(torch.isfinite(out_e.flow).all()):
            raise AssertionError(f"converge {label}: iters_used {used_e} != "
                                 f"{used} or launches {got} != {want}")
        # the kernels at this batch of 2, each step held to the plain step
        # from the same state as in phases 4 and 6c; the plain path's own dn
        # and the iters_used it gives, printed
        with torch.no_grad():
            worst = (bf16_step_parity(cfg_b, t1, t2) if label == "bf"
                     else step_parity(cfg_b, cfg_p, t1, t2))
        dn_p = dn_trajectory(mdl, cfg_pb if label == "bf" else cfg_p, t1, t2)
        print(f"converge {label}, batch of 2: every iteration vs the plain "
              f"step, worst {worst[1]} (ratio {worst[0]:.3g}); not held: the "
              f"plain path's dn gives iters_used {freeze_iters(dn_p, eps, m)}, "
              f"max relative dn difference "
              f"{float((np.abs(dn_p - dn) / dn).max()):.3g}")
        if not worst[0] <= 1.0:
            raise AssertionError(f"converge {label}: a kernel step at batch 2 "
                                 f"disagrees with the plain step")
        fn_c = make_counted_inference_fn(cfg_c, iters=ITERS)
        _reset(*kernels)
        flow_c, used_c = fn_c(mdl, im1_2, im2_2)
        torch.cuda.synchronize()
        at_capture = _launches(*kernels)
        flow_c2, _ = fn_c(mdl, im1_2, im2_2)
        torch.cuda.synchronize()
        replayed = {k: v - at_capture[k] for k, v in _launches(*kernels).items()}
        step_replays = fn_c.graphs.step_replays
        per_iter = {k: v // max(used) for k, v in got.items()}
        same = (torch.equal(flow_c, out_e.flow) and torch.equal(flow_c2, out_e.flow)
                and used_c.tolist() == used_e)
        print(f"captured converge {label}: three graphs, captures "
              f"{fn_c.graphs.captures}; launches at the capture {at_capture} "
              f"(two iterations' {per_iter}), at the replays {replayed}; "
              f"iteration replays {step_replays} (max(iters_used) {max(used)}); "
              f"bitwise equal to eager: {same}")
        if (not same or step_replays != max(used) or any(replayed.values())
                or at_capture != {k: 2 * v for k, v in per_iter.items()}):
            raise AssertionError(f"captured converge {label} is not the eager "
                                 f"converge")
        fn_0 = make_counted_inference_fn(
            dataclasses.replace(cfg_b, iters_policy="converge:0"), iters=ITERS)
        fn_f = make_counted_inference_fn(cfg_b, iters=ITERS)
        f0, u0 = fn_0(mdl, im1_2, im2_2)
        ff, uf = fn_f(mdl, im1_2, im2_2)
        same0 = torch.equal(f0, ff) and torch.equal(u0, uf)
        print(f"captured converge:0 {label}: bitwise equal to the fixed policy's "
              f"graph: {same0}; iteration replays {fn_0.graphs.step_replays}")
        if not same0 or fn_0.graphs.step_replays != ITERS:
            raise AssertionError(f"converge:0 {label} is not the fixed policy")
        # every row frozen at half the loop (eps 1e9, min_iters ITERS / 2)
        half = ITERS // 2
        cfg_6 = dataclasses.replace(cfg_b, iters_policy=f"converge:1e9:{half}")
        fn_6 = make_counted_inference_fn(cfg_6, iters=ITERS)
        f6, u6 = fn_6(mdl, im1_2, im2_2)
        with torch.no_grad():
            same6 = torch.equal(f6, raft_forward(mdl, t1, t2, cfg_6, iters=ITERS).flow)
        print(f"captured converge:1e9:{half} {label}: iters_used {u6.tolist()}, "
              f"iteration replays {fn_6.graphs.step_replays}, bitwise equal to "
              f"eager: {same6}")
        if u6.tolist() != [half] * 2 or fn_6.graphs.step_replays != half or not same6:
            raise AssertionError(f"converge:1e9:{half} {label} did not stop at "
                                 f"{half}")
        conv_fns[label] = (fn_f, fn_0, fn_c, fn_6, cfg_c, mdl, max(used))

    # the ragged counted entry under converge (B4): every row stops at 3
    cfg_rc = dataclasses.replace(cfg_k, iters_policy="converge:1e9:3")
    rsz = torch.from_numpy(sizes).to(dev)
    _reset(*kernels)
    with torch.no_grad():
        out_rc = raft_forward(model, torch.from_numpy(rim1).to(dev),
                              torch.from_numpy(rim2).to(dev), cfg_rc,
                              iters=ITERS, sizes=rsz)
    torch.cuda.synchronize()
    got = _launches(*kernels)
    add_launches("f32", got)
    fn_rc = make_ragged_counted_inference_fn(cfg_rc, iters=ITERS)
    f_rc, u_rc = fn_rc(model, rim1, rim2, sizes)
    same = (torch.equal(f_rc, out_rc.flow)
            and u_rc.tolist() == out_rc.iters_used.tolist() == [3, 3, 3])
    print(f"captured ragged counted converge:1e9:3, the batch of 3 in the "
          f"{BOX[0]}x{BOX[1]} box: iters_used {u_rc.tolist()}, iteration "
          f"replays {fn_rc.graphs.step_replays}, eager launches {got}; "
          f"bitwise equal to eager: {same}")
    if (not same or fn_rc.graphs.step_replays != 3
            or got != {k: {"corr_ragged": 3, "sep_conv_gru": 3 * gru_per_iter}
                       .get(k, 0) for k in got}):
        raise AssertionError("ragged counted converge is not the eager one")

    # -- 6j. the streaming entries (6d) ----------------------------------------
    # a 4-frame sequence (a seeded texture translated by (3, 5) px a frame,
    # with noise): the solo step (maps cached, the warm start's seed) eager
    # and captured, bitwise; each step held to the pairwise request on the
    # same frames with the same seed, per iteration (each step from the same
    # state, the pairwise features against the stream's) and over 3
    # iterations at phase 4's bound; a batch step of 4 slots (one padding),
    # each real row held to its solo step over 3 iterations; int8 slots; the
    # ragged stream batch on phase 6's box (B4), each crop held to the
    # pairwise ragged request over 3 iterations; every captured step bitwise
    # equal to its eager run
    rng_s = np.random.RandomState(20)
    tex = rng_s.rand(1, H_IMG + 12, W_IMG + 20, 3)
    seq = [np.clip(tex[:, 3 * k:3 * k + H_IMG, 5 * k:5 * k + W_IMG]
                   + 0.02 * rng_s.randn(1, H_IMG, W_IMG, 3), 0, 1).astype(np.float32)
           for k in range(4)]

    def on_dev(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def stream_eager(cfg, mdl, iters=ITERS):
        """The solo step's eager twin: encode_frame + forward_from_features."""
        def run(image, fmap_prev, cnet_prev, flow_init, sizes=None):
            with torch.no_grad():
                img, s8 = on_dev(image, torch.float32), None
                if sizes is not None:
                    sz = on_dev(sizes, torch.int32)
                    img, s8 = mask_ragged_rows(img, sz), sz // 8
                fm, cn = encode_frame(mdl, img, cfg)
                out = forward_from_features(mdl, fmap_prev, fm, cnet_prev, cfg,
                                            iters=iters,
                                            flow_init=on_dev(flow_init, torch.float32),
                                            sizes8=s8)
            res = (out.flow, out.flow_lr, fm, cn)
            return res + (out.iters_used,) if cfg.iters_policy != "fixed" else res
        return run

    def batch_eager(cfg, mdl, iters=ITERS):
        """The batch step's eager twin: rows gathered from the buffers."""
        def run(images, fbuf, cbuf, flbuf, slots, active, sizes=None):
            with torch.no_grad():
                img, s8 = on_dev(images, torch.float32), None
                sl, ac = on_dev(slots, torch.int32), on_dev(active, torch.bool)
                if sizes is not None:
                    sz = on_dev(sizes, torch.int32)
                    img, s8 = mask_ragged_rows(img, sz), sz // 8
                fm, cn = encode_frame(mdl, img, cfg)
                out = forward_from_features(
                    mdl, gather_rows(fbuf, sl, fm.dtype), fm,
                    gather_rows(cbuf, sl, cn.dtype), cfg, iters=iters,
                    flow_init=flbuf.index_select(0, sl), active=ac, sizes8=s8)
            res = (out.flow, out.flow_lr, fm, cn)
            return res + (out.iters_used,) if cfg.iters_policy != "fixed" else res
        return run

    def held_bitwise(label, got, want):
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"{label}: captured bitwise equal to eager: {same}")
        if not same:
            raise AssertionError(f"{label}: captured step differs from eager")

    def captured_counts(label, fn, args, eager_counts):
        """The first call of a captured step (its capture) counts twice the
        eager step's launches, a second call none; returns its output."""
        _reset(*kernels)
        out = fn(*args)
        torch.cuda.synchronize()
        at_capture = _launches(*kernels)
        fn(*args)
        torch.cuda.synchronize()
        again = {k: v - at_capture[k] for k, v in _launches(*kernels).items()}
        if (at_capture != {k: 2 * eager_counts.get(k, 0) for k in at_capture}
                or any(again.values())):
            raise AssertionError(f"{label}: capture counted {at_capture}, a "
                                 f"replay {again} (an eager step: {eager_counts})")
        return out

    def same_state_parity(cfg, mdl, feats_a, feats_b, net, init, crops=None,
                          sizes8=None, feats_f=None):
        """Worst (ratio, message) over the iterations of a step with the
        features ``feats_a`` and one with ``feats_b`` (each (fmap1, fmap2,
        inp), NCHW) taken from the same state, ``feats_b``'s carrying it,
        on each crop.  In float32 the ratio is to phase 4's bound.  In
        bfloat16 it is to twice bfloat16's own distance from float32 there:
        the plain float32 step of the float32 weights (``model``) from the
        same state on ``feats_f``, the float32 encoders' features of the
        same frames.  Twice, as the CPU tests hold the bf16 policy end to
        end (ROADMAP's bf16 finding of the check): the two bf16 feature
        sets come from encoder passes of other batch widths, whose bf16
        convs cuDNN runs with other engines, and the runs so far measured
        the step apart by 0.73-1.14 of the bf16-vs-f32 distance, by the
        engines picked.  This compares encoder passes; the kernels are held from
        identical features by kernel_vs_plain."""
        bf = feats_f is not None
        loop_a = prepare_loop(mdl, *feats_a, cfg, sizes8)
        loop_b = prepare_loop(mdl, *feats_b, cfg, sizes8)
        loop_f = prepare_loop(model, *feats_f, cfg_p, sizes8) if bf else None
        c0 = loop_b.coords0
        c1, worst = c0 + init, (0.0, "")
        for it in range(ITERS):
            _, ca, ma = gru_step(mdl, cfg, loop_a, net, c1)
            net_b, cb, mb = gru_step(mdl, cfg, loop_b, net, c1)
            fa, fb = (upsample_flow(cfg, c - c0, m) for c, m in ((ca, ma), (cb, mb)))
            if not bf:
                worst = max(worst, _within(f"iteration {it}", fa, fb, crops))
            else:
                _, cf, mf = gru_step(model, cfg_p, loop_f, net.float(), c1)
                ff = upsample_flow(cfg_p, cf - c0, mf)
                for b, (h, w) in enumerate(crops or [tuple(fa.shape[1:3])] * fa.shape[0]):
                    dk = float((fa[b, :h, :w] - fb[b, :h, :w]).abs().max())
                    env = float((fb[b, :h, :w] - ff[b, :h, :w]).abs().max())
                    ratio = dk / max(env, 1e-30)
                    if ratio / 2 > worst[0] or not worst[1]:
                        worst = (ratio / 2,
                                 f"iteration {it} item {b}: {dk:.3e} apart, the "
                                 f"bf16 step {env:.3e} from the f32 step (ratio "
                                 f"{ratio:.3f}, held to 2)")
            net, c1 = net_b, cb
        return worst

    def end_to_end(label, cfg, got, want, crops=None):
        """Over 3 iterations end to end: held at phase 4's bound in float32;
        under bfloat16 printed only, since the encoders' bfloat16 rounding
        differs between batch widths by an ulp here and there, which the
        random-weight recurrence amplifies (ROADMAP's bf16 finding)."""
        held = _within("3 iterations end to end", got, want, crops)
        if cfg.compute_dtype == "bfloat16":
            return (0.0, f"{held[1]} (not held in bfloat16, ratio {held[0]:.3g})")
        if held[0] > 1.0:
            raise AssertionError(f"{label}: {held[1]}")
        return held

    def f32_feats(t1, t2):
        """(fmap1, fmap2, inp) of the float32 encoders of ``model``."""
        fm1, fm2, _, inp = encode_pair(model, t1, t2, cfg_p)
        return fm1, fm2, inp

    def kernel_vs_plain(label, cfg, mdl, fmap_prev, fmap_cur, cnet_prev,
                        init, sizes8=None, crops=None):
        """The kernels at a streaming path's own batch, from the features
        that path computed (NHWC rows, as the step gathers them): every
        iteration's kernel step held to the plain step from the same state,
        as in phase 4 (float32) and phase 6c (bfloat16: within the plain
        bf16 step's own distance from the plain f32 step)."""
        net, inp = split_context(cnet_prev, cfg)
        feats = (to_nchw(fmap_prev.contiguous()), to_nchw(fmap_cur.contiguous()),
                 inp)
        with torch.no_grad():
            if cfg.compute_dtype == "bfloat16":
                worst = bf16_core_parity(cfg, feats, net, init, sizes8, crops,
                                         mdl)
                what = f"{worst[1]} (ratio {worst[0]:.3f})"
            else:
                worst = core_parity(cfg, cfg_p, feats, net, init, sizes8, crops,
                                    mdl)
                what = worst[1]
        print(f"{label}, batch of {net.shape[0]}: every iteration vs the plain "
              f"step from the same state, worst {what}")
        if not worst[0] <= 1.0:
            raise AssertionError(f"{label}: a kernel step disagrees with the "
                                 f"plain step")

    stream_fns = {}
    for label, cfg_b, mdl in (("f32", cfg_k, model), ("bf", cfg_bf, model_bf)):
        dkey = "bf16" if label == "bf" else "f32"
        bf = label == "bf"
        lookup = "corr_packed" if label == "bf" else "corr_lookup"
        per_step = {lookup: ITERS, "sep_conv_gru": ITERS * gru_per_iter}
        enc = make_encode_fn(cfg_b)
        step = make_stream_step_fn(cfg_b, iters=ITERS)
        run_st = stream_eager(cfg_b, mdl)
        fmap0 = enc(mdl, seq[0])
        with torch.no_grad():
            want0 = encode_frame(mdl, on_dev(seq[0]), cfg_b)
        held_bitwise(f"captured encode {label}", fmap0, want0)
        # the eager chain (counts), the warm start seeding each step
        inputs, eager_out, prev_lr = [], [], None
        fmap, cnet = want0
        _reset(*kernels)
        for k in range(1, 4):
            init = warm_start_seed(prev_lr, (H_IMG // 8, W_IMG // 8))
            inputs.append((seq[k], fmap, cnet, init))
            eager_out.append(run_st(*inputs[-1]))
            fmap, cnet, prev_lr = (eager_out[-1][2], eager_out[-1][3],
                                   eager_out[-1][1].cpu().numpy())
        torch.cuda.synchronize()
        got = _launches(*kernels)
        add_launches(dkey, got)
        print(f"stream {label}: 3 solo steps at {H_IMG}x{W_IMG}, {ITERS} iters; "
              f"launches {got}")
        if got != {k: 3 * per_step.get(k, 0) for k in got}:
            raise AssertionError(f"stream {label}: launch counts {got}")
        first_out = captured_counts(f"captured stream step {label}",
                                lambda *a: step(mdl, *a), inputs[0], per_step)
        held_bitwise(f"captured stream step {label}, step 1", first_out,
                     eager_out[0])
        for k in (1, 2):
            held_bitwise(f"captured stream step {label}, step {k + 1}",
                         step(mdl, *inputs[k]), eager_out[k])
        # each step's kernels against the plain step, and each step against
        # the pairwise request on the same frames and seed
        zero_seed = np.zeros((1, H_IMG // 8, W_IMG // 8, 2), np.float32)
        with torch.no_grad():
            for k, (image, fmap_prev, cnet_prev, init) in enumerate(inputs):
                kernel_vs_plain(f"stream {label} step {k + 1}", cfg_b, mdl,
                                fmap_prev, eager_out[k][2], cnet_prev,
                                on_dev(init))
                tp, tc = on_dev(seq[k]), on_dev(image)
                fm1, fm2, net, inp = encode_pair(mdl, tp, tc, cfg_b)
                _, inp_s = split_context(cnet_prev, cfg_b)
                worst = same_state_parity(
                    cfg_b, mdl, (to_nchw(fmap_prev), to_nchw(eager_out[k][2]), inp_s),
                    (fm1, fm2, inp), net, on_dev(init),
                    feats_f=f32_feats(tp, tc) if bf else None)
                e2e = end_to_end(
                    f"stream {label} step {k + 1}", cfg_b,
                    forward_from_features(mdl, fmap_prev, eager_out[k][2], cnet_prev,
                                          cfg_b, iters=3, flow_init=on_dev(init)).flow,
                    raft_forward(mdl, tp, tc, cfg_b, iters=3,
                                 flow_init=on_dev(init)).flow)
                print(f"stream {label} step {k + 1} vs the pairwise request: every "
                      f"iteration, worst {worst[1]}; {e2e[1]}")
                if worst[0] > 1.0:
                    raise AssertionError(f"stream {label} step {k + 1} disagrees "
                                         f"with the pairwise request")
        # a batch step of 4 slots, the last a padding row on the scratch slot
        prev3 = [seq[0], pairs[0][0], pairs[1][0]]
        cur3 = [seq[1], pairs[0][1], pairs[1][1]]
        cap = 4
        with torch.no_grad():
            maps = [encode_frame(mdl, on_dev(p), cfg_b) for p in prev3]
        fbuf = torch.zeros((cap + 1, H_IMG // 8, W_IMG // 8, 256),
                           dtype=maps[0][0].dtype, device=dev)
        cbuf = torch.zeros_like(fbuf)
        flbuf = torch.zeros((cap + 1, H_IMG // 8, W_IMG // 8, 2), device=dev)
        slots = np.array([3, 0, 2, cap], np.int32)
        for s_, (fm, cn) in zip(slots, maps):
            fbuf[s_], cbuf[s_] = fm[0], cn[0]
        images = np.concatenate(cur3 + [cur3[-1]])
        active = np.array([True, True, True, False])
        run_b = batch_eager(cfg_b, mdl)
        bstep = make_stream_batch_step_fn(cfg_b, iters=ITERS)
        bargs = (images, fbuf, cbuf, flbuf, slots, active)
        _reset(*kernels)
        want_b = run_b(*bargs)
        torch.cuda.synchronize()
        got = _launches(*kernels)
        add_launches(dkey, got)
        print(f"stream batch {label}: 4 slots (one padding) at {H_IMG}x{W_IMG}, "
              f"{ITERS} iters; launches {got}")
        if got != {k: per_step.get(k, 0) for k in got}:
            raise AssertionError(f"stream batch {label}: launch counts {got}")
        held_bitwise(f"captured stream batch {label}",
                     captured_counts(f"captured stream batch {label}",
                                     lambda *a: bstep(mdl, *a), bargs, got),
                     want_b)
        sl = on_dev(slots, torch.int32)
        kernel_vs_plain(f"stream batch {label}", cfg_b, mdl,
                        fbuf.index_select(0, sl), want_b[2],
                        cbuf.index_select(0, sl), flbuf.index_select(0, sl))
        # each real row against its solo step: the maps of the batch's
        # encoder pass and of a batch-1 pass, from the same state
        with torch.no_grad():
            b3 = batch_eager(cfg_b, mdl, iters=3)(*bargs)[0]
            for i, ((fm_p, cn_p), c) in enumerate(zip(maps, cur3)):
                fm_solo = encode_frame(mdl, on_dev(c), cfg_b)[0]
                net_i, inp_i = split_context(cn_p, cfg_b)
                worst = same_state_parity(
                    cfg_b, mdl, (to_nchw(fm_p), to_nchw(want_b[2][i:i + 1]), inp_i),
                    (to_nchw(fm_p), to_nchw(fm_solo), inp_i), net_i,
                    on_dev(zero_seed),
                    feats_f=f32_feats(on_dev(prev3[i]), on_dev(c)) if bf else None)
                e2e = end_to_end(
                    f"stream batch {label} row {i}", cfg_b, b3[i:i + 1],
                    stream_eager(cfg_b, mdl, iters=3)(c, fm_p, cn_p, zero_seed)[0])
                print(f"stream batch {label} row {i} vs its solo step: every "
                      f"iteration, worst {worst[1]}; {e2e[1]}")
                if worst[0] > 1.0:
                    raise AssertionError(f"stream batch {label} row {i} "
                                         f"disagrees with its solo step")
        # int8 slots: the same pool quantized
        cfg_q = dataclasses.replace(cfg_b, quant="int8")
        qf, qc = rt_quantize_rows(fbuf), rt_quantize_rows(cbuf)
        qargs = (images, qf, qc, flbuf, slots, active)
        _reset(*kernels)
        want_q = batch_eager(cfg_q, mdl)(*qargs)
        torch.cuda.synchronize()
        got = _launches(*kernels)
        add_launches(dkey, got)
        qstep = make_stream_batch_step_fn(cfg_q, iters=ITERS)
        held_bitwise(f"captured stream batch int8 {label}",
                     captured_counts(f"captured stream batch int8 {label}",
                                     lambda *a: qstep(mdl, *a), qargs, got),
                     want_q)
        kernel_vs_plain(f"stream batch int8 {label}", cfg_q, mdl,
                        gather_rows(qf, sl, want_q[2].dtype), want_q[2],
                        gather_rows(qc, sl, want_q[3].dtype),
                        flbuf.index_select(0, sl))
        dq = float((want_q[0][:3] - want_b[0][:3]).abs().max())
        print(f"stream batch int8 {label}: launches {got}; finite "
              f"{bool(torch.isfinite(want_q[0]).all())}; not held: max|flow - "
              f"the unquantized batch's| {dq:.3g} after {ITERS} iterations")
        if not bool(torch.isfinite(want_q[0]).all()):
            raise AssertionError(f"stream batch int8 {label}: non-finite flow")
        # the ragged stream batch on phase 6's box: B4
        cfg_rs = cfg_rbf if label == "bf" else cfg_k
        sz_r = torch.from_numpy(sizes).to(dev)
        with torch.no_grad():
            rm = encode_frame(mdl, mask_ragged_rows(on_dev(rim1), sz_r), cfg_rs)
        rfl = torch.zeros((4, hb, wb, 2), device=dev)
        rf = torch.cat([rm[0], torch.zeros_like(rm[0][:1])])
        rc = torch.cat([rm[1], torch.zeros_like(rm[1][:1])])
        rargs = (rim2, rf, rc, rfl, np.array([0, 1, 2], np.int32),
                 np.array([True, True, True]), sizes)
        _reset(*kernels)
        want_r = batch_eager(cfg_rs, mdl)(*rargs)
        torch.cuda.synchronize()
        got = _launches(*kernels)
        add_launches(dkey, got)
        print(f"ragged stream batch {label}: 3 sessions in the {BOX[0]}x{BOX[1]} "
              f"box, live {[list(c) for c in CROPS]}; launches {got}")
        if got != {k: {"corr_ragged": ITERS, "sep_conv_gru": ITERS * gru_per_iter}
                   .get(k, 0) for k in got}:
            raise AssertionError(f"ragged stream batch {label}: launch counts {got}")
        rstep = make_ragged_stream_batch_step_fn(cfg_rs, iters=ITERS)
        held_bitwise(f"captured ragged stream batch {label}",
                     captured_counts(f"captured ragged stream batch {label}",
                                     lambda *a: rstep(mdl, *a), rargs, got),
                     want_r)
        kernel_vs_plain(f"ragged stream batch {label}, each crop", cfg_rs, mdl,
                        rm[0], want_r[2], rm[1], rfl[:3], sz_r // 8, CROPS)
        with torch.no_grad():
            fm1, fm2, net, inp = encode_pair(
                mdl, *(mask_ragged_rows(on_dev(x), sz_r) for x in (rim1, rim2)),
                cfg_rs)
            _, inp_s = split_context(rm[1], cfg_rs)
            worst = same_state_parity(
                cfg_rs, mdl, (to_nchw(rm[0]), to_nchw(want_r[2]), inp_s),
                (fm1, fm2, inp), net, rfl[:3], CROPS, sz_r // 8,
                f32_feats(*(mask_ragged_rows(on_dev(x), sz_r) for x in (rim1, rim2)))
                if bf else None)
            e2e = end_to_end(
                f"ragged stream batch {label}", cfg_rs,
                batch_eager(cfg_rs, mdl, iters=3)(*rargs)[0],
                raft_forward(mdl, on_dev(rim1), on_dev(rim2), cfg_rs, iters=3,
                             sizes=sz_r).flow, CROPS)
        print(f"ragged stream batch {label}, each crop vs the pairwise ragged "
              f"request: every iteration, worst {worst[1]}; {e2e[1]}")
        if worst[0] > 1.0:
            raise AssertionError(f"ragged stream batch {label} disagrees with "
                                 f"the pairwise ragged request")
        # the solo and the batch step under converge (three graphs each, the
        # encoder pass in the prologue): every live row stops at 3, the
        # padding row counts 0
        cfg_sc = dataclasses.replace(cfg_b, iters_policy="converge:1e9:3")
        sstep = make_stream_step_fn(cfg_sc, iters=ITERS)
        cbstep = make_stream_batch_step_fn(cfg_sc, iters=ITERS)
        _reset(*kernels)
        want_sc = stream_eager(cfg_sc, mdl)(*inputs[0])
        want_cb = batch_eager(cfg_sc, mdl)(*bargs)
        torch.cuda.synchronize()
        got = _launches(*kernels)
        add_launches(dkey, got)
        got_sc, got_cb = sstep(mdl, *inputs[0]), cbstep(mdl, *bargs)
        held_bitwise(f"captured converge stream step {label}", got_sc, want_sc)
        held_bitwise(f"captured converge stream batch {label}", got_cb, want_cb)
        print(f"converge stream {label}: iters_used solo {got_sc[4].tolist()}, "
              f"batch {got_cb[4].tolist()}; iteration replays "
              f"{sstep.graphs.step_replays} and {cbstep.graphs.step_replays}; "
              f"eager launches {got}")
        if (got_sc[4].tolist() != [3] or got_cb[4].tolist() != [3, 3, 3, 0]
                or (sstep.graphs.step_replays, cbstep.graphs.step_replays) != (3, 3)
                or got != {k: 2 * 3 * per_step.get(k, 0) // ITERS for k in got}):
            raise AssertionError(f"converge stream {label} is not the eager one")
        stream_fns[label] = dict(
            step=(step, run_st, inputs[0], mdl), batch=(bstep, run_b, bargs, mdl),
            int8=(qstep, batch_eager(cfg_q, mdl), qargs, mdl),
            ragged=(rstep, batch_eager(cfg_rs, mdl), rargs, mdl))

    # -- 6k. the last of 6e: 'blockwise' + 'gather' and gru_ctx_hoist=False --
    # one request each, per iteration held to the 'pallas' path: the gather
    # lookup with the plain GRU (no kernel), and the un-hoisted plain GRU
    # with B1
    cfg_g = RAFTConfig.full(corr_impl="blockwise", corr_lookup="gather")
    cfg_u = RAFTConfig.full(corr_impl="pallas", gru_impl="xla",
                            gru_ctx_hoist=False)
    rest_fns = {}
    for key, cfg_x, want_x in (("blockwise_gather", cfg_g, {}),
                               ("unhoisted", cfg_u, {"corr_lookup": ITERS})):
        run_x = eager_fn(cfg_x, ITERS)
        add_launches("f32", drive(f"{key}: 1 request at {H_IMG}x{W_IMG}, "
                                  f"{ITERS} iters", run_x, model, pairs[:1],
                                  want_x))
        with torch.no_grad():
            worst = step_parity(cfg_k, cfg_x, *(torch.from_numpy(x).to(dev)
                                                for x in pairs[0]))
        print(f"{key} vs corr_impl='pallas': every iteration, worst {worst[1]}")
        if worst[0] > 1.0:
            raise AssertionError(f"{key} disagrees with the pallas path")
        fn_x = make_inference_fn(cfg_x, iters=ITERS)
        held_replay(f"captured {key}", fn_x(model, *pairs[0]), run_x(model, *pairs[0]))
        rest_fns[key] = (fn_x, run_x)

    # -- 7. times ----------------------------------------------------------
    corr_ms = _time_ms(lambda: corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r), 3, 50)
    corr_plain_ms = _time_ms(lambda: lookup_blockwise_onehot(fmap1, levels, coords, r), 1, 10)
    corr_bound, corr_by = _corr_bound(fmap1, levels, coords, r)

    win_ms = _time_ms(lambda: corr_cuda.corr_window_cuda(fmap1, levels, coords, r), 3, 50)
    win_plain_ms = _time_ms(lambda: lookup_window_plain(fmap1, levels, coords, r), 1, 5)

    rag_ms = _time_ms(lambda: corr_cuda.corr_ragged_cuda(rf1, rlevels, rcoords, sizes8, r), 3, 50)
    rag_plain_ms = _time_ms(lambda: lookup_ragged_plain(rf1, rlevels, rcoords, sizes8, r), 1, 5)
    def rag_bound(f1, lvs, cc=rcoords):
        """The ragged lookup reads the live queries' f1 rows and coords, each
        level within each item's live crop there, and sizes8; it writes
        every query's output (dead ones zeros); its products are the live
        queries' in-crop window positions."""
        pos, live_rows = 0, int(live8.sum())
        for b, (h, w) in enumerate(sizes8.tolist()):
            clip = [(min(lv.shape[1], h >> i), min(lv.shape[2], w >> i))
                    for i, lv in enumerate(lvs)]
            pos += _corr_positions(cc[b][live8[b]], clip, r)
            live_rows += sum(ch * cw for ch, cw in clip)
        reads = (f1.element_size() * f1.shape[-1] * live_rows
                 + 4 * (2 * int(live8.sum()) + sizes8.numel()))
        return _corr_bound(f1, lvs, cc, r, pos, int(live8.sum()) * L * nn_, reads)

    rag_bound_ms, rag_by = rag_bound(rf1, rlevels)

    h, mot, ctx = gru_inputs(rng, dev, 1, h8, w8)
    gru_ms = _time_ms(lambda: gru_cuda.sep_conv_gru_cuda(kw, h, mot, ctx), 3, 50)
    gru_plain_ms = _time_ms(lambda: gru_cuda.sep_conv_gru_plain(fw, h, mot, ctx), 2, 10)

    def gru_bound(hh, mm, cc, w):                # activations in, h out, weights
        nbytes = (hh.element_size() * (2 * hh.numel() + mm.numel() + cc[0].numel()
                                       + cc[1].numel())
                  + hh.element_size() * sum(v.numel() for v in w.values()))
        return _bound_ms(nbytes, _gru_flops(1, h8, w8, 128, 128,
                                            hh.dtype == torch.bfloat16))

    gru_bound_ms, gru_by = gru_bound(h, mot, ctx, fw)
    print(f"corr_lookup: {corr_ms:.4f} ms/call (plain {corr_plain_ms:.4f}), bound "
          f"{corr_bound:.4f} ms by {corr_by}")
    print(f"corr_window: {win_ms:.4f} ms/call (plain {win_plain_ms:.4f}), bound "
          f"{corr_bound:.4f} ms by {corr_by} (the inputs and work of corr_lookup)")
    print(f"corr_ragged: {rag_ms:.4f} ms/call (plain {rag_plain_ms:.4f}), bound "
          f"{rag_bound_ms:.4f} ms by {rag_by}")
    print(f"sep_conv_gru: {gru_ms:.4f} ms/call (plain {gru_plain_ms:.4f}), bound "
          f"{gru_bound_ms:.4f} ms by {gru_by}")
    print("library_ms: null for all — no single PyTorch call computes a "
          "windowed correlation lookup or a SepConvGRU iteration")

    # the packed lookup beside the first and the window lookups, same inputs
    pk = {}
    for ps in ("all", "window"):
        pk[ps] = _time_ms(lambda: corr_cuda.corr_packed_cuda(fmap1, levels, coords, r, ps), 3, 50)
        pk[ps + "_plain"] = _time_ms(lambda: lookup_packed_plain(fmap1, levels, coords, r, ps), 1, 5)
    print(f"corr_packed [1,54,128,256], levels {first}-{L - 1} narrow: 'all' "
          f"{pk['all']:.4f} ms/call (plain {pk['all_plain']:.4f}), 'window' "
          f"{pk['window']:.4f} (plain {pk['window_plain']:.4f}), bound "
          f"{corr_bound:.4f} ms by {corr_by}; on the same inputs corr_lookup "
          f"{corr_ms:.4f}, corr_window {win_ms:.4f}")

    # each bfloat16 instantiation beside its float32 kernel, same inputs
    bf_ms = {
        "corr_lookup": (_time_ms(lambda: corr_cuda.corr_lookup_cuda(bf1, blevels, coords, r), 3, 50),
                        _time_ms(lambda: lookup_blockwise_onehot(bf1, blevels, coords, r), 1, 5),
                        _corr_bound(bf1, blevels, coords, r), corr_ms),
        "corr_window": (_time_ms(lambda: corr_cuda.corr_window_cuda(bf1, blevels, coords, r), 3, 50),
                        _time_ms(lambda: lookup_window_plain(bf1, blevels, coords, r), 1, 5),
                        _corr_bound(bf1, blevels, coords, r), win_ms),
        "corr_packed": (_time_ms(lambda: corr_cuda.corr_packed_cuda(bf1, blevels, coords, r, "window"), 3, 50),
                        _time_ms(lambda: lookup_packed_plain(bf1, blevels, coords, r, "window"), 1, 5),
                        _corr_bound(bf1, blevels, coords, r), pk["window"]),
        "corr_ragged": (_time_ms(lambda: corr_cuda.corr_ragged_cuda(rbf1, rblevels, rcoords, sizes8, r), 3, 50),
                        _time_ms(lambda: lookup_ragged_plain(rbf1, rblevels, rcoords, sizes8, r), 1, 5),
                        rag_bound(rbf1, rblevels), rag_ms),
        "sep_conv_gru": (_time_ms(lambda: gru_cuda.sep_conv_gru_cuda(kw_bf, gh, gmot, gctx), 3, 50),
                         _time_ms(lambda: gru_cuda.sep_conv_gru_plain(fw_bf, gh, gmot, gctx), 2, 10),
                         gru_bound(gh, gmot, gctx, fw_bf), gru_ms)}
    for name, (ms, plain_ms, (bound, by), f32_ms) in bf_ms.items():
        print(f"{name} bf16: {ms:.4f} ms/call (float32 kernel {f32_ms:.4f}, plain "
              f"{plain_ms:.4f}), bound {bound:.4f} ms by {by}")

    def call_ms(fn, *args, mdl=model):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(mdl, *args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    # every path captured (its factory: one graph per key, replayed) and
    # eager (raft_forward), in turns, after one warm-up call of each
    def p32_cfg(ps):
        return RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                               pallas_pack=True, pallas_p_select=ps)

    ragged_req = [(rim1, rim2, sizes)]
    e2e_paths = (
        ("main", infer_k, run_k, model, pairs, 1),
        ("window", make_inference_fn(cfg_w, iters=ITERS), run_w, model, pairs, 1),
        ("p32_all", make_inference_fn(p32_cfg("all"), iters=ITERS),
         run_p32["all"], model, pairs, 1),
        ("p32_window", make_inference_fn(p32_cfg("window"), iters=ITERS),
         run_p32["window"], model, pairs, 1),
        ("bf", infer_bf, run_bf, model_bf, pairs, 1),
        ("bf16corr_ctx_gru", infer_bfc, run_bfc, model_bf, pairs, 1),
        ("bf16corr_ctx_gru_win", make_inference_fn(cfg_bfw, iters=ITERS), run_bfw,
         model_bf, pairs, 1),
        ("ragged", infer_r, run_r, model, ragged_req, 3),
        ("ragged_bf16", infer_rbf, run_rbf, model_bf, ragged_req, 3),
        ("small", infer_s, run_s, model_s, pairs, 1),
        ("small_bf16", infer_sb, run_sb, model_sb, pairs, 1),
        ("dense", infer_d, run_d, model, pairs, 1),
        ("dense_small", infer_ds, run_ds, model_s, pairs, 1))
    cap_all, eag_all = {}, {}
    for key, fn, run, mdl, reqs, per_call in e2e_paths:
        call_ms(fn, *reqs[0], mdl=mdl)
        call_ms(run, *reqs[0], mdl=mdl)
        cap_all[key], eag_all[key] = [], []
        for i in range(8 if per_call == 1 else 6):
            cap_all[key].append(call_ms(fn, *reqs[i % len(reqs)], mdl=mdl))
            eag_all[key].append(call_ms(run, *reqs[i % len(reqs)], mdl=mdl))
        cap, eag = statistics.median(cap_all[key]), statistics.median(eag_all[key])
        unit = "request" if per_call == 1 else f"batch of {per_call}"
        print(f"e2e {key}, {ITERS} iters: captured median {cap:.2f} ms/{unit} "
              f"({1e3 * per_call / cap:.2f} pairs/s, min {min(cap_all[key]):.2f} "
              f"max {max(cap_all[key]):.2f}); eager median {eag:.2f} "
              f"({1e3 * per_call / eag:.2f} pairs/s, min {min(eag_all[key]):.2f} "
              f"max {max(eag_all[key]):.2f})")
    cap_med = {k: statistics.median(v) for k, v in cap_all.items()}
    eag_med = {k: statistics.median(v) for k, v in eag_all.items()}
    call_ms(run_p, *pairs[0])
    lat_p = [call_ms(run_p, *pairs[i % N_PAIRS]) for i in range(4)]
    med_p = statistics.median(lat_p)
    lat_k, med_k = cap_all["main"], cap_med["main"]
    med_r = cap_med["ragged"]
    print(f"e2e {H_IMG}x{W_IMG} batch 1, {ITERS} iters: the plain path (eager) "
          f"median {med_p:.2f} ms/request ({1e3 / med_p:.2f} pairs/s); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    live_share = sum(h * w for h, w in CROPS) / (len(CROPS) * BOX[0] * BOX[1])
    seq = []
    for (a, b), (h, w) in zip(crops, CROPS):
        hw8 = (-(-h // 8) * 8, -(-w // 8) * 8)
        a8, b8 = embed_to_shape(a, hw8), embed_to_shape(b, hw8)
        call_ms(infer_k, a8, b8)
        seq.append(statistics.median([call_ms(infer_k, a8, b8) for _ in range(4)]))
    print(f"ragged batch of 3 in {BOX[0]}x{BOX[1]}, {ITERS} iters: captured "
          f"median {med_r:.2f} ms/batch ({3e3 / med_r:.2f} pairs/s), live-pixel "
          f"share {live_share:.3f}; not held: the 3 pairs one by one, captured, "
          f"at their sizes padded to multiples of 8: "
          f"{' + '.join(f'{x:.2f}' for x in seq)} = {sum(seq):.2f} ms "
          f"({3e3 / sum(seq):.2f} pairs/s)")

    # where a request's time goes: stages by CUDA events, kernels and the
    # device's idle share by torch.profiler
    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    # (each sequence twice, the second printed: the first may pay the
    # allocator's growth after the graphs' captures)
    a, b = (torch.from_numpy(x).to(dev) for x in pairs[0])
    for _ in range(2):
        with torch.no_grad():
            e0 = ev()
            fm1, fm2, net, inp = encode_pair(model, a, b, cfg_k)
            e1 = ev()
            loop = prepare_loop(model, fm1, fm2, inp, cfg_k)
            e2 = ev()
            c1 = loop.coords0
            for it in range(ITERS):
                net, c1, mk = gru_step(model, cfg_k, loop, net, c1)
                if it == 2:
                    c3 = c1                    # the coords after 3 iterations
            e3 = ev()
            convex_upsample_flow(c1 - loop.coords0, mk)
            e4 = ev()
        torch.cuda.synchronize()
    stages = {"encoders": e0.elapsed_time(e1), "loop_setup": e1.elapsed_time(e2),
              "iterations": e2.elapsed_time(e3), "upsample": e3.elapsed_time(e4)}
    print("stages ms/request: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    # the BF path's stages, before any profiler session (whose hooks slow
    # the host, and the BF path waits on the host)
    for _ in range(2):
        with torch.no_grad():
            be = [ev()]
            bfm1, bfm2, bnet, binp = encode_pair(model_bf, a, b, cfg_bf)
            be.append(ev())
            bloop = prepare_loop(model_bf, bfm1, bfm2, binp, cfg_bf)
            be.append(ev())
            bc1 = bloop.coords0
            for _ in range(ITERS):
                bnet, bc1, bmk = gru_step(model_bf, cfg_bf, bloop, bnet, bc1)
            be.append(ev())
            convex_upsample_flow(bc1 - bloop.coords0, bmk.float())
            be.append(ev())
        torch.cuda.synchronize()
    print("BF stages ms/request: " + ", ".join(
        f"{k} {be[i].elapsed_time(be[i + 1]):.3f}" for i, k in enumerate(
            ("encoders", "loop_setup", "iterations", "upsample"))))

    # BF's loop set-up (prepare_loop: pyramid, bf16 rounding, the GRU's
    # fused and kernel-laid-out weights, context terms) eager and as a
    # replay of its own graph: device ms per call over 20 calls
    def bf_setup():
        with torch.no_grad():
            return prepare_loop(model_bf, bfm1, bfm2, binp, cfg_bf)

    setup_graph, _ = capture(bf_setup)
    bf_setup_ms = {"eager": _time_ms(bf_setup, 3, 20),
                   "captured": _time_ms(setup_graph.replay, 3, 20)}
    print(f"BF loop set-up: eager {bf_setup_ms['eager']:.3f} ms/call, "
          f"captured {bf_setup_ms['captured']:.3f} ms/replay")
    del setup_graph
    # the fresh outputs every captured call returns: the clone of the f32
    # main path's RAFTOutput (flow, flow_lr, iters_used), device ms per call
    out_m = infer_k.graphs(model, *pairs[0])
    clone_parts = {k: list(t.shape) for k, t in out_m._asdict().items()
                   if t is not None}
    clone_bytes = sum(t.numel() * t.element_size() for t in out_m if t is not None)
    clone_ms = _time_ms(lambda: [None if t is None else t.clone() for t in out_m],
                        3, 50)
    print(f"captured call's output clone at {H_IMG}x{W_IMG}: {clone_parts}, "
          f"{clone_bytes} bytes, {clone_ms:.4f} ms/call")
    # the two paths of the tile-body lookups and their MMA_RATIO threshold:
    # per call with the tiles sent by their boxes at MMA_RATIO (and the
    # share of tiles that took the MMA path, per level), every tile on the
    # MMA path, every tile on the gather, and by box at other ratios.  The
    # first and the packed lookups on the same inputs (the window lookup
    # beside them in float32), on three kinds of coords: phase 3's noisy
    # ones, the scattered ones, and this request's own (flow 0 at the first
    # iteration, coherent; after 3 and after 12 the random weights' flows
    # of hundreds of pixels).  The ragged lookup likewise on phase 3's box and
    # on the ragged batch's own coords, the first lookup beside it on the
    # same inputs.  Each in float32 and bfloat16.
    ratios = (0.0625, 0.125, 0.25, 0.5, 1.0)

    def paths(label, call, nlev, bound, extra=""):
        st = torch.zeros(2 * nlev, dtype=torch.int32, device=dev)
        call(None, st)
        per = st.view(nlev, 2).tolist()
        share = sum(m for m, _ in per) / max(sum(m + g for m, g in per), 1)
        t = {x: _time_ms(lambda: call(x, None), 3, 20)
             for x in (None, float("inf"), 0.0) + ratios}
        print(f"{label}: {t[None]:.4f} ms/call by box (MMA-path share of tiles "
              f"{share:.3f}; MMA/all tiles by level "
              + " ".join(f"{m}/{m + g}" for m, g in per)
              + f"); every tile MMA {t[float('inf')]:.4f}, every tile gather "
              f"{t[0.0]:.4f}; by box at ratio "
              + ", ".join(f"{x:g}: {t[x]:.4f}" for x in ratios)
              + f"; bound {bound[0]:.4f} ms by {bound[1]}{extra}")

    def max_flow(cc):
        return float((cc - coords_grid(*cc.shape[:3], device=dev)).abs().max())

    with torch.no_grad():                        # the ragged batch's own coords
        rsz = torch.from_numpy(sizes).to(dev)
        rt1, rt2 = (mask_ragged_rows(torch.from_numpy(x).to(dev), rsz)
                    for x in (rim1, rim2))
        rfm1, rfm2, rnet, rinp = encode_pair(model, rt1, rt2, cfg_k)
        rloop = prepare_loop(model, rfm1, rfm2, rinp, cfg_k, rsz // 8)
        rc, rcs = rloop.coords0, [rloop.coords0]
        for it in range(ITERS):
            rnet, rc, _ = gru_step(model, cfg_k, rloop, rnet, rc)
            if it in (2, ITERS - 1):
                rcs.append(rc.contiguous())
    rmf1, rmlev = lookup_operands(rfm1.permute(0, 2, 3, 1), rfm2.permute(0, 2, 3, 1),
                                  L, "highest", rsz // 8)
    mf1 = fm1.permute(0, 2, 3, 1).contiguous()
    mlev = [lv.contiguous() for lv in fmap2_pyramid(fm2.permute(0, 2, 3, 1).contiguous(), L)]
    for dt in (torch.float32, torch.bfloat16):
        tag = " bf16" if dt == torch.bfloat16 else ""
        for label, f1_, lvs, cc in (
                ("phase 3 noisy", fmap1, levels, coords),
                ("phase 3 scattered", fmap1, levels, wild),
                ("main path, first iteration", mf1, mlev, loop.coords0),
                ("main path, after 3 iterations", mf1, mlev, c3.contiguous()),
                ("main path, after 12 iterations", mf1, mlev, c1.contiguous())):
            a_, l_ = f1_.to(dt), [x.to(dt) for x in lvs]
            bound = _corr_bound(a_, l_, cc, r)
            extra = ""
            if dt == torch.float32:
                extra = (f"; corr_window {_time_ms(lambda: corr_cuda.corr_window_cuda(a_, l_, cc, r), 3, 20):.4f}")
            paths(f"corr_lookup{tag} on {label} (max|flow| {max_flow(cc):.1f})",
                  lambda x, st: corr_cuda.corr_lookup_cuda(a_, l_, cc, r, mma_ratio=x,
                                                           stats=st), L, bound, extra)
            paths(f"corr_packed{tag} on {label}, levels {first}-{L - 1} narrow",
                  lambda x, st: corr_cuda.corr_packed_cuda(a_, l_, cc, r, "all",
                                                           mma_ratio=x, stats=st),
                  L, bound)
            # each narrow level alone: level l's windows are those of level
            # 0 at coords / 2^l (a power of 2: the same floors and fractions)
            alone = []
            for lvl in range(first, L):
                cl = (cc / 2 ** lvl).contiguous()
                t = [_time_ms(lambda: corr_cuda.corr_lookup_cuda(
                    a_, [l_[lvl]], cl, r, mma_ratio=x), 3, 20)
                    for x in (None, float("inf"), 0.0)]
                alone.append(f"level {lvl} " + "/".join(f"{v:.4f}" for v in t))
            print(f"  its narrow levels alone, ms by box / every tile MMA / "
                  f"every tile gather: {', '.join(alone)}")
        for label, f1_, lvs, cc in (
                ("phase 3 noisy", rf1, rlevels, rcoords),
                ("phase 3 scattered", rf1, rlevels, rwild),
                ("ragged batch, first iteration", rmf1, rmlev, rcs[0]),
                ("ragged batch, after 3 iterations", rmf1, rmlev, rcs[1]),
                ("ragged batch, after 12 iterations", rmf1, rmlev, rcs[2])):
            a_, l_ = f1_.to(dt), [x.to(dt) for x in lvs]
            b1_ms = _time_ms(lambda: corr_cuda.corr_lookup_cuda(a_, l_, cc, r), 3, 20)
            paths(f"corr_ragged{tag} [3,{hb},{wb},256] on {label} (max|flow| "
                  f"{max_flow(cc):.1f})",
                  lambda x, st: corr_cuda.corr_ragged_cuda(a_, l_, cc, sizes8, r,
                                                           mma_ratio=x, stats=st),
                  L, rag_bound(a_, l_, cc), f"; corr_lookup on the same inputs {b1_ms:.4f}")
    # the new paths of 6i-6k, each captured and eager in turns (one warm-up
    # call each, then 5 turns): converge beside the fixed policy's graph and
    # converge:0 (which runs every iteration as 12 replays, each with a
    # flag read: its excess over the fixed graph per iteration is a replay
    # launch, the flag read and the masked freeze's copies); the stream
    # steps beside the pairwise request; the batch step beside 3 solo steps
    def timed_turns(calls, n=5):
        for f in calls.values():
            f()
        ms = {k: [] for k in calls}
        for _ in range(n):
            for k, f in calls.items():
                s0 = ev()
                f()
                s1 = ev()
                torch.cuda.synchronize()
                ms[k].append(s0.elapsed_time(s1))
        return {k: statistics.median(v) for k, v in ms.items()}

    # the flag read alone: a 1-byte device-to-host read after a tiny kernel,
    # less the same kernels with one sync at the end (host clock, 200 each)
    flag = torch.zeros(1, dtype=torch.bool, device=dev)

    def flips(read):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            flag.logical_not_()
            if read:
                bool(flag)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 200

    flips(True)
    flag_read_ms = statistics.median(flips(True) - flips(False) for _ in range(5))
    print(f"flag read: {flag_read_ms:.4f} ms per read (a 1-byte device-to-host "
          f"read and the sync it waits for, beside the same kernels unread)")
    conv_ms = {}
    for label, (fn_f, fn_0, fn_c, fn_6, cfg_c, mdl, maxu) in conv_fns.items():
        run_c = eager_fn(cfg_c, ITERS)
        med = timed_turns({
            "fixed": lambda: fn_f(mdl, im1_2, im2_2),
            "converge0": lambda: fn_0(mdl, im1_2, im2_2),
            "converge": lambda: fn_c(mdl, im1_2, im2_2),
            "converge_6": lambda: fn_6(mdl, im1_2, im2_2),
            "converge_eager": lambda: run_c(mdl, im1_2, im2_2)})
        med["iters_used_max"] = maxu
        med["flag_read_ms"] = flag_read_ms
        med["converge0_excess_ms_per_iteration"] = (
            med["converge0"] - med["fixed"]) / ITERS
        conv_ms[label] = med
        print(f"e2e converge {label}, batch of 2, captured: fixed {med['fixed']:.2f} "
              f"ms, converge:0 {med['converge0']:.2f} ({ITERS} iteration replays, "
              f"{med['converge0_excess_ms_per_iteration']:.4f} ms more per "
              f"iteration: a replay launch, its flag read ({flag_read_ms:.4f}) "
              f"and the masked freeze's copies), converge {med['converge']:.2f} "
              f"(max(iters_used) {maxu} of {ITERS}: {med['converge'] / med['fixed']:.3f} "
              f"of the fixed request), every row stopped at {ITERS // 2} "
              f"{med['converge_6']:.2f} "
              f"({med['converge_6'] / med['fixed']:.3f}); eager converge "
              f"{med['converge_eager']:.2f}")
    stream_ms = {}
    for label, paths_ in stream_fns.items():
        stream_ms[label] = {}
        for kind, (fn, run, args, mdl) in paths_.items():
            med = timed_turns({"captured": lambda: fn(mdl, *args),
                               "eager": lambda: run(*args)})
            stream_ms[label][kind] = med
            print(f"e2e stream {kind} {label}: captured {med['captured']:.2f} ms, "
                  f"eager {med['eager']:.2f}")
        pair_ms = cap_med["bf" if label == "bf" else "main"]
        st = stream_ms[label]["step"]["captured"]
        print(f"e2e stream {label}: a solo step {st:.2f} ms against the pairwise "
              f"request's {pair_ms:.2f} (captured); the batch of 4 slots (3 real) "
              f"{stream_ms[label]['batch']['captured']:.2f} against 3 solo steps "
              f"{3 * st:.2f}")
    rest_ms = {}
    for key, (fn_x, run_x) in rest_fns.items():
        rest_ms[key] = timed_turns({"captured": lambda: fn_x(model, *pairs[0]),
                                    "eager": lambda: run_x(model, *pairs[0])}, n=3)
        print(f"e2e {key}: captured {rest_ms[key]['captured']:.2f} ms, eager "
              f"{rest_ms[key]['eager']:.2f}")
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, plural, n, run, top=6):
        """(idle share, busy ms per call) over ``n`` calls of ``run``: 1 -
        kernels' busy time / the events' window (the profiler's hooks slow
        the host, so an eager path's share is overstated), and the busy
        time; (None, 0.0) if the profiler saw no device time.  Prints the
        ``top`` kernels."""
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
        idle = 1 - busy / window if busy > 0 else None
        print(f"profiler: {n} {plural}, {window:.2f} ms window, kernels busy "
              f"{busy:.2f} ms, device idle share "
              f"{'not measured (no device time seen)' if idle is None else f'{idle:.3f}'}")
        for k in sorted(kern, key=lambda k: -k.self_device_time_total)[:top]:
            print(f"  {k.self_device_time_total / (n * 1e3):8.3f} ms/{label} "
                  f"{k.count / n:6.1f} launches/{label}  {k.key[:90]}")
        return idle, busy / n

    # the idle share under the profiler, and 1 - busy / the unprofiled
    # median latency of the same path (what the host leaves idle when no
    # profiler slows it)
    idle = {"captured": {}, "eager": {}}
    idle_of_median = {"captured": {}, "eager": {}}
    for key, fn, run, mdl, reqs, per_call in e2e_paths:
        if key in ("window", "p32_all", "p32_window", "bf16corr_ctx_gru_win"):
            continue
        # raft-small and the dense paths: their captured breakdown only
        hows = ((("captured", fn),) if key.startswith(("small", "dense"))
                else (("captured", fn), ("eager", run)))
        for how, f in hows:
            it_reqs = iter(reqs * 2)
            idle[how][key], busy_ms = profiled(
                f"{how} {key} call", f"{how} {key} calls", 2,
                lambda: f(mdl, *next(it_reqs)))
            med = (cap_med if how == "captured" else eag_med)[key]
            idle_of_median[how][key] = 1 - busy_ms / med
            print(f"  {how} {key}: busy {busy_ms:.2f} ms per call, 1 - busy / "
                  f"median latency {med:.2f} = {idle_of_median[how][key]:.3f}")
    # why cudnn.benchmark is on: the motion encoder's convc2 at batch 3 and
    # about the ragged box's grid, by cuDNN's heuristic choice and
    # benchmarked.  Plans are cached by shape whatever the mode, so each
    # mode gets a grid no earlier call used.
    conv = model.update_block.encoder.convc2
    cudnn_ms = {}
    with torch.no_grad():
        for bench, w in ((False, wb + 4), (True, wb + 8)):
            x = torch.randn(3, conv.in_channels, hb, w, device=dev).contiguous(
                memory_format=torch.channels_last)
            torch.backends.cudnn.benchmark = bench
            cudnn_ms[bench] = (w, _time_ms(lambda: conv(x), 1, 2))
    torch.backends.cudnn.benchmark = True
    print(f"cuDNN FP32 conv {conv.in_channels}->{conv.out_channels} 3x3, "
          f"batch 3: heuristic choice at {hb}x{cudnn_ms[False][0]} "
          f"{cudnn_ms[False][1]:.3f} ms/call, benchmark mode at "
          f"{hb}x{cudnn_ms[True][0]} {cudnn_ms[True][1]:.3f} ms/call")
    def both(key):
        return {"captured": cap_med[key], "eager": eag_med[key]}

    wall_s = time.perf_counter() - t_start
    print(f"chip_smoke wall time {wall_s:.1f} s")
    print(json.dumps({"e2e": {"latency_ms_median": med_k, "pairs_per_s": 1e3 / med_k,
                              "latency_ms_all": lat_k, "plain_latency_ms_median": med_p,
                              "plain_pairs_per_s": 1e3 / med_p,
                              "window_latency_ms_median": cap_med["window"],
                              "p32_all_latency_ms_median": cap_med["p32_all"],
                              "p32_window_latency_ms_median": cap_med["p32_window"],
                              "bf_latency_ms_median": cap_med["bf"],
                              "bf16corr_ctx_gru_latency_ms_median":
                                  cap_med["bf16corr_ctx_gru"],
                              "bf16corr_ctx_gru_win_latency_ms_median":
                                  cap_med["bf16corr_ctx_gru_win"],
                              "ragged_batch_ms_median": med_r,
                              "ragged_pairs_per_s": 3e3 / med_r,
                              "ragged_batch_ms_all": cap_all["ragged"],
                              "ragged_bf16_batch_ms_median": cap_med["ragged_bf16"],
                              "ragged_live_pixel_share": live_share,
                              "one_by_one_ms": seq,
                              "captured_latency_ms_median": cap_med,
                              "eager_latency_ms_median": eag_med,
                              "captured_latency_ms_all": cap_all,
                              "eager_latency_ms_all": eag_all,
                              "idle_share": idle,
                              "idle_share_of_median": idle_of_median,
                              "small_latency_ms_median": {
                                  "f32": both("small"), "bf16": both("small_bf16")},
                              "dense_latency_ms_median": {
                                  "raft_things": both("dense"),
                                  "raft_small": both("dense_small")},
                              "dense_pyramid_mb": pyramid_mb,
                              "graph_pool_mib": pool_mib,
                              "bf_loop_setup_ms": bf_setup_ms,
                              "converge_latency_ms_median": conv_ms,
                              "stream_step_latency_ms_median": {
                                  k: v["step"] for k, v in stream_ms.items()},
                              "stream_batch_latency_ms_median": {
                                  k: {kind: v[kind] for kind in
                                      ("batch", "int8", "ragged")}
                                  for k, v in stream_ms.items()},
                              "blockwise_gather_latency_ms_median":
                                  rest_ms["blockwise_gather"],
                              "unhoisted_latency_ms_median": rest_ms["unhoisted"],
                              "output_clone_ms": clone_ms,
                              "wall_s": wall_s}}))

    def entry(name, source, replaces, runs, err, ms, plain_ms, bound, by):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None}

    print(f"device: {smi}")
    print(json.dumps({"kernels": [
        entry("corr_lookup", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:349",
              launches["corr_lookup"] + launches_s["corr_lookup"]
              + new_launches["f32"].get("corr_lookup", 0),
              corr_err, corr_ms, corr_plain_ms, corr_bound, corr_by),
        entry("sep_conv_gru", "raft_tpu_torch/csrc/sep_conv_gru.cu",
              "raft_tpu/ops/gru_pallas.py:242",
              launches["sep_conv_gru"] + new_launches["f32"].get("sep_conv_gru", 0),
              gru_err, gru_ms, gru_plain_ms, gru_bound_ms, gru_by),
        entry("corr_window", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:342", launches_w["corr_window"],
              win_err, win_ms, win_plain_ms, corr_bound, corr_by),
        entry("corr_ragged", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:604",
              launches_r["corr_ragged"] + new_launches["f32"].get("corr_ragged", 0),
              rag_err, rag_ms, rag_plain_ms, rag_bound_ms, rag_by),
        entry("corr_packed", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:125",
              launches_p32["all"]["corr_packed"] + launches_p32["window"]["corr_packed"],
              pack_err, pk["all"], pk["all_plain"], corr_bound, corr_by),
    ] + [entry(f"{name}_bf16", f"raft_tpu_torch/csrc/{src}", replaces, runs,
               bf_err[name], bf_ms[name][0], bf_ms[name][1], *bf_ms[name][2])
         for name, src, replaces, runs in (
             ("corr_lookup", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:349",
              launches_bfc["corr_lookup"] + launches_sb["corr_lookup"]),
             ("corr_window", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:342",
              launches_bfw["corr_window"]),
             ("corr_packed", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:125",
              launches_bf["corr_packed"] + new_launches["bf16"].get("corr_packed", 0)),
             ("corr_ragged", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:604",
              launches_rbf["corr_ragged"] + new_launches["bf16"].get("corr_ragged", 0)),
             ("sep_conv_gru", "sep_conv_gru.cu", "raft_tpu/ops/gru_pallas.py:242",
              launches_bf["sep_conv_gru"] + launches_bfc["sep_conv_gru"]
              + launches_bfw["sep_conv_gru"] + launches_rbf["sep_conv_gru"]
              + new_launches["bf16"].get("sep_conv_gru", 0)))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
