#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is not 0:

1. device: CUDA must be available; prints the card's name and power limit
   (nvidia-smi).  TF32 is switched off for matmuls and cuDNN, so every
   comparison below is float32 end to end; cuDNN runs in benchmark mode.
2. build: compiles the three kernel sources of raft_tpu_torch/csrc (nvcc,
   one process each, all started together, into build/raft_tpu_torch/) and
   prints the build time and ptxas's report.
3. kernels vs plain, at the main paths' shapes, each held to its plain
   PyTorch version at rtol = atol = 1e-5: the correlation lookup on a
   [1, 54, 128, 256] query map and its 4-level pyramid (coords with noise
   of +-(r+3) px and a share of queries wholly outside the map); the
   window-scheduled lookup on the same inputs (also held to the first
   lookup's output) and on windows scattered over the whole map; the
   ragged lookup on a [3, 55, 156, 256] max box with live sizes8
   [[54, 128], [46, 155], [48, 64]], on both kinds of coords (live queries
   held, dead ones exactly 0); the SepConvGRU at 54x128, 2x37x45 and
   2x23x70 (no tile divides the last two).  The packed lookup (pallas_pack=True, one launch over
   every level, the narrow ones staged in whole rows) under 'all' and
   'window' on the [1, 54, 128, 256] maps (levels 1-3 narrow) with both
   kinds of coords and on a FlyingChairs-width [1, 48, 64, 256] map (every
   level narrow), each against its plain version and against the first
   lookup's output; a 0x0 level gives exact zeros.  The bfloat16 instantiations
   (corr_precision='default' operands) of the four lookups against their
   plain versions on the same bfloat16 operands at 1e-5, and the
   bfloat16-I/O GRU against its plain version within 1 bf16 ulp of max|h|
   (both compute in float32 and round once: a sum that lands at a rounding
   boundary may round the other way), at all three GRU shapes.  The first
   lookup, both entries, also on scattered windows, on a quarter of the
   queries scattered among coherent ones, with the left half of the grid
   wholly off the map, at radius 15 and at C = 100; each case held with
   its tiles sent by their window boxes, all on the MMA path and all on
   the gather (the share of tiles on each path printed).
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
7. times (CUDA events, after warm-up): each kernel per call beside its
   plain version and its bound — the packed lookup beside the first and
   the window lookups on the same inputs, each bfloat16
   instantiation beside its float32 kernel; the first lookup's two paths
   and its MMA_RATIO threshold on phase 3's noisy and scattered coords and
   on the main path's own at its first iteration, after 3 and after 12; median request latency and
   pairs/s of the main, window, P32 and BF paths; the ragged batch's median
   and pairs/s beside the three pairs run one by one (printed, not held).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  No single PyTorch call computes any of the
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

import json
import statistics
import subprocess
import sys

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
                extra_bytes=0):
    """(bound ms, by) of a lookup on these inputs: f1, the levels and
    coords read once (and ``extra_bytes``), the output written once;
    2 FLOPs per channel of each in-map window position (``positions``,
    counted from ``coords`` when None), float32 x float32 products or, for
    bfloat16 operands, bfloat16 x bfloat16 ones, and 7 FP32 FLOPs per
    bilinear output (``n_out``, every query's when None)."""
    out_numel = coords.numel() // 2 * len(levels) * (2 * radius + 1) ** 2
    n_out = out_numel if n_out is None else n_out
    if positions is None:
        positions = _corr_positions(
            coords, [(x.shape[1], x.shape[2]) for x in levels], radius)
    nbytes = (f1.element_size() * (f1.numel() + sum(x.numel() for x in levels))
              + 4 * (coords.numel() + out_numel) + extra_bytes)
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
                                         lookup_packed_plain,
                                         lookup_ragged_plain,
                                         lookup_window_plain, mask_ragged_rows,
                                         packed_levels_from)
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
    fmap1, levels, coords, wild = (k_in[k] for k in ("fmap1", "levels", "coords", "wild"))
    corr_k = corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r)
    corr_p = lookup_blockwise_onehot(fmap1, levels, coords, r)
    corr_err = _compare("corr_lookup [1,54,128,256] L=4 r=4", corr_k, corr_p)
    win_k = corr_cuda.corr_window_cuda(fmap1, levels, coords, r)
    win_err = _compare("corr_window [1,54,128,256] L=4 r=4", win_k,
                       lookup_window_plain(fmap1, levels, coords, r))
    _compare("corr_window against corr_lookup's output", win_k, corr_k)
    # windows scattered over the whole map, as random-weight flows give:
    # the kernel reads f2 from global memory instead of staging a box
    win_err = max(win_err, _compare(
        "corr_window, windows scattered over the map",
        corr_cuda.corr_window_cuda(fmap1, levels, wild, r),
        lookup_window_plain(fmap1, levels, wild, r)))

    hb, wb = BOX[0] // 8, BOX[1] // 8
    sizes8, rf1, rlevels, rcoords, rwild = (
        k_in[k] for k in ("sizes8", "rf1", "rlevels", "rcoords", "rwild"))
    rag_k = corr_cuda.corr_ragged_cuda(rf1, rlevels, rcoords, sizes8, r)
    rag_p = lookup_ragged_plain(rf1, rlevels, rcoords, sizes8, r)
    live8 = live_mask(sizes8, hb, wb)
    rag_err = _compare(f"corr_ragged [3,{hb},{wb},256] sizes8 "
                       f"{sizes8.tolist()} live queries", rag_k[live8], rag_p[live8])
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

    nn_ = (2 * r + 1) ** 2
    first = packed_levels_from([lv.shape[2] for lv in levels])   # 1 at 54x128
    pack_err = 0.0
    for ps in ("all", "window"):
        for label, cc in (("noisy", coords), ("scattered", wild)):
            pack_err = max(pack_err, _compare(
                f"corr_packed {ps} [1,54,128,256] levels {first}-{L - 1} "
                f"narrow, {label} coords",
                corr_cuda.corr_packed_cuda(fmap1, levels, cc, r, ps),
                lookup_packed_plain(fmap1, levels, cc, r, ps)))
        _compare(f"corr_packed {ps} against corr_lookup's output",
                 corr_cuda.corr_packed_cuda(fmap1, levels, coords, r, ps), corr_k)
    hc, wc = 384 // 8, 512 // 8                  # FlyingChairs: W_0 = 64 packs
    cf1 = dev_t(rng5.randn(1, hc, wc, C))
    clevels = [lv.contiguous() for lv in fmap2_pyramid(dev_t(rng5.randn(1, hc, wc, C)), L)]
    ccoords = noisy_coords5(1, hc, wc)
    if packed_levels_from([lv.shape[2] for lv in clevels]) != 0:
        raise AssertionError("the FlyingChairs-width map should pack at level 0")
    for ps in ("all", "window"):
        got = corr_cuda.corr_packed_cuda(cf1, clevels, ccoords, r, ps)
        pack_err = max(pack_err, _compare(
            f"corr_packed {ps} [1,{hc},{wc},256] every level narrow", got,
            lookup_packed_plain(cf1, clevels, ccoords, r, ps)))
        _compare(f"corr_packed {ps} [1,{hc},{wc},256] against corr_lookup's output",
                 got, corr_cuda.corr_lookup_cuda(cf1, clevels, ccoords, r))

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
        "corr_window": _compare(
            "corr_window bf16 [1,54,128,256]",
            corr_cuda.corr_window_cuda(bf1, blevels, coords, r),
            lookup_window_plain(bf1, blevels, coords, r)),
        "corr_packed": max(_compare(
            f"corr_packed {ps} bf16 [1,54,128,256]",
            corr_cuda.corr_packed_cuda(bf1, blevels, coords, r, ps),
            lookup_packed_plain(bf1, blevels, coords, r, ps))
            for ps in ("all", "window"))}
    rbf1, rblevels = rf1.bfloat16(), [lv.bfloat16() for lv in rlevels]
    bf_err["corr_ragged"] = _compare(
        "corr_ragged bf16 [3,55,156,256] live queries",
        corr_cuda.corr_ragged_cuda(rbf1, rblevels, rcoords, sizes8, r)[live8],
        lookup_ragged_plain(rbf1, rblevels, rcoords, sizes8, r)[live8])
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
        want_ = lookup_blockwise_onehot(f1_, lvs, cc, rr)
        worst_ = 0.0
        for how, ratio in (("by box", None), ("MMA", float("inf")), ("gather", 0.0)):
            st = torch.zeros(2, dtype=torch.int32, device=dev)
            got_ = corr_cuda.corr_lookup_cuda(f1_, lvs, cc, rr, mma_ratio=ratio, stats=st)
            worst_ = max(worst_, _compare(
                f"corr_lookup {label}, tiles {how} (MMA/gather {st.tolist()})",
                got_, want_))
        return worst_

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
            "corr_packed": 0,
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
    launches_p32, infer_p32 = {}, {}
    for ps in ("all", "window"):
        cfg_pk = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                                 pallas_pack=True, pallas_p_select=ps)
        infer_p32[ps] = make_inference_fn(cfg_pk, iters=ITERS)
        launches_p32[ps] = drive(
            f"P32 path, p_select={ps!r}: {N_WINDOW} requests at "
            f"{H_IMG}x{W_IMG}, {ITERS} iters", infer_p32[ps], model,
            pairs[:N_WINDOW], {"corr_packed": n_it,
                               "sep_conv_gru": n_it * gru_per_iter})
        with torch.no_grad():
            for i, (a, b) in enumerate(pairs[:N_WINDOW]):
                worst = step_parity(cfg_pk, cfg_p, torch.from_numpy(a).to(dev),
                                    torch.from_numpy(b).to(dev))
                e2e = _within("3 iterations end to end",
                              make_inference_fn(cfg_pk, iters=3)(model, a, b),
                              make_inference_fn(cfg_p, iters=3)(model, a, b))
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
    infer_bf = make_inference_fn(cfg_bf, iters=ITERS)
    launches_bf = drive(
        f"BF path: {N_WINDOW} requests at {H_IMG}x{W_IMG}, {ITERS} iters",
        infer_bf, model_bf, pairs[:N_WINDOW],
        {"corr_packed": n_it, "sep_conv_gru": n_it * gru_per_iter})
    cfg_bfc = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              compute_dtype="bfloat16", corr_precision="default")
    infer_bfc = make_inference_fn(cfg_bfc, iters=ITERS)
    launches_bfc = drive(
        f"pallas-bf16corr-ctx-gru: 1 request at {H_IMG}x{W_IMG}, {ITERS} iters",
        infer_bfc, model_bf, pairs[:1],
        {"corr_lookup": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    cfg_bfw = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              compute_dtype="bfloat16", corr_precision="default",
                              pallas_p_select="window", pallas_p_blk=1024)
    launches_bfw = drive(
        f"pallas-bf16corr-ctx-gru-win: 1 request at {H_IMG}x{W_IMG}, {ITERS} iters",
        make_inference_fn(cfg_bfw, iters=ITERS), model_bf, pairs[:1],
        {"corr_window": ITERS, "sep_conv_gru": ITERS * gru_per_iter})
    cfg_pb = RAFTConfig.full(corr_impl="blockwise", corr_lookup="onehot",
                             gru_impl="xla", compute_dtype="bfloat16",
                             corr_precision="default")

    def bf16_step_parity(cfg_k, t1, t2, sizes=None, crops=None):
        """Worst (ratio, message) over the iterations of |kernel step -
        plain bf16 step| / |plain bf16 step - plain float32 step|, all three
        steps taken from the kernel path's state (the float32 step on the
        float32 model, the state upcast), on each crop."""
        sizes8 = None
        if sizes is not None:
            t1, t2 = mask_ragged_rows(t1, sizes), mask_ragged_rows(t2, sizes)
            sizes8 = sizes // 8
        fm1, fm2, net, inp = encode_pair(model_bf, t1, t2, cfg_k)
        loop_k = prepare_loop(model_bf, fm1, fm2, inp, cfg_k, sizes8)
        loop_b = prepare_loop(model_bf, fm1, fm2, inp, cfg_pb, sizes8)
        loop_f = prepare_loop(model, fm1.float(), fm2.float(), inp.float(),
                              cfg_p, sizes8)
        c0, coords1, worst = loop_k.coords0, loop_k.coords0, (0.0, "")
        if crops is None:
            crops = [(t1.shape[1], t1.shape[2])] * t1.shape[0]
        for it in range(ITERS):
            net_k, ck, mk = gru_step(model_bf, cfg_k, loop_k, net, coords1)
            _, cb, mb = gru_step(model_bf, cfg_pb, loop_b, net, coords1)
            _, cf, mf = gru_step(model, cfg_p, loop_f, net.float(), coords1)
            fk, fb, ff = (convex_upsample_flow(c - c0, m.float()) for c, m in
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
    infer_rbf = make_ragged_inference_fn(cfg_rbf, iters=ITERS)
    launches_rbf = drive(
        f"BF ragged batch of 3 in {BOX[0]}x{BOX[1]}, {ITERS} iters",
        infer_rbf, model_bf, [(rim1, rim2, sizes)],
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

    # -- 7. times ----------------------------------------------------------
    corr_ms = _time_ms(lambda: corr_cuda.corr_lookup_cuda(fmap1, levels, coords, r), 3, 50)
    corr_plain_ms = _time_ms(lambda: lookup_blockwise_onehot(fmap1, levels, coords, r), 1, 10)
    corr_bound, corr_by = _corr_bound(fmap1, levels, coords, r)

    win_ms = _time_ms(lambda: corr_cuda.corr_window_cuda(fmap1, levels, coords, r), 3, 50)
    win_plain_ms = _time_ms(lambda: lookup_window_plain(fmap1, levels, coords, r), 1, 5)

    rag_ms = _time_ms(lambda: corr_cuda.corr_ragged_cuda(rf1, rlevels, rcoords, sizes8, r), 3, 50)
    rag_plain_ms = _time_ms(lambda: lookup_ragged_plain(rf1, rlevels, rcoords, sizes8, r), 1, 5)
    rag_pos = 0
    for b, (h, w) in enumerate(sizes8.tolist()):
        clip = [(min(lv.shape[1], h >> i), min(lv.shape[2], w >> i))
                for i, lv in enumerate(rlevels)]
        rag_pos += _corr_positions(rcoords[b][live8[b]], clip, r)

    def rag_bound(f1, lvs):                      # live queries' in-crop work
        return _corr_bound(f1, lvs, rcoords, r, rag_pos,
                           int(live8.sum()) * L * nn_, 4 * sizes8.numel())

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
    med_more = {}
    for label, fn, mdl in (("P32 all", infer_p32["all"], model),
                           ("P32 window", infer_p32["window"], model),
                           ("BF", infer_bf, model_bf),
                           ("pallas-bf16corr-ctx-gru", infer_bfc, model_bf)):
        call_ms(fn, *pairs[0], mdl=mdl)
        med_more[label] = statistics.median(
            [call_ms(fn, *pairs[i % N_PAIRS], mdl=mdl) for i in range(8)])
        print(f"e2e {H_IMG}x{W_IMG} batch 1, {ITERS} iters, {label}: median "
              f"{med_more[label]:.2f} ms/request ({1e3 / med_more[label]:.2f} "
              f"pairs/s) against the float32 main path's {med_k:.2f}")

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
    # the first lookup's two paths and its threshold on three kinds of
    # coords: phase 3's noisy ones, the scattered ones, and this request's
    # own (flow 0 at the first iteration, coherent; after 3 and after 12
    # the random weights' flows of hundreds of pixels), each in float32 and
    # bfloat16: per call with the tiles sent by their boxes at MMA_RATIO
    # (and the share of tiles that took the MMA path), every tile on the
    # MMA path, every tile on the gather, and by box at other ratios; the
    # window lookup beside it in float32
    mf1 = fm1.permute(0, 2, 3, 1).contiguous()
    mlev = [lv.contiguous() for lv in fmap2_pyramid(fm2.permute(0, 2, 3, 1).contiguous(), L)]
    ratios = (0.0625, 0.125, 0.25, 0.5, 1.0)
    for dt in (torch.float32, torch.bfloat16):
        for label, f1_, lvs, cc in (
                ("phase 3 noisy", fmap1, levels, coords),
                ("phase 3 scattered", fmap1, levels, wild),
                ("main path, first iteration", mf1, mlev, loop.coords0),
                ("main path, after 3 iterations", mf1, mlev, c3.contiguous()),
                ("main path, after 12 iterations", mf1, mlev, c1.contiguous())):
            a_, l_ = f1_.to(dt), [x.to(dt) for x in lvs]
            st = torch.zeros(2, dtype=torch.int32, device=dev)
            corr_cuda.corr_lookup_cuda(a_, l_, cc, r, stats=st)
            share = st[0].item() / max(st.sum().item(), 1)
            t = {x: _time_ms(lambda: corr_cuda.corr_lookup_cuda(a_, l_, cc, r, mma_ratio=x), 3, 20)
                 for x in (None, float("inf"), 0.0) + ratios}
            bound, by = _corr_bound(a_, l_, cc, r)
            extra = ""
            if dt == torch.float32:
                extra = (f"; corr_window {_time_ms(lambda: corr_cuda.corr_window_cuda(a_, l_, cc, r), 3, 20):.4f}")
            print(f"corr_lookup{' bf16' if dt == torch.bfloat16 else ''} on {label} "
                  f"(max|flow| {float((cc - coords_grid(*cc.shape[:3], device=dev)).abs().max()):.1f}): "
                  f"{t[None]:.4f} ms/call by box at ratio {corr_cuda.MMA_RATIO[dt]} (MMA-path "
                  f"share of tiles {share:.3f}); every tile MMA {t[float('inf')]:.4f}, "
                  f"every tile gather {t[0.0]:.4f}; by box at ratio "
                  + ", ".join(f"{x:g}: {t[x]:.4f}" for x in ratios)
                  + f"; bound {bound:.4f} ms by {by}{extra}")
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
    it_pairs = iter(pairs[:2])
    profiled("BF request", "BF requests", 2,
             lambda: infer_bf(model_bf, *next(it_pairs)))
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
                              "p32_all_latency_ms_median": med_more["P32 all"],
                              "p32_window_latency_ms_median": med_more["P32 window"],
                              "bf_latency_ms_median": med_more["BF"],
                              "bf16corr_ctx_gru_latency_ms_median":
                                  med_more["pallas-bf16corr-ctx-gru"],
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

    print(f"device: {smi}")
    print(json.dumps({"kernels": [
        entry("corr_lookup", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:349", launches["corr_lookup"],
              corr_err, corr_ms, corr_plain_ms, corr_bound, corr_by),
        entry("sep_conv_gru", "raft_tpu_torch/csrc/sep_conv_gru.cu",
              "raft_tpu/ops/gru_pallas.py:242", launches["sep_conv_gru"],
              gru_err, gru_ms, gru_plain_ms, gru_bound_ms, gru_by),
        entry("corr_window", "raft_tpu_torch/csrc/corr_window.cu",
              "raft_tpu/ops/corr_pallas.py:342", launches_w["corr_window"],
              win_err, win_ms, win_plain_ms, corr_bound, corr_by),
        entry("corr_ragged", "raft_tpu_torch/csrc/corr_window.cu",
              "raft_tpu/ops/corr_pallas.py:604", launches_r["corr_ragged"],
              rag_err, rag_ms, rag_plain_ms, rag_bound_ms, rag_by),
        entry("corr_packed", "raft_tpu_torch/csrc/corr_window.cu",
              "raft_tpu/ops/corr_pallas.py:125",
              launches_p32["all"]["corr_packed"] + launches_p32["window"]["corr_packed"],
              pack_err, pk["all"], pk["all_plain"], corr_bound, corr_by),
    ] + [entry(f"{name}_bf16", f"raft_tpu_torch/csrc/{src}", replaces, runs,
               bf_err[name], bf_ms[name][0], bf_ms[name][1], *bf_ms[name][2])
         for name, src, replaces, runs in (
             ("corr_lookup", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:349",
              launches_bfc["corr_lookup"]),
             ("corr_window", "corr_window.cu", "raft_tpu/ops/corr_pallas.py:342",
              launches_bfw["corr_window"]),
             ("corr_packed", "corr_window.cu", "raft_tpu/ops/corr_pallas.py:125",
              launches_bf["corr_packed"]),
             ("corr_ragged", "corr_window.cu", "raft_tpu/ops/corr_pallas.py:604",
              launches_rbf["corr_ragged"]),
             ("sep_conv_gru", "sep_conv_gru.cu", "raft_tpu/ops/gru_pallas.py:242",
              launches_bf["sep_conv_gru"] + launches_bfc["sep_conv_gru"]
              + launches_bfw["sep_conv_gru"] + launches_rbf["sep_conv_gru"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
