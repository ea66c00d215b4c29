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
   one process each) and, beside them, phase 15's host libraries
   (jpeg.cpp, dis_flow.cpp: g++), all started together, into
   build/raft_tpu_torch/, and prints the build time and ptxas's report.
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
8. serving (``serving_phases``): the port's FlowServer on localhost (port
   0), full width, 12 iterations, fresh seeded models.  S1, the f32 main
   path with streaming (bucket 432x1024, max_batch 4, 4 sessions): the
   12-key warm grid of lint/budget.py; 8 sequential /v1/flow requests
   bitwise equal to make_inference_fn called directly on the same model;
   4 clients x 8 requests (mean device batch > 1, each device batch
   bitwise the direct call on that padded batch, each response its row);
   3 /v1/stream sessions x 4 frames advanced together (mean step width >
   1, fnet cache hits == advances, each advance its row of the engine's
   batch step, the slot pool's addresses unchanged across commits and a
   reset); /admin/reload of seed-1 weights while one client sends
   requests (version 2, no capture, each response meanwhile the old or
   the new weights' flow, their latency recorded; the next response
   bitwise the direct call on them); no serve-time capture.
   S2, BF with ragged=True over the Sintel, KITTI and FlyingChairs
   buckets (box 440x1248): 9 sequential and 3 clients x 6 mixed requests,
   each device batch bitwise make_ragged_inference_fn on it, each
   response its unpadded row, no serve-time capture.  Then the timings,
   2 windows of 2.5 s each (hundreds of requests): the HTTP median at one
   client beside the captured factory's (the serving overhead), pairs/s
   and the mean device batch with several clients, S1's stream advances
   from 3 sessions; warmup seconds, the graph pools and peak allocated
   memory.  Every device batch size served (pair or ragged batch, S1's
   batch steps from the pool rows they gathered) has its kernels held to
   the plain step at that batch from its own features, as in phases 4 and
   6c, and every kept batch bitwise to the direct call.  Both hold their
   launch counts (the warmup's captures, the probe thread's warm-up
   forward at warmup and the reload's probe; replays
   launch from the graph, uncounted, and are reported apart), which join
   the kernels' record.  A failing client first prints what ROADMAP's
   fault C4 asks for (the clock, the live threads, the accept queues).

9. training (``training_phases``, run right after phase 2, before any
   profiler session): the chairs stage
   (``TrainConfig.for_stage('chairs')``: batch 10, 368x496, AdamW, lr
   4e-4, weight decay 1e-4, one-cycle, clip 1.0), ``remat_iters`` on, TF32
   off, on C1 weights (6d) held as float32 masters, fed by the port's
   synthetic dataset at 368x496 (samples made by 8 threads) through
   ``PrefetchLoader``, in two configurations: f32 main
   (``RAFTConfig.full(corr_impl='pallas', gru_impl='pallas', iters=12)``,
   B1 and B2) and BF (pallas-bf16corr-ctx-gru-winpack under
   ``compute_dtype='bfloat16'``, B5-bf16 and B2-bf16).  For each: the
   captured step (``training/capture.py``, what the loop runs on CUDA)
   first, 2 warm-up calls (the first captures) and 3 timed replays, then
   the eager step in the same process, 2 + 3 the same way; every loss
   finite; the launch counters read the capture's two steps (its warm-up
   and the captured step; a replay counts none) and 5 eager steps
   (corr_lookup 24 and sep_conv_gru 96 a step in f32, corr_packed 24 and
   sep_conv_gru 96 in BF, also over one eager BF step alone: each
   iteration's forward and its recompute under remat; the backward runs
   the plain twins' vjp, no kernel); every BN statistic moved, the masters
   float32; ms a step (min-max), samples/s, each side's profiled idle
   share, peak allocated memory, one capture and the graph pool's MiB;
   one replay against one eager step from one state and batch,
   deterministic algorithms on: loss, gradient norm and every parameter,
   moment and statistic bitwise (else within phase 9's gradient bounds,
   the reason printed); 6 captured steps on one fixed batch (the chairs
   lr held constant) lower its loss; freeze_bn (statistics bitwise,
   affines moved, masters float32) through a captured step; a NaN batch
   through the captured step skipped (params, moments, statistics
   bitwise, notfinite_count + 1).  f32 alone: at 3 iterations the
   gradients of the kernel path against the plain path
   (``corr_impl='blockwise'``, 'onehot', ``gru_impl='xla'``) under 'all',
   'window', ``pallas_pack=True`` and for raft-small (r = 3): each leaf
   within 3e-2 of its L2 norm, the whole gradient within 1e-2, a bias
   feeding a normalization (exact gradient 0) below 1e-5 of the largest
   |g| (tests/torch_train_parity.py says why not elementwise); a checkpoint
   at step k restored into a fresh model and optimizer, the eager step
   k+1 bitwise equal to the uninterrupted one (deterministic algorithms
   on); the forward / backward split, the twins' backward alone per
   iteration (lookup and GRU, bound: their products at the FP32 rate),
   the peak with remat off, 3 eager steps after the profiler; B1, B2,
   B5-bf16 and B2-bf16 each held to its plain version at the training
   shapes (batch 10, 46x62 at 1/8; 1e-5, the bf16 GRU within 1 bf16 ulp).
   BF alone: at 3 iterations its bf16 gradients against the plain path's
   in bf16, each leaf within twice the plain path's own bf16-vs-f32
   distance (L2); a checkpoint of the captured bf16 run at step k
   restored into a fresh state, its captured step k+1 bitwise the
   uninterrupted one.  ``python -m raft_tpu_torch.training`` (raft-small,
   64x96, the captured step), once in the default float32 and once with
   ``--dtype bfloat16``, the two side by side, sent SIGTERM exits 17 with
   a readable checkpoint, and a rerun resumes it.  The captures
   of the phase equal its keys (no key captured twice); the phase's
   seconds are printed.  Its launches join the kernels' record
   (``train_launches`` in each row).
10. data and evaluation (``data_phases``, right after phase 9): fabricated
   trees in a temporary directory, written with the port's own writers
   from seeded numpy at the datasets' frame sizes (FlyingChairs 24 pairs
   at 384x512, one Sintel scene of 6 frames at 436x1024, KITTI 2 pairs at
   375x1242 and 2 at 370x1224).  The chairs stage as ``python -m
   raft_tpu_torch.training --dataset chairs --data ROOT --workers 4``
   builds it (``MPSampleLoader``, 4 workers, shm), with the host
   augmentor and then with ``--device-aug``: 2 warm-up and 3 timed steps
   each, every loss finite, corr_lookup 24 and sep_conv_gru 96 launches a
   step.  The device augmentor on a decoded batch of 10, card against
   CPU on the same ``params_from_host`` params, within 1e-4 x (1 +
   max|value|) (a resize on the card may round otherwise).  A worker
   SIGKILLed mid-stream under each transport: respawns 1, 10 more samples
   within 60 s.  Evaluation of ``RAFTConfig.full(corr_impl='pallas',
   gru_impl='pallas')`` (32 iterations, C1 weights): Sintel with the warm
   start (bucket 8), KITTI at bucket 64, pixel weighting, batches of 2;
   both launch B1 and B2 in every iteration, their metrics are finite and
   equal those of direct eval-step calls on the same padded inputs in the
   harness's order and batches (each Sintel pair's EPE from its dumped
   .flo; KITTI's dumped 16-bit PNGs within 1/64 px of the direct flows,
   clipped to the format's range); the kernels at each evaluation shape
   and batch held to the plain step (``hold_eval``): Sintel's cold start
   and first warm start at 440x1024 (batch 1, from the seed the harness
   gave) and both KITTI batches of 2 at 384x1280, every one of the 32
   iterations from the same state at phase 4's bound; ``-m val`` on the Sintel tree
   (``--max-samples 2``) exits 0.  Times: PNG decode per frame, loader
   samples/s at 1, 2 and 4 workers per transport, device augmentation
   per batch, the steps and data waits, evaluation per pair (a second,
   warm pass).  Its launches join the kernels' record.
12. the parallel layer (``parallel_phases``, after phase 11): two ranks
   of one gloo process group, both on cuda:0 (the device passed
   explicitly; every CUDA tensor staged through the host and counted),
   started by ``raft_tpu_torch/parallel/launch.py``, while this process
   computes the single-process references.  (a) The ring lookup on the
   1/8 maps of 512x1024 (C = 256, 4 levels, r = 4, 32 rows a rank), with
   phase 3's kind of coordinates and with scattered ones: for B1, B3 and
   B5, f32 and bf16, each slab's kernel partial on the shifted
   coordinates against its plain twin with each tile path forced (MMA,
   gather), and each ring sum against the kernel on the whole maps, both
   at rtol = atol = 1e-5; a ring call launches its kernel twice a rank;
   ms a call a rank, the bytes staged and the collectives' ms.  (b)
   raft-things f32 (``corr_impl='pallas'``, ``gru_impl='xla'``, C1
   weights) row-sharded at 1x1024x1920: each of 3 iterations against the
   single-process forward at phase 4's bound; at 12 iterations the median
   ms a rank, the collectives' and staging's share and each rank's peak
   beside the single-process peak; then one rank over NCCL at 512x1024,
   held the same way.  (c) The chairs stage's data-parallel step, 5
   samples a rank: at 3 iterations (as phase 9.2 holds gradients) the
   loss and gradients at phase 9's bounds and the synchronized
   batch-norm statistics at 1e-5 against one single-process eager step
   on the whole batch from the same state, the ranks' updates bitwise
   equal; then the stage at 12 iterations: corr_lookup 24 and
   sep_conv_gru 96 launches a step, 3 timed steps, the gradient
   all-reduce's ms.  (d) ``make_dp_eval_fn`` over [cuda:0, cuda:0] at
   2x432x1024 against the factory's batch of 2 at phase 4's bound (3
   iterations), then timed at 12.  (e) On a one-card machine ``-m test --spatial 2``
   exits 2 ("needs 2 devices") and an engine with ``dp_devices=2``
   raises.  (f) The row-sharded train step (``make_pjit_train_step(
   spatial_axis='spatial')``, dp 1 x sp 2 over the two gloo ranks):
   raft-things f32 (the B1 ring, remat on, AdamW, C1 weights) at
   2x512x1024, at 3 iterations under ``gru_impl='xla'`` and ``'pallas'``
   (B2 on the halo'd slab) against one single-process eager step on the
   whole batch from the same state: the loss at 1e-5 relative, the
   gradient at phase 9's bounds, the BN statistics at 1e-5, the ranks'
   updated states bitwise equal; the ring's backward alone on (a)'s maps
   (B1, B3, B5, f32): each rank's gradients of its f1 and f2 slabs
   against the whole-map kernel's vjp at rtol = atol = 1e-5; B2 on a
   halo'd slab against the whole-image B2 call and the plain twin at
   1e-5; at 12 iterations (corr_lookup 48 and sep_conv_gru 96 launches a
   rank a step: the forward and the remat recompute) 2 timed steps a
   rank, the collectives' and staging's share (forward and backward
   apart), the peak a rank, beside the single process's step.  (g) On
   the NCCL rank, ``make_dp_train_step`` (batch 2 at 368x496), the dp x
   sp step (batch 2 at 384x496) at 3 iterations and
   ``make_shard_inference_fn`` (512x1024) each captured as one CUDA
   graph, the collectives recorded in it counted (> 0), the replay
   bitwise equal to the eager call; one rank issues no P2P (printed, not
   covered).  The ``parallel`` JSON line; its launches join the kernels'
   record (B1, B3, B5 and their bf16 entries; B2 from (c), (d) and (f)).
13. the fleet (``fleet_phases``, after phase 12): ``python -m
   raft_tpu_torch.cli -m serve_fleet`` of f32 main (432x1024, 12
   iterations, batch 1, streaming on), every replica a process of its own
   on this card, booting through one ``--engine-cache-dir``: (a) a cold
   fleet of 2 from a copy of the package with no ``build/`` (replica 0
   builds the kernels and writes the entries), (b) a warm fleet of 2 from
   another such copy (every key a hit, no compiler run), (c) routed pairs
   bitwise each replica's own answer and held to this process's captured
   call (bitwise when its probe digest is the entry's), (d) a rolling
   reload under load (no failure, every answer the old or the new
   weights' flow, no serve-time capture), (e) a stream session's replica
   SIGKILLed (the session migrates; the respawn boots from the cache), (f)
   pairs/s through the router at 4 clients with 2 replicas and with 1,
   the router's HTTP median beside a replica's, the card's memory.  The
   ``fleet`` JSON line; the replicas' launches (their ``/metrics``) join
   B1's and B2's records.
14. the lint's checks on the card (``lint_phases``, after phase 13): (a)
   every kernel entry's launch envelope, float32 and bfloat16 at the main
   path's shapes and raft-small's: the Python mirror
   (``lint/budget.py::corr_envelope``, ``gru_envelopes``) equal to each
   source's ``extern "C"`` ``*_envelope`` query (dynamic shared bytes,
   threads, launch bounds) and to ``cudaFuncGetAttributes`` (static shared
   bytes, registers equal to ``ptxas``'s), the blocks an SM holds equal to
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, no entry over the
   H100's per-block or per-SM limits; (b) the graph pools priced from fake
   tensors (a subprocess started before the build) against the measured
   ones, S1's (phase 8) and the f32 chairs step's (phase 9), within 20%;
   (c) with contract checking on, one captured raft-small request and one
   eager train step raise nothing, a wrong shape raises ContractError;
   (d) the span accounting of a closed loop at 8 clients on raft-small at
   32x48 (serve_bench's smoke server): spans cover >= 95% of a request on
   average and >= 75% each.  The ``lint`` JSON line.
15. 8b, the host codec and the classical flow (``host_phases``, after
   phase 14; nothing on the card: the card's host has no libjpeg and no
   OpenCV, which these modules replace): a seeded 436x1024 BGR frame made
   with numpy alone (``host_jpeg_frame``) through the port's JPEG encoder
   at qualities 70, 85, 95 and 99 and back through its decoder, the sha256
   of each file and of each decoded frame equal to the constants a CPU
   test ties to cv2's output (``JPEG_SHA256``); ``calc_flow`` (DIS at
   PRESET_MEDIUM + the guided filter) on a seeded textured pair at
   436x1024 translated by (2.3, -1.7) px, its interior EPE within
   ``DIS_EPE_BOUND`` (0.05 px; 0.0342 px on the CPU test host), the flows'
   sha256 printed beside the CPU test host's (not gated); the JPEG round
   trip's and calc_flow's ms with the card's name and power limit; the
   phase, the two host builds included, within 8 s.  The ``host`` JSON
   line.

Before the last lines the serving, train, data, cli, parallel, fleet, lint,
host and e2e JSON records (PERF.md §2
says what each key means); the line before the last is the kernels' JSON record; the
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
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
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
T_START = time.perf_counter()   # the script's clock (fault reports)
STALL_S = 10.0               # phase 8: no answer for this long dumps stacks
SERVE_WINDOW_S = 2.5         # phase 8: a timing window's seconds
_CONNS = threading.local()   # _http's keep-alive connections, per thread


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


# -- 8. serving: the port's FlowServer on the card ----------------------------

def _http(url: str, body: bytes = b"", ctype: str = "application/octet-stream",
          timeout: float = 60.0, headers: dict = None):
    """POST ``body`` (GET when None) and return (status, body bytes);
    with ``headers`` (a dict) the response's headers are put in it.  A
    status of 400 or more raises ``urllib.error.HTTPError``.

    Each thread keeps one HTTP/1.1 connection per server open across its
    calls, as a load generator's client does, until :func:`_drop_conns`
    (or the thread's end) closes them.  With a new connection per request
    (thousands in the timed windows) a connect was seen to go unanswered
    for 60 s while the server sat idle in ``select`` with an empty accept
    queue (ROADMAP's fault C4)."""
    import http.client
    import urllib.error
    import urllib.parse
    u = urllib.parse.urlsplit(url)
    conns = _CONNS.__dict__.setdefault("by_server", {})
    conn = conns.get(u.netloc)
    if conn is None:
        conn = conns[u.netloc] = http.client.HTTPConnection(
            u.hostname, u.port, timeout=timeout)
    try:
        conn.request("GET" if body is None else "POST",
                     u.path + (f"?{u.query}" if u.query else ""), body=body,
                     headers={"Content-Type": ctype,
                              "Accept": "application/octet-stream"})
        r = conn.getresponse()
        data = r.read()
    except BaseException:
        conns.pop(u.netloc).close()
        raise
    if r.will_close:
        conns.pop(u.netloc).close()
    if r.status >= 400:
        raise urllib.error.HTTPError(url, r.status, r.reason, r.headers, None)
    if headers is not None:
        headers.update(r.headers.items())
    return r.status, data


def _drop_conns() -> None:
    """Close the calling thread's connections of :func:`_http` (a server's
    ``server_close`` waits for the handler thread of each open one)."""
    for conn in _CONNS.__dict__.pop("by_server", {}).values():
        conn.close()


def _npz(**arrays) -> bytes:
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unnpz(body: bytes) -> dict:
    import io
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no {name}")


def _graph_pool_mib(graphed):
    """MiB of the CUDA graph memory pools of ``graphed`` (``GraphedForward``s
    or None: the factories' graphs, a captured train step), summed over
    their segments in the allocator's snapshot; None when the snapshot
    does not name segment pools."""
    pools = {tuple(g.pool) for g in graphed
             if g is not None and g.pool is not None}
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) in pools) / 2 ** 20


def _client_fault_report(err: BaseException) -> None:
    """What ROADMAP's fault C4 (a client's connect to the localhost server
    timing out) asks to record when a client fails, on standard error: the
    script's clock, every live thread's innermost frames, and each
    listening TCP socket's accept queue (``/proc/net/tcp``: a full queue
    means the server stopped accepting; an empty one, that the connect was
    lost elsewhere)."""
    import traceback

    def say(line):
        print(f"client fault: {line}", file=sys.stderr, flush=True)
    say(f"at {time.perf_counter() - T_START:.1f} s of the script: {err!r}")
    frames = sys._current_frames()
    for th in threading.enumerate():
        fr = frames.get(th.ident)
        where = (" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno} "
                             f"{f.name}" for f in
                             reversed(traceback.extract_stack(fr)[-4:]))
                 if fr is not None else "?")
        say(f"thread {th.name}: {where}")
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            rows = open(table).read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            f = row.split()
            if f[3] == "0A":                        # LISTEN
                tx, rx = f[4].split(":")
                say(f"{table} listening port {int(f[1].split(':')[1], 16)}: "
                    f"accept queue {int(rx, 16)}")


def _clients(n: int, work):
    """Run ``work(i)`` on ``n`` threads at once; returns the results in
    order, re-raising the first failure (reported first by
    :func:`_client_fault_report`); every thread joined."""
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = work(i)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            _client_fault_report(e)
            errors.append(e)
        finally:
            _drop_conns()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        if t.is_alive():
            raise AssertionError("a client thread did not finish in 300 s")
    if errors:
        raise errors[0]
    return out


def _watch(engine, name: str, keep, before=None) -> dict:
    """Wrap ``engine.<name>`` (called with the bucket, then a batch): count
    its calls in ``calls`` and keep ``keep(args, kw, out, pre)`` in ``kept``
    for every call while ``keep_all`` is set, else for the first call at
    each batch size not kept yet; ``pre = before(args, kw)`` is taken just
    before a call that is kept."""
    st = {"calls": 0, "kept": [], "sizes": set(), "keep_all": True}
    orig = getattr(engine, name)

    def wrapped(*args, **kw):
        b = args[1].shape[0]
        take = keep is not None and (st["keep_all"] or b not in st["sizes"])
        pre = before(args, kw) if take and before is not None else None
        out = orig(*args, **kw)
        st["calls"] += 1
        if take:
            st["sizes"].add(b)
            st["kept"].append(keep(args, kw, out, pre))
        return out
    setattr(engine, name, wrapped)
    return st


def _windows(n_clients: int, request, calls=None, n_win: int = 2,
             secs: float = SERVE_WINDOW_S):
    """``n_clients`` clients, each calling ``request(c, i)`` (returns its
    ms) back to back, over ``n_win`` windows of ``secs`` seconds each.
    Per window: requests, requests/s (requests over the time until the
    last one returned), their median, p90 and largest ms and, with
    ``calls`` (a _watch record of the device entry they reach), the device
    calls and the mean device batch (requests per call).  Returns
    (windows, every latency).

    While a window runs, ``faulthandler``'s watchdog (a C thread, so it
    runs even when another thread holds the interpreter lock) is re-armed
    by every answered request: when no request has been answered for
    STALL_S seconds it dumps every thread's stack on standard error, while
    the stall lasts (ROADMAP's fault C4)."""
    import faulthandler
    out, every = [], []
    for _ in range(n_win):
        c0 = calls["calls"] if calls is not None else 0
        t0 = time.perf_counter()
        end = t0 + secs

        def client(c):
            lat, i = [], 0
            while time.perf_counter() < end:
                lat.append(request(c, i))
                faulthandler.dump_traceback_later(STALL_S, repeat=True)
                i += 1
            return lat
        faulthandler.dump_traceback_later(STALL_S, repeat=True)
        try:
            lats = [ms for x in _clients(n_clients, client) for ms in x]
        finally:
            faulthandler.cancel_dump_traceback_later()
        dt = time.perf_counter() - t0
        rec = {"requests": len(lats), "s": dt, "per_s": len(lats) / dt,
               "ms_median": statistics.median(lats),
               "ms_p90": float(np.percentile(lats, 90)),
               "ms_max": max(lats)}
        if calls is not None:
            rec["device_calls"] = calls["calls"] - c0
            rec["mean_device_batch"] = len(lats) / rec["device_calls"]
        out.append(rec)
        every += lats
    return out, every


def _spread(wins, key):
    """[min, median, max] of ``key`` over the windows."""
    vals = [w[key] for w in wins]
    return [min(vals), statistics.median(vals), max(vals)]


def tools_substep(url: str, watches, frame, iters: int) -> dict:
    """Phase 8's tools sub-step: S1 driven in-process through the port's
    load generator (``raft_tpu_torch.tools.serve_bench``): the closed loop
    (8 clients, 24 requests), the open loop (24 Poisson arrivals at half
    the closed loop's pairs/s) and the video arm (2 lockstep sessions of 4
    frames).  Gates: every answer 200, the closed loop's mean device batch
    above 1, no capture (``finish`` holds it right after); the device
    batches the engine ran are kept by phase 8's ``_watch`` records
    (``watches``, whose calls count the device calls) and held to the plain
    step with the others.  Returns the ``tools``
    record: pairs/s, latency, device calls and the kernels those calls ran
    (graph replays: corr_lookup ``iters`` and sep_conv_gru ``iters *
    LAUNCHES_PER_CALL`` a call)."""
    from raft_tpu_torch.ops import gru_cuda
    from raft_tpu_torch.tools import serve_bench as sb

    host, port = url.split("//")[1].split(":")
    port = int(port)
    t0 = time.perf_counter()
    body = _npz(image1=frame(H_IMG, W_IMG), image2=frame(H_IMG, W_IMG))
    rec, calls = {}, {}

    def arm(name, run):
        c0 = sum(w["calls"] for w in watches)
        results, elapsed = run()
        calls[name] = sum(w["calls"] for w in watches) - c0
        bad = {st for st, _ in results if st != 200}
        if bad or not results:
            raise AssertionError(f"tools {name}: statuses {sorted(bad)} "
                                 f"({len(results)} answers)")
        lat = sorted(ms * 1e3 for _, ms in results)
        rec[name] = {"answers": len(results), "s": elapsed,
                     "pairs_per_s": len(results) / elapsed,
                     "ms_median": statistics.median(lat),
                     "ms_p90": float(np.percentile(lat, 90)),
                     "device_calls": calls[name],
                     "mean_device_batch": len(results) / calls[name]}
        return rec[name]

    closed = arm("closed", lambda: sb.run_closed(host, port, body, 8, 24))
    if not closed["mean_device_batch"] > 1:
        raise AssertionError(f"tools closed loop: mean device batch "
                             f"{closed['mean_device_batch']:.2f} (must be "
                             f"> 1)")
    rate = closed["pairs_per_s"] / 2
    arm("open", lambda: sb.run_open(host, port, body, 8, 24, rate, seed=0))
    rec["open"]["rate"] = rate
    seqs = [sb.make_session_frames(H_IMG, W_IMG, 4, seed=100 + i)
            for i in range(2)]
    arm("video", lambda: sb.run_video(host, port, seqs, stream=True))
    n = sum(calls.values())
    rec["device_calls"] = n
    rec["launches_by_replay"] = {
        "corr_lookup": n * iters,
        "sep_conv_gru": n * iters * gru_cuda.LAUNCHES_PER_CALL}
    rec["s"] = time.perf_counter() - t0
    print(f"tools sub-step (raft_tpu_torch.tools.serve_bench on S1): closed "
          f"{closed['pairs_per_s']:.2f} pairs/s, mean device batch "
          f"{closed['mean_device_batch']:.2f}; open at {rate:.2f}/s "
          f"{rec['open']['pairs_per_s']:.2f} pairs/s, median "
          f"{rec['open']['ms_median']:.1f} ms; video 2 x 3 advances "
          f"{rec['video']['pairs_per_s']:.2f} pairs/s, mean step width "
          f"{rec['video']['mean_device_batch']:.2f}; {n} device calls; "
          f"{rec['s']:.1f} s")
    return rec


def serving_phases(dev, kernels, iters: int, frame_rng, hold_pair,
                   hold_step) -> dict:
    """Phase 8: the port's FlowServer (``raft_tpu_torch.serving``) on the
    card, at full width and ``iters`` iterations on seeded random weights,
    two servers on localhost (port 0), each stopped in ``finally``.

    S1, f32 main (corr_impl='pallas', gru_impl='pallas'), bucket
    432x1024, max_batch 4, 4 sessions: the 12-key warm grid; (a) 8
    sequential /v1/flow requests, each bitwise equal to make_inference_fn
    called directly at batch 1 on the same model; (b) 4 clients x 8
    requests: mean device batch > 1, every device batch (kept by a wrapper
    around engine.run) bitwise equal to the direct call on that padded
    batch, every response equal to its row; (c) no serve-time capture; (d)
    3 /v1/stream sessions x 4 frames advanced together: mean step width >
    1, fnet cache hits == advances, each advance equal to its row of the
    engine's batch step, the slot pool's addresses unchanged across
    commits and a reset; (e) /admin/reload of seed-1 weights: version 2,
    no capture, the next response bitwise equal to the direct call on a
    model holding those weights.  S2, BF (the bench's
    pallas-bf16corr-ctx-gru-winpack) with ragged=True, buckets 440x1024,
    376x1248 and 384x512 (max box 440x1248), max_batch 4: Sintel, KITTI
    and FlyingChairs requests, sequential then from 3 clients, held as
    (a)-(c) against make_ragged_inference_fn on each batch the engine ran.

    After the checks, the timings: 2 windows of 2.5 s at one client and at
    several (and, in S1, of 3 sessions streaming), each request a frame
    pair of its own client's 8 encoded anew; the device batches of sizes
    the checks had not run are kept too.  Then the kernels of every
    device batch size that was served (``hold_pair``; S1's batch steps
    ``hold_step``, from the pool rows they gathered) are held against the
    plain step from the same state, at that batch and on its own frames,
    and every kept batch is held bitwise to the direct call.

    Kernel launches are counted from the server's start: the warmup's
    captures (each an eager warm-up and the captured forward) and the
    reload's eager probe; a replay launches from the graph and is not
    counted (the replays are counted apart, as the kernels they run).
    The direct calls and the parity runs run after the counts are read."""
    from raft_tpu_torch import (RAFTConfig, embed_to_shape, init_raft_torch,
                                make_inference_fn, make_ragged_inference_fn)
    from raft_tpu_torch.convert.weights import save_params_npz
    from raft_tpu_torch.data.pipeline import pad_to_shape
    from raft_tpu_torch.lint.budget import enumerate_warmup_grid
    from raft_tpu_torch.ops import gru_cuda
    from raft_tpu_torch.serving import FlowServer, ServeConfig
    from raft_tpu_torch.serving.session import buffer_tensors

    def frame(h, w):
        return frame_rng.rand(h, w, 3).astype(np.float32)

    def start(label, cfg, model, sc):
        _reset(*kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reserved0 = torch.cuda.memory_reserved()
        allocated0 = torch.cuda.memory_allocated() / 2 ** 20
        server = FlowServer(cfg, model, sc, iters=iters)
        server.start()
        eng = server.engine
        grid = enumerate_warmup_grid(eng.config, sc)
        if eng.keys() != sorted(grid) or eng.executables != len(grid):
            raise AssertionError(f"{label}: warm keys {eng.keys()} are not "
                                 f"the grid {grid}")
        warm = {"keys": len(grid), "warmup_s": eng.warmup_seconds,
                "captures": eng.captures(), "graphs": eng.graph_count(),
                "graph_pool_mib": _graph_pool_mib(
                    f.graphs for f in eng._factories),
                "reserved_mib": (torch.cuda.memory_reserved() - reserved0)
                / 2 ** 20, "allocated_before_mib": allocated0}
        print(f"{label}: warmed {len(grid)} keys in {warm['warmup_s']:.2f} s "
              f"({warm['captures']} captures, {warm['graphs']} graphs; graph "
              f"pools {warm['graph_pool_mib']} MiB, reserved "
              f"+{warm['reserved_mib']:.0f} MiB): {grid}")
        return server, warm

    spans_ms = []           # the server's spans of each /v1/flow response

    def flow_call(url, im1, im2):
        head = {}
        t0 = time.perf_counter()
        body = _npz(image1=im1, image2=im2)
        t1 = time.perf_counter()
        _, body = _http(url + "/v1/flow", body, headers=head)
        t2 = time.perf_counter()
        flow = _unnpz(body)["flow"]
        t3 = time.perf_counter()
        ms = (t3 - t0) * 1e3
        spans_ms.append(dict(json.loads(head["X-Raft-Timings"]), total=ms,
                             client_npz=(t1 - t0 + t3 - t2) * 1e3))
        if not np.isfinite(flow).all():
            raise AssertionError("a served flow is not finite")
        return flow, ms

    def span_medians(calls):
        """Median ms over ``calls`` (a slice of spans_ms) of each server
        span (from admission to the flow on the host), of the client's npz
        encode and decode, and of the rest of the client's wall time: the
        HTTP transfer both ways, the server's npz decode and checks of the
        request and its npz encode of the response."""
        names = [k for k in calls[0] if k != "total"]
        med = {k: statistics.median(c.get(k, 0.0) for c in calls)
               for k in names}
        top = [k for k in names if not k.startswith("execute_")]
        med["transfer_and_server_npz"] = statistics.median(
            c["total"] - sum(c.get(k, 0.0) for k in top) for c in calls)
        return med

    def timed_flows(url, pools, st):
        """The 1-client and the len(pools)-client windows of /v1/flow, each
        client cycling over its own frame pairs; the 1-client spans."""
        n0 = len(spans_ms)
        one, lat1 = _windows(1, lambda c, i: flow_call(
            url, *pools[0][i % len(pools[0])])[1], st)
        spans = span_medians(spans_ms[n0:])
        many, _ = _windows(len(pools), lambda c, i: flow_call(
            url, *pools[c][i % len(pools[c])])[1], st)
        return one, statistics.median(lat1), spans, many

    def factory_ms(fn, model, inputs, rounds=5):
        out = []
        for _ in range(rounds):
            for args in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(model, *args)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def check_batches(label, kept, direct):
        for i, (args, out) in enumerate(kept):
            want = direct(args).cpu().numpy()
            if not np.array_equal(out, want):
                raise AssertionError(
                    f"{label}: device batch {i} (batch {out.shape[0]}) is "
                    f"not bitwise the direct call, max|diff| "
                    f"{float(np.abs(out - want).max()):.3g}")

    def first_of_each_size(kept):
        out = {}
        for args, res in kept:
            out.setdefault(args[0].shape[0], args)
        return [out[b] for b in sorted(out)]

    def finish(label, server, warm):
        eng = server.engine
        if eng.compile_misses or eng.captures() != warm["captures"]:
            raise AssertionError(
                f"{label}: {eng.compile_misses} serve-time misses, captures "
                f"{warm['captures']} -> {eng.captures()}")
        text = _http(server.url + "/metrics", None)[1].decode()
        if _metric(text, "raft_serving_compile_cache_misses_total") != 0:
            raise AssertionError(f"{label}: /metrics counts a miss")
        torch.cuda.synchronize()
        return text

    def report(wins):
        return {"windows": wins, "per_s": _spread(wins, "per_s"),
                "mean_device_batch": _spread(wins, "mean_device_batch"),
                "ms_median": _spread(wins, "ms_median")}

    rec = {}
    # -- S1: f32 main, with streaming ----------------------------------------
    cfg1 = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    model1 = init_raft_torch(cfg1, generator=torch.Generator().manual_seed(0),
                             device=dev)
    sc1 = ServeConfig(buckets=((H_IMG, W_IMG),), max_batch=4, max_sessions=4,
                      port=0, default_deadline_ms=60_000.0)
    bucket1 = (H_IMG, W_IMG)
    server, warm1 = start("S1 f32 main", cfg1, model1, sc1)
    try:
        eng = server.engine
        url = server.url

        def pool_rows(a, kw):
            """The pool rows a batch step is about to gather: (fmap, cnet,
            warm-start seed) at its slots."""
            with eng._device_lock:
                sl = torch.as_tensor(np.asarray(a[2], np.int64), device=dev)
                return tuple(t.index_select(0, sl)
                             for t in eng.pool.buffers(a[0]))
        pairs_st = _watch(eng, "run", lambda a, kw, out, pre: (
            (a[1].copy(), a[2].copy()), np.array(out)))
        steps_st = _watch(eng, "run_stream_batch", lambda a, kw, out, pre: {
            "images": a[1].copy(), "active": np.asarray(a[3]).copy(),
            "flow": np.array(out[0]), "fmap_cur": out[2], "rows": pre},
            before=pool_rows)
        solo_st = _watch(eng, "run_stream", None)
        # (a) sequential
        seq = [(frame(H_IMG, W_IMG), frame(H_IMG, W_IMG)) for _ in range(8)]
        seq_out = [flow_call(url, a, b)[0] for a, b in seq]
        # (b) 4 clients x 8 requests, every pair its own frames
        n_seq = len(pairs_st["kept"])
        conc = [[(frame(H_IMG, W_IMG), frame(H_IMG, W_IMG)) for _ in range(8)]
                for _ in range(4)]
        conc_out = _clients(4, lambda c: [flow_call(url, a, b)[0]
                                          for a, b in conc[c]])
        conc_batches = pairs_st["kept"][n_seq:]
        mean_batch = 32 / len(conc_batches)
        # (d) 3 sessions x 4 frames, advanced together round by round
        barrier = threading.Barrier(3)
        vids = [[frame(H_IMG, W_IMG) for _ in range(4)] for _ in range(3)]
        pool0 = [t.data_ptr() for t in buffer_tensors(eng.pool.buffers(
            bucket1))]

        def open_session(image):
            _, body = _http(url + "/v1/stream", _npz(image=image))
            return str(_unnpz(body)["session"])

        def advance(sid, image):
            t0 = time.perf_counter()
            _, body = _http(url + "/v1/stream",
                            _npz(image=image, session=np.asarray(sid)))
            r = _unnpz(body)
            return r, (time.perf_counter() - t0) * 1e3

        def close(sid):
            _http(url + "/v1/stream", _npz(op=np.asarray("close"),
                                           session=np.asarray(sid)))

        def session(s):
            sid = open_session(vids[s][0])
            out = []
            for k in range(1, 4):
                barrier.wait(120)
                r, ms = advance(sid, vids[s][k])
                if not bool(r["warm"]) or int(r["frame"]) != k:
                    raise AssertionError(f"S1 session {s} frame {k}: not warm")
                out.append(r["flow"])
            close(sid)
            return out
        stream_out = _clients(3, session)
        kept_steps = list(steps_st["kept"])
        advances = sum(len(x) for x in stream_out)
        rows = sum(int(k["active"].sum()) for k in kept_steps)
        width = rows / len(kept_steps)
        pool1 = [t.data_ptr() for t in buffer_tensors(eng.pool.buffers(
            bucket1))]
        eng.reset_slots(bucket1)
        pool2 = [t.data_ptr() for t in buffer_tensors(eng.pool.buffers(
            bucket1))]
        for s in range(3):
            for k in range(1, 4):
                got = stream_out[s][k - 1]
                for step in kept_steps:
                    hit = [j for j in range(int(step["active"].sum()))
                           if np.array_equal(step["images"][j], vids[s][k])]
                    if hit:
                        if not np.array_equal(got, step["flow"][hit[0]]):
                            raise AssertionError(f"S1 session {s} frame {k}: "
                                                 f"not its engine row")
                        break
                else:
                    raise AssertionError(f"S1 session {s} frame {k}: in no "
                                         f"batch step")
        text = _http(url + "/metrics", None)[1].decode()
        hits = _metric(text, "raft_stream_fnet_cache_hits_total")
        if hits != advances or rows != advances:
            raise AssertionError(f"S1 streams: fnet cache hits {hits}, rows "
                                 f"{rows}, advances {advances}")
        if not width > 1 or not mean_batch > 1:
            raise AssertionError(f"S1: mean step width {width:.2f}, mean "
                                 f"device batch {mean_batch:.2f} (both must "
                                 f"be > 1)")
        if not pool0 == pool1 == pool2:
            raise AssertionError("S1: the slot pool's buffers moved")

        # the timings: from here only batches of sizes not kept yet are kept
        pairs_st["keep_all"] = steps_st["keep_all"] = False
        pools = [[(frame(H_IMG, W_IMG), frame(H_IMG, W_IMG)) for _ in range(8)]
                 for _ in range(4)]
        one1, http_ms, spans1, four1 = timed_flows(url, pools, pairs_st)
        svids = [[frame(H_IMG, W_IMG) for _ in range(8)] for _ in range(3)]
        sids = [open_session(v[0]) for v in svids]
        hits0 = _metric(_http(url + "/metrics", None)[1].decode(),
                        "raft_stream_fnet_cache_hits_total")

        def stream_request(c, i):
            r, ms = advance(sids[c], svids[c][(i + 1) % len(svids[c])])
            if not bool(r["warm"]) or not np.isfinite(r["flow"]).all():
                raise AssertionError(f"S1 session {c}: a cold or non-finite "
                                     f"advance")
            return ms
        stream1, adv_lat = _windows(3, stream_request, steps_st)
        for sid in sids:
            close(sid)
        text = _http(url + "/metrics", None)[1].decode()
        timed_adv = sum(w["requests"] for w in stream1)
        if _metric(text, "raft_stream_fnet_cache_hits_total") - hits0 != timed_adv:
            raise AssertionError("S1 timed streams: fnet cache hits are not "
                                 "the advances")
        adv_ms = statistics.median(adv_lat)
        for w in stream1:
            w["mean_step_width"] = w.pop("mean_device_batch")
        tools_rec = tools_substep(url, (pairs_st, steps_st, solo_st), frame,
                                  iters)
        finish("S1", server, warm1)
        served = _launches(*kernels)

        # the direct calls (a) and (b) are held to, on the same model
        # object before the reload changes its weights, and the kernels at
        # every served batch size; their launches (captures of the direct
        # factory, eager parity runs) are left out of the counts
        direct = make_inference_fn(cfg1, iters=iters, device=dev)
        for i, ((a, b), got) in enumerate(zip(seq, seq_out)):
            want = direct(model1, a[None], b[None])[0].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"S1 (a) request {i}: not bitwise the "
                                     f"direct call")
        check_batches("S1 served", pairs_st["kept"],
                      lambda ims: direct(model1, *ims))
        for c in range(4):
            for (a, b), got in zip(conc[c], conc_out[c]):
                for (ims, out) in conc_batches:
                    hit = [j for j in range(ims[0].shape[0])
                           if np.array_equal(ims[0][j], a)]
                    if hit:
                        if not np.array_equal(got, out[hit[0]]):
                            raise AssertionError("S1 (b): a response is not "
                                                 "its row of the batch")
                        break
                else:
                    raise AssertionError("S1 (b): a request in no batch")
        held1 = []
        for ims in first_of_each_size(pairs_st["kept"]):
            hold_pair("S1 served pair batch", cfg1, model1, *ims)
            held1.append(("pair", ims[0].shape[0]))
        step_widths = {}
        for step in steps_st["kept"]:
            step_widths.setdefault(step["images"].shape[0], step)
        for b in sorted(step_widths):
            fm, cn, seed = step_widths[b]["rows"]
            hold_step(f"S1 served stream batch step (real rows "
                      f"{int(step_widths[b]['active'].sum())})", cfg1, model1,
                      fm, step_widths[b]["fmap_cur"], cn, seed)
            held1.append(("sbatch", b))
        factory1 = factory_ms(direct, model1, [(a[None], b[None])
                                               for a, b in seq])
        torch.cuda.synchronize()
        compared = _launches(*kernels)
        # (e) reload a second seeded weight set, while one client sends
        # requests one after another: the batches' latency across a reload
        # (each of those responses is the old or the new weights' flow)
        model1b = init_raft_torch(cfg1, generator=torch.Generator().manual_seed(1),
                                  device=dev)
        import copy
        import io
        model1_old = copy.deepcopy(model1)   # the reload overwrites model1
        buf = io.BytesIO()
        save_params_npz(model1b.state_dict(), buf)
        reloaded = {}

        def push():
            t0 = time.perf_counter()
            try:
                reloaded["body"] = _http(url + "/admin/reload",
                                         buf.getvalue())[1]
            finally:
                _drop_conns()
            reloaded["s"] = time.perf_counter() - t0

        class TimedLock:
            """The engine's device lock with each hold logged: (thread,
            s waited, s held)."""

            def __init__(self, lock):
                self.lock, self.log = lock, []

            def __enter__(self):
                t0 = time.perf_counter()
                self.lock.__enter__()
                self.t = (t0, time.perf_counter())
                return self

            def __exit__(self, *exc):
                t0, t1 = self.t
                self.log.append((threading.current_thread().name, t1 - t0,
                                 time.perf_counter() - t1))
                return self.lock.__exit__(*exc)

        timed = TimedLock(eng._device_lock)
        eng._device_lock = timed
        pusher = threading.Thread(target=push, name="reload-client")
        try:
            pusher.start()
            during = []
            while pusher.is_alive() and len(during) < 200:
                ims = (frame(H_IMG, W_IMG), frame(H_IMG, W_IMG))
                during.append((ims, *flow_call(url, *ims)))
                during[-1] += (spans_ms[-1],)
            pusher.join(300)
        finally:
            eng._device_lock = timed.lock
        if pusher.is_alive() or "body" not in reloaded:
            raise AssertionError("S1 reload: /admin/reload did not answer")
        version = json.loads(reloaded["body"])["weights"]["version"]
        if version != 2 or eng.weight_info()["version"] != 2:
            raise AssertionError(f"S1 reload: version {version}")
        after = (frame(H_IMG, W_IMG), frame(H_IMG, W_IMG))
        after_flow, _ = flow_call(url, *after)
        finish("S1", server, warm1)
        now = _launches(*kernels)
        launches1 = {k: served[k] + now[k] - compared[k] for k in now}
        flow_replays = pairs_st["calls"] + steps_st["calls"] + solo_st["calls"]
        peak1 = torch.cuda.max_memory_allocated() / 2 ** 20
        want = direct(model1b, after[0][None], after[1][None])[0].cpu().numpy()
        if not np.array_equal(after_flow, want):
            raise AssertionError("S1 (e): the response after the reload is "
                                 "not bitwise the direct call on the new "
                                 "weights")
        for i, ((a, b), got, _, _) in enumerate(during):
            if not any(np.array_equal(got, direct(m, a[None], b[None])[0]
                                      .cpu().numpy())
                       for m in (model1_old, model1b)):
                raise AssertionError(f"S1 (e): response {i} during the "
                                     f"reload is neither weights' flow")
        del model1_old
        during_ms = [ms for _, _, ms, _ in during]
        reload_rec = {
            "reload_s": reloaded["s"], "requests_during": len(during),
            "http_ms_during": during_ms,
            "spans_ms_during": [sp for *_, sp in during],
            "device_lock_ms": [(name, wait * 1e3, held * 1e3)
                               for name, wait, held in timed.log],
            "http_ms_during_median": (statistics.median(during_ms)
                                      if during_ms else None),
            "http_ms_during_max": max(during_ms, default=None)}
        # each captured key's eager warm-up and capture, the probe
        # thread's warm-up forward at warmup, the reload's probe
        captured_flow = 7                        # pair x3, stream, sbatch x3
        want1 = {"corr_lookup": (2 * captured_flow + 2) * iters,
                 "sep_conv_gru": (2 * captured_flow + 2) * iters
                 * gru_cuda.LAUNCHES_PER_CALL}
        got1 = {k: v for k, v in launches1.items() if v}
        if got1 != want1 or warm1["captures"] != 8:
            raise AssertionError(f"S1 launches {got1} != {want1} (captures "
                                 f"{warm1['captures']})")
        replayed1 = {"corr_lookup": flow_replays * iters,
                     "sep_conv_gru": flow_replays * iters
                     * gru_cuda.LAUNCHES_PER_CALL}
        rec["s1"] = {
            "warmup_s": warm1["warmup_s"], "keys": warm1["keys"],
            "captures": warm1["captures"],
            "graph_pool_mib": warm1["graph_pool_mib"],
            "warmup_reserved_mib": warm1["reserved_mib"],
            "allocated_before_mib": warm1["allocated_before_mib"],
            "peak_allocated_mib": peak1,
            "http_ms_median_1_client": http_ms,
            "factory_ms_median": factory1,
            "serving_overhead_ms": http_ms - factory1,
            "spans_ms_median_1_client": spans1,
            "one_client": report(one1),
            "four_clients": report(four1),
            "mean_device_batch_4x8_check": mean_batch,
            "stream_advance_ms_median": adv_ms,
            "streams_3_sessions": {
                "windows": stream1,
                "advances_per_s": _spread(stream1, "per_s"),
                "mean_step_width": _spread(stream1, "mean_step_width")},
            "stream_mean_step_width_check": width,
            "stream_advances_check": advances, "fnet_cache_hits_check": hits,
            "held_batches": held1,
            "weight_version": version, "reload": reload_rec,
            "launches": got1,
            "tools": tools_rec,
            "flow_graph_replays": flow_replays,
            "launches_by_replay": replayed1,
            "compile_hits": eng.compile_hits}
        print(f"S1 f32 main: (a) 8 sequential requests bitwise the direct "
              f"call; (b) 4 clients x 8: mean device batch {mean_batch:.2f}, "
              f"every batch bitwise the direct call, every response its row; "
              f"(c) 0 serve-time captures; (d) 3 sessions x 4 frames: "
              f"{advances} advances warm, mean step width {width:.2f}, pool "
              f"addresses unchanged; (e) reload -> version 2, no capture, "
              f"bitwise the new weights; during the reload's "
              f"{reloaded['s'] * 1e3:.0f} ms, {len(during)} requests, each "
              f"the old or the new weights' flow, HTTP "
              f"{reload_rec['http_ms_during_median']} ms median, "
              f"{reload_rec['http_ms_during_max']} ms max (one client "
              f"{http_ms:.2f} ms median), their spans "
              f"{reload_rec['spans_ms_during']}, the device lock's holds "
              f"(thread, ms waited, ms held) {reload_rec['device_lock_ms']}; "
              f"kernels held at the served batches "
              f"{held1}; launches at capture + probe warm-up + probe "
              f"{got1}, by "
              f"{flow_replays} graph replays {replayed1}; peak allocated "
              f"{peak1:.0f} MiB")
        print(f"S1 timings, 2 windows of {SERVE_WINDOW_S:g} s each: 1 client "
              f"{sum(w['requests'] for w in one1)} requests, HTTP median "
              f"{http_ms:.2f} ms vs the captured factory {factory1:.2f} ms "
              f"(serving overhead {http_ms - factory1:.2f} ms; server spans, "
              f"medians { {k: round(v, 2) for k, v in spans1.items()} }); "
              f"4 clients {sum(w['requests'] for w in four1)} requests, "
              f"pairs/s by window {[round(w['per_s'], 2) for w in four1]}, "
              f"mean device batch "
              f"{[round(w['mean_device_batch'], 2) for w in four1]}; 3 "
              f"sessions {timed_adv} advances, median {adv_ms:.2f} ms, "
              f"advances/s {[round(w['per_s'], 2) for w in stream1]}, mean "
              f"step width {[round(w['mean_step_width'], 2) for w in stream1]}")
    finally:
        _drop_conns()
        server.stop(timeout=60)
    add = {"f32": launches1}

    # -- S2: BF, ragged ------------------------------------------------------
    cfg2 = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                           compute_dtype="bfloat16", corr_precision="default",
                           pallas_pack=True, pallas_p_select="window",
                           pallas_p_blk=1024)
    model2 = init_raft_torch(cfg2, generator=torch.Generator().manual_seed(0),
                             device=dev)
    # each crop's bucket: its sides rounded up to multiples of 8; the max
    # box over them is phase 6's BOX
    sc2 = ServeConfig(buckets=tuple((-(-h // 8) * 8, -(-w // 8) * 8)
                                    for h, w in CROPS),
                      max_batch=4, max_sessions=0, ragged=True, port=0,
                      default_deadline_ms=60_000.0)
    server, warm2 = start("S2 BF ragged", cfg2, model2, sc2)
    try:
        eng = server.engine
        url = server.url
        box = sc2.max_box
        st2 = _watch(eng, "run", lambda a, kw, out, pre: (
            (a[1].copy(), a[2].copy(), np.asarray(
                a[3] if len(a) > 3 else kw["sizes"]).copy()), np.array(out)))
        # (a) sequential: a lone request is a batch of one
        seq = [(frame(*CROPS[i % 3]), frame(*CROPS[i % 3])) for i in range(9)]
        seq_out = [flow_call(url, a, b)[0] for a, b in seq]
        n_seq = len(st2["kept"])
        # (b) 3 clients x 6 mixed requests
        conc = [[(frame(*CROPS[(c + i) % 3]), frame(*CROPS[(c + i) % 3]))
                 for i in range(6)] for c in range(3)]
        conc_out = _clients(3, lambda c: [flow_call(url, a, b)[0]
                                          for a, b in conc[c]])
        mean_batch = 18 / (len(st2["kept"]) - n_seq)
        st2["keep_all"] = False
        pools = [[(frame(*CROPS[(c + i) % 3]), frame(*CROPS[(c + i) % 3]))
                  for i in range(8)] for c in range(3)]
        one2, http_ms, spans2, three2 = timed_flows(url, pools, st2)
        finish("S2", server, warm2)
        launches2 = _launches(*kernels)
        flow_replays2 = st2["calls"]
        peak2 = torch.cuda.max_memory_allocated() / 2 ** 20
        direct = make_ragged_inference_fn(cfg2, iters=iters, device=dev)

        def embedded(im):
            bucket = sc2.route(*im.shape[:2])
            padded, pads = pad_to_shape(im[None], bucket)
            return embed_to_shape(padded, box)[0], pads

        inputs = []
        for (a, b), got in zip(seq, seq_out):
            (ea, (t, _, l, _)), (eb, _) = embedded(a), embedded(b)
            inputs.append((ea[None], eb[None], np.asarray(
                [sc2.route(*a.shape[:2])], np.int32)))
            want = direct(model2, *inputs[-1])[0].cpu().numpy()
            if not np.array_equal(got, want[t:t + a.shape[0],
                                            l:l + a.shape[1]]):
                raise AssertionError("S2: a sequential response is not "
                                     "bitwise the direct call")
        check_batches("S2", st2["kept"], lambda ims: direct(model2, *ims))
        for (a, b), got in zip([p for c in conc for p in c],
                               [f for c in conc_out for f in c]):
            ea, (t, _, l, _) = embedded(a)
            for (ims, out) in st2["kept"][n_seq:]:
                hit = [j for j in range(ims[0].shape[0])
                       if np.array_equal(ims[0][j], ea)]
                if hit:
                    row = out[hit[0]][t:t + a.shape[0], l:l + a.shape[1]]
                    if not np.array_equal(got, row):
                        raise AssertionError("S2: a response is not its "
                                             "row of the batch")
                    break
            else:
                raise AssertionError("S2: a request in no batch")
        held2 = []
        for ims in first_of_each_size(st2["kept"]):
            hold_pair(f"S2 served ragged batch, live {ims[2].tolist()}", cfg2,
                      model2, *ims)
            held2.append((ims[0].shape[0], ims[2].tolist()))
        factory2 = factory_ms(direct, model2, inputs, rounds=4)
        got2 = {k: v for k, v in launches2.items() if v}
        want2 = {"corr_ragged": (2 * 3 + 1) * iters,   # + the probe warm-up
                 "sep_conv_gru": (2 * 3 + 1) * iters
                 * gru_cuda.LAUNCHES_PER_CALL}
        if got2 != want2 or warm2["captures"] != 3:
            raise AssertionError(f"S2 launches {got2} != {want2}")
        if not mean_batch > 1:
            raise AssertionError(f"S2: mean device batch {mean_batch:.2f}")
        replayed2 = {"corr_ragged": flow_replays2 * iters,
                     "sep_conv_gru": flow_replays2 * iters
                     * gru_cuda.LAUNCHES_PER_CALL}
        rec["s2"] = {
            "warmup_s": warm2["warmup_s"], "keys": warm2["keys"],
            "captures": warm2["captures"],
            "graph_pool_mib": warm2["graph_pool_mib"],
            "warmup_reserved_mib": warm2["reserved_mib"],
            "allocated_before_mib": warm2["allocated_before_mib"],
            "peak_allocated_mib": peak2,
            "http_ms_median_1_client": http_ms,
            "factory_ms_median": factory2,
            "serving_overhead_ms": http_ms - factory2,
            "spans_ms_median_1_client": spans2,
            "one_client": report(one2),
            "three_clients": report(three2),
            "mean_device_batch_3x6_check": mean_batch,
            "held_batches": held2,
            "launches": got2,
            "flow_graph_replays": flow_replays2,
            "launches_by_replay": replayed2,
            "compile_hits": eng.compile_hits}
        print(f"S2 BF ragged ({box[0]}x{box[1]} box; Sintel, KITTI, "
              f"FlyingChairs): 9 sequential + 3 clients x 6, every batch "
              f"bitwise the direct ragged call, every response its row, "
              f"mean device batch {mean_batch:.2f}; 0 serve-time captures; "
              f"kernels held at the served batches {held2}; launches at "
              f"capture + probe warm-up {got2} (B4-bf16 {got2.get('corr_ragged', 0)}, "
              f"B2-bf16 {got2.get('sep_conv_gru', 0)}), by {flow_replays2} "
              f"graph replays {replayed2}; peak allocated {peak2:.0f} MiB")
        print(f"S2 timings, 2 windows of {SERVE_WINDOW_S:g} s each: 1 client "
              f"{sum(w['requests'] for w in one2)} requests, HTTP median "
              f"{http_ms:.2f} ms vs the captured factory {factory2:.2f} ms "
              f"(overhead {http_ms - factory2:.2f} ms; spans "
              f"{ {k: round(v, 2) for k, v in spans2.items()} }); 3 clients "
              f"{sum(w['requests'] for w in three2)} requests, pairs/s by "
              f"window {[round(w['per_s'], 2) for w in three2]}, mean device "
              f"batch {[round(w['mean_device_batch'], 2) for w in three2]}")
    finally:
        _drop_conns()
        server.stop(timeout=60)
    add["bf16"] = launches2
    rec["launches"] = add
    return rec


# -- 9. training: the chairs stage on the card --------------------------------

TRAIN_HW, TRAIN_B = (368, 496), 10      # TrainConfig.for_stage('chairs')
TIMED_STEPS, FIT_STEPS = 3, 6
LEAF_RTOL, GRAD_RTOL, ZERO_ATOL = 3e-2, 1e-2, 1e-5


def c1_weights(model, seed: int = 1000) -> None:
    """C1 (phase 6d) in place: every conv bias and batch-norm beta from
    U(-0.25, 0.25), every gamma from U(0.75, 1.25), the running statistics
    away from identity, with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if "norm" in name or "downsample.1" in name:
                lo, hi = {"weight": (0.75, 1.25), "bias": (-0.25, 0.25),
                          "running_mean": (-0.05, 0.05),
                          "running_var": (0.9, 1.1)}[leaf]
            elif leaf == "bias":
                lo, hi = -0.25, 0.25
            else:
                continue
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, tuple(t.shape))
                                     .astype(np.float32)))


def _zero_grad_leaf(name: str, small: bool, frozen: bool) -> bool:
    """A conv bias feeding a normalization over batch or sample statistics:
    its exact gradient is 0 (tests/torch_train_parity.py)."""
    top, leaf = name.split(".")[0], name.rsplit(".", 1)[1]
    normed = top == "fnet" or (top == "cnet" and not small and not frozen)
    return normed and leaf == "bias" and name.split(".")[1] != "conv2" \
        and "norm" not in name and "downsample.1" not in name


def hold_grads(label: str, gk: dict, gp: dict, small: bool,
               frozen: bool = False) -> dict:
    """The kernel path's gradients against the plain path's, leaf by leaf
    (tests/torch_train_parity.py says why the bound is per leaf in L2, not
    elementwise): each leaf's ||gk - gp|| <= LEAF_RTOL ||gp||, the whole
    gradient at GRAD_RTOL, a zero-gradient bias below ZERO_ATOL of the
    largest |g|; prints the worst leaf and the worst max|diff| / max|g|
    of a leaf (the measure of the per-element bound, printed, not held)."""
    gscale = max(float(g.abs().max()) for g in gp.values())
    num = den = 0.0
    worst, worst_max = (0.0, ""), (0.0, "")
    for k, p in gp.items():
        d = (gk[k] - p).double()
        if _zero_grad_leaf(k, small, frozen):
            top = max(float(gk[k].abs().max()), float(p.abs().max()))
            if top > ZERO_ATOL * gscale:
                raise AssertionError(f"{label}: {k} should be ~0, |g| {top:.3e}")
            continue
        n, e = float(p.double().norm()), float(d.norm())
        num, den = num + e * e, den + n * n
        if e / max(n, 1e-30) > worst[0]:
            worst = (e / max(n, 1e-30), k)
        r = float(d.abs().max()) / max(float(p.abs().max()), 1e-30)
        if r > worst_max[0]:
            worst_max = (r, k)
    total = (num / den) ** 0.5
    print(f"{label}: whole gradient rel L2 {total:.3e} (bound {GRAD_RTOL:g}); "
          f"worst leaf rel L2 {worst[0]:.3e} {worst[1]} (bound {LEAF_RTOL:g}); "
          f"worst max|diff|/max|g_plain| {worst_max[0]:.3e} {worst_max[1]}")
    if total > GRAD_RTOL or worst[0] > LEAF_RTOL:
        raise AssertionError(f"{label}: the kernel path's gradient disagrees "
                             f"with the plain path's")
    return {"rel_l2": total, "worst_leaf_rel_l2": worst[0],
            "worst_leaf": worst[1], "worst_max_rel": worst_max[0]}


def _state_leaves(state) -> list:
    """A train state's parameters, batch-norm statistics and moments, in a
    fixed order (what a step updates)."""
    return (list(state.params) + list(state.bn_state.values())
            + state.opt_state.mu + state.opt_state.nu)


def hold_step(label: str, a, ma: dict, b, mb: dict, before) -> dict:
    """Two steps from one state (``before``, its leaves): bitwise equal,
    or else held within phase 9's gradient bounds, each leaf's update
    (after - before) by its L2 norm and the loss and gradient norm at
    GRAD_RTOL, with the reason printed."""
    la, lb = _state_leaves(a), _state_leaves(b)
    same = [torch.equal(x, y) for x, y in zip(la, lb)]
    scal = {k: (float(ma[k]), float(mb[k])) for k in ("loss", "grad_norm")}
    bitwise = all(same) and all(x == y for x, y in scal.values())
    out = {"bitwise": bitwise, "leaves_differing": len(same) - sum(same),
           "loss": scal["loss"], "grad_norm": scal["grad_norm"]}
    if bitwise:
        print(f"{label}: loss, gradient norm, every parameter, moment and BN "
              f"statistic bitwise equal")
        return out
    worst = 0.0
    for x, y, z in zip(la, lb, before):
        n = float((y - z).double().norm())
        if n > 0:
            worst = max(worst, float((x - y).double().norm()) / n)
    rel = {k: abs(x - y) / max(abs(y), 1e-30) for k, (x, y) in scal.items()}
    out.update(worst_update_rel_l2=worst, scalar_rel=rel)
    print(f"{label}: NOT bitwise ({out['leaves_differing']} leaves differ): "
          f"worst leaf update rel L2 {worst:.3e} (bound {LEAF_RTOL:g}), loss "
          f"and grad norm rel {rel}; the reason: the graph replays the "
          f"kernels its warm-up chose, the eager step asks cuDNN and cuBLAS "
          f"again, and an algorithm of other summation order gives other "
          f"float32 rounding")
    if worst > LEAF_RTOL or max(rel.values()) > GRAD_RTOL:
        raise AssertionError(f"{label}: captured and eager steps disagree")
    return out


def training_phases(dev, smi: str, kernels) -> dict:
    """Phase 9: training on the card (the module docstring), returns the
    ``train`` record and, under ``launches``, the main paths' launches by
    compute dtype."""
    import copy
    import gc
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from raft_tpu_torch import RAFTConfig, init_raft_torch
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.data.datasets import make_training_dataset
    from raft_tpu_torch.data.pipeline import PrefetchLoader
    from raft_tpu_torch.models.raft import raft_forward
    from raft_tpu_torch.ops import corr_cuda, gru_cuda
    from raft_tpu_torch.ops.coords import coords_grid
    from raft_tpu_torch.ops.corr import (fmap2_pyramid, lookup_blockwise_onehot,
                                         lookup_packed_plain)
    from raft_tpu_torch.ops.gru_cuda import fuse_gru_weights, sep_conv_gru_plain
    from raft_tpu_torch.training import (GraphedTrainStep, TrainState,
                                         make_optimizer, make_train_step,
                                         restore_checkpoint, save_checkpoint,
                                         sequence_loss)
    from raft_tpu_torch.training.checkpoint import (checkpoint_readable,
                                                    list_checkpoints)
    from raft_tpu_torch.training.resilience import PREEMPT_EXIT_CODE
    from raft_tpu_torch.training.step import precision
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    marks = {}

    def mark(label):
        """Seconds since the phase began, at the end of each part."""
        marks[label] = time.perf_counter() - t_phase
        print(f"train: {label} done at {marks[label]:.1f} s into phase 9")

    cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
    cfg_plain = dataclasses.replace(cfg, corr_impl="blockwise",
                                    corr_lookup="onehot", gru_impl="xla")
    # BF: bench.py::_cfg_for("pallas-bf16corr-ctx-gru-winpack")
    cfg_bf = dataclasses.replace(
        cfg, corr_precision="default", pallas_pack=True,
        pallas_p_select="window", pallas_p_blk=1024, compute_dtype="bfloat16")
    cfg_bf_plain = dataclasses.replace(cfg_bf, corr_impl="blockwise",
                                       corr_lookup="onehot", gru_impl="xla")
    tc = TrainConfig.for_stage("chairs")
    assert (tc.batch_size, tuple(tc.image_size)) == (TRAIN_B, TRAIN_HW)
    per_step = {"f32": {"corr_lookup": 2 * ITERS,   # forward + remat recompute
                        "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL},
                "bf16": {"corr_packed": 2 * ITERS,
                         "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}}
    graphs = []                  # every captured train step of the phase

    def fresh(config=cfg, seed=0):
        """C1 weights as float32 masters (under either compute dtype)."""
        m = init_raft_torch(config, generator=torch.Generator().manual_seed(seed),
                            device=dev, dtype=torch.float32)
        c1_weights(m)
        return m

    def captured(config, tconfig, tx):
        step = GraphedTrainStep(config, tconfig, tx)
        graphs.append(step)
        return step

    def release(*steps):
        """Drop a captured step's graphs, after checking that no key was
        captured twice (the phase moves no storage)."""
        for s in steps:
            if s.recaptures:
                raise AssertionError(f"train: {s.recaptures} keys captured "
                                     f"again")
            s._graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()

    def expect(label, got, want):
        others = {k: v for k, v in got.items() if k not in want and v}
        if any(got.get(k, 0) != v for k, v in want.items()) or others:
            raise AssertionError(f"{label}: launches {got}, want {want}")

    # the synthetic dataset at the stage's shape, samples made by 8 threads
    # (numpy releases the GIL), batched on the host, staged by PrefetchLoader
    ds = make_training_dataset("synthetic", None, tc.image_size)
    pool = ThreadPoolExecutor(8)

    def host_batches(start=0):
        i = start
        while True:
            samples = list(pool.map(ds.__getitem__, range(i, i + TRAIN_B)))
            i += TRAIN_B
            yield tuple(np.stack([s[j] for s in samples]) for j in range(4))

    def ev_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(step, state, loader, seed0):
        """2 warm-up and TIMED_STEPS timed steps from the loader: ms a step
        (host clock, to the loss's read), the data waits, the losses."""
        losses, ms, wait = [], [], []
        for i in range(2 + TIMED_STEPS):
            if i == 2:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(loader)
            t1 = time.perf_counter()
            state, m = step(state, batch, seed0 + i)
            losses.append(float(m["loss"]))          # the step's one sync
            if i >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
                wait.append((t1 - t0) * 1e3)
        return state, losses, ms, wait

    def idle(step, state, batch, seed):
        """The device idle share of one step under the profiler (its
        window on CUDA events, its kernels' busy time; an eager step's
        profile takes tens of seconds to read, so one step)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s0, s1 = ev_pair()
            s0.record()
            state, _ = step(state, batch, seed)
            s1.record()
            torch.cuda.synchronize()
        window = s0.elapsed_time(s1)
        ranges = (corr_cuda.TWIN_STAGE, gru_cuda.TWIN_STAGE)

        def annotation(e):
            # a profiler range's span on the device (the twins' ranges):
            # not a kernel, and it covers the gaps between its kernels
            return getattr(e, "is_user_annotation", False) or e.key in ranges
        kern = [k for k in prof.key_averages()
                if k.device_type == torch.autograd.DeviceType.CUDA
                and not annotation(k)]
        busy = sum(k.self_device_time_total for k in kern) / 1e3
        # the backward twins' kernels' device ms a step, summed over the
        # kernels each twin's range (on the host) launched: an eager
        # step's; a replay's kernels belong to no range
        twins = {r: 0.0 for r in ranges}
        for e in prof.events():
            if (e.name in ranges and e.device_type ==
                    torch.autograd.DeviceType.CPU):
                twins[e.name] += e.device_time_total / 1e3
        return (state, (1 - busy / window if busy > 0 else None), window,
                busy, kern, twins)

    def side(ms, wait, losses, share, window, busy, peak):
        med = statistics.median(ms)
        return {"step_ms_median": med, "step_ms_min": min(ms),
                "step_ms_max": max(ms), "step_ms_all": ms,
                "samples_per_s": TRAIN_B * 1e3 / med, "idle_share": share,
                "profiled_window_ms": window, "profiled_busy_ms": busy,
                "peak_alloc_mib": peak / 2 ** 20, "data_wait_ms_all": wait,
                "losses": losses}

    def deterministic(on: bool):
        cudnn = torch.backends.cudnn
        torch.use_deterministic_algorithms(on, warn_only=True)
        cudnn.deterministic, cudnn.benchmark = on, not on

    def run_dtype(tag, config):
        """(a)/(b): the chairs stage through the captured step (2 warm-up
        replays, the first capturing, then TIMED_STEPS timed), then the
        eager step in the same process timed the same way; launches,
        idle shares, peaks, the graph pool; one replay against one eager
        step from one state and batch, deterministic algorithms on."""
        tx = make_optimizer(tc)
        state = TrainState.create(fresh(config), tx)
        cap = captured(config, tc, tx)
        bn0 = {k: v.clone() for k, v in state.bn_state.items()}
        loader = PrefetchLoader(host_batches(), dev, buffer_size=2)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            _reset(*kernels)
            state, l_c, ms_c, w_c = timed(cap, state, loader, 0)
            got_c = _launches(*kernels)
            mark(f"{tag} captured run")
            peak_c = torch.cuda.max_memory_allocated(dev) - base
            pool_mib = _graph_pool_mib([cap])
            captures = cap.captures
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            _reset(*kernels)
            state, l_e, ms_e, w_e = timed(cap.eager, state, loader, 100)
            got_e = _launches(*kernels)
            peak_e = torch.cuda.max_memory_allocated(dev) - base
            fixed = next(loader)
            mark(f"{tag} eager run")
        finally:
            loader.close()
        losses = l_c + l_e
        print(f"train {tag}: chairs stage, {TRAIN_B} x {TRAIN_HW[0]}x"
              f"{TRAIN_HW[1]}, {ITERS} iterations, remat on: losses "
              f"{[round(x, 3) for x in losses]}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {tag}: a non-finite loss")
        want = per_step[tag]
        expect(f"train {tag} captured (the capture: its warm-up and the "
               f"captured step; replays count none)", got_c,
               {k: 2 * v for k, v in want.items()})
        expect(f"train {tag} eager, {2 + TIMED_STEPS} steps", got_e,
               {k: (2 + TIMED_STEPS) * v for k, v in want.items()})
        print(f"train {tag}: launches, captured run {got_c} (the capture), "
              f"eager run {got_e}: per step {want} ({ITERS} forward + "
              f"{ITERS} in the remat recompute; the backward runs the twins, "
              f"no kernel)")
        if captures != 1:
            raise AssertionError(f"train {tag}: {captures} captures for one key")
        moved = sum(not torch.equal(bn0[k], v) for k, v in state.bn_state.items())
        if moved != len(bn0):
            raise AssertionError(f"train {tag}: {len(bn0) - moved} BN "
                                 f"statistics did not move")
        if {p.dtype for p in state.params} != {torch.float32}:
            raise AssertionError(f"train {tag}: the masters are not float32")
        state, idle_c, win_c, busy_c, kern_c, _ = idle(cap, state, fixed, 50)
        state, idle_e, win_e, busy_e, kern_e, twins = idle(cap.eager, state,
                                                           fixed, 60)
        print(f"train {tag} eager, profiled: the backward twins' device ms a "
              f"step {twins} (of {busy_e:.1f} ms of kernels a step)")
        mark(f"{tag} profiles")
        for name, kern in (("captured", kern_c), ("eager", kern_e)):
            print(f"train {tag} {name}, profiled: the top device ops a step")
            for k in sorted(kern, key=lambda k: -k.self_device_time_total)[:6]:
                print(f"  {k.self_device_time_total / 1e3:8.3f} ms/step "
                      f"{k.count:6d} launches/step  {k.key[:90]}")
        # one replay against one eager step, from one state and batch
        deterministic(True)
        try:
            before = [t.clone() for t in _state_leaves(state)]
            a, b = copy.deepcopy(state), copy.deepcopy(state)
            a, ma = cap(a, fixed, 7)
            b, mb = cap.eager(b, fixed, 7)
            torch.cuda.synchronize()
        finally:
            deterministic(False)
        parity = hold_step(f"train {tag}: one replay vs one eager step "
                           f"(deterministic algorithms on)", a, ma, b, mb, before)
        mark(f"{tag} replay vs eager")
        del a, b, before
        rec = {"captured": side(ms_c, w_c, l_c, idle_c, win_c, busy_c, peak_c),
               "eager": side(ms_e, w_e, l_e, idle_e, win_e, busy_e, peak_e),
               "captures": captures, "graph_pool_mib": pool_mib,
               "captured_vs_eager": parity, "twins_device_ms_per_step": twins,
               "launches_per_step": want, "launches": {
                   k: got_c.get(k, 0) + got_e.get(k, 0) for k in want}}
        c, e = rec["captured"], rec["eager"]
        print(f"train {tag}: captured step {c['step_ms_median']:.1f} ms median "
              f"({c['step_ms_min']:.1f}-{c['step_ms_max']:.1f}), "
              f"{c['samples_per_s']:.2f} samples/s, idle {idle_c}; eager "
              f"{e['step_ms_median']:.1f} ({e['step_ms_min']:.1f}-"
              f"{e['step_ms_max']:.1f}), {e['samples_per_s']:.2f} samples/s, "
              f"idle {idle_e}; peak {c['peak_alloc_mib']:.0f} MiB captured "
              f"(the capture, its warm-up and the graph) / "
              f"{e['peak_alloc_mib']:.0f} eager; {captures} capture, graph "
              f"pool {pool_mib} MiB; {smi}")
        return rec, state, cap, fixed

    def fit(tag, config, fixed):
        """FIT_STEPS captured steps on one fixed batch at the chairs lr
        held constant (the one-cycle schedule starts 25x lower) lower its
        loss."""
        tc_fit = dataclasses.replace(tc, schedule="constant")
        tx_fit = make_optimizer(tc_fit)
        st = TrainState.create(fresh(config), tx_fit)
        step = captured(config, tc_fit, tx_fit)
        out = []
        for i in range(FIT_STEPS):
            st, m = step(st, fixed, 0)
            out.append(float(m["loss"]))
        print(f"train {tag}: {FIT_STEPS} captured steps on one batch (lr "
              f"{tc_fit.lr:g} constant): loss {out[0]:.3f} -> {out[-1]:.3f}")
        if not (all(np.isfinite(out)) and out[-1] < out[0]):
            raise AssertionError(f"train {tag}: {FIT_STEPS} steps did not "
                                 f"lower a fixed batch's loss: {out}")
        release(step)
        return out

    def grads(config, model, batch, frozen=False, iters=3):
        mdl = copy.deepcopy(model)
        with precision():
            out = raft_forward(mdl, batch[0], batch[1], config, iters=iters,
                               train=True, freeze_bn=frozen)
            loss, _ = sequence_loss(out.flow_iters, batch[2], batch[3],
                                    gamma=tc.gamma, max_flow=tc.max_flow)
            g = torch.autograd.grad(loss, list(mdl.parameters()))
        return {n: x for (n, _), x in zip(mdl.named_parameters(), g)}

    def frozen_step(tag, config, fixed):
        """freeze_bn: the statistics bitwise, the affines moved, the
        masters float32 (a captured step)."""
        tc_fz = dataclasses.replace(tc, freeze_bn=True)
        tx_fz = make_optimizer(tc_fz)
        fz = TrainState.create(fresh(config), tx_fz)
        step = captured(config, tc_fz, tx_fz)
        stats0 = {k: v.clone() for k, v in fz.bn_state.items()}
        aff0 = {k: v.detach().clone() for k, v in fz.model.named_parameters()
                if k.startswith("cnet") and ("norm" in k or "downsample.1" in k)}
        fz, _ = step(fz, fixed, 0)
        same = all(torch.equal(stats0[k], v) for k, v in fz.bn_state.items())
        now = dict(fz.model.named_parameters())
        moved = sum(not torch.equal(v, now[k]) for k, v in aff0.items())
        f32 = {p.dtype for p in fz.params} == {torch.float32}
        print(f"train {tag} freeze_bn: statistics bitwise unchanged {same}; "
              f"{moved}/{len(aff0)} affines moved; masters float32 {f32}")
        if not same or moved != len(aff0) or not f32:
            raise AssertionError(f"train {tag} freeze_bn: statistics moved, "
                                 f"affines did not, or the masters changed dtype")
        release(step)

    def nan_skipped(tag, step, state, fixed):
        """A NaN batch through the captured step: params, moments and
        statistics bitwise, notfinite_count + 1."""
        snap = ([t.clone() for t in _state_leaves(state)],
                int(state.opt_state.notfinite_count))
        nan_batch = (torch.full_like(fixed[0], float("nan")),) + tuple(fixed[1:])
        state, m = step(state, nan_batch, 99)
        ok = (all(torch.equal(a, b) for a, b in
                  zip(snap[0], _state_leaves(state)))
              and int(state.opt_state.notfinite_count) == snap[1] + 1)
        print(f"train {tag} NaN batch, captured step: loss {float(m['loss'])}, "
              f"params, moments and BN statistics bitwise unchanged and "
              f"notfinite_count +1: {ok}")
        if not ok:
            raise AssertionError(f"train {tag}: a non-finite batch changed "
                                 f"the state")
        return state

    # -- 9.1 (a) f32 main: captured, then eager ------------------------------
    rec_f32, state, cap, fixed = run_dtype("f32", cfg)
    mark("9.1 f32 captured and eager")
    fit_losses = fit("f32", cfg, fixed)
    mark("9.1 f32 fit")

    # -- 9.2 gradients, kernel path against plain path, 3 iterations --------
    base = fresh()
    gparity = {}
    for label, over in (("all", {}), ("window", dict(pallas_p_select="window")),
                        ("pack", dict(pallas_pack=True))):
        ck = dataclasses.replace(cfg, **over)
        _reset(*kernels)
        gk = grads(ck, base, fixed)
        gparity[label] = hold_grads(f"train grads {label} vs plain",
                                    gk, grads(cfg_plain, base, fixed), False)
        gparity[label]["launches"] = _launches(*kernels)
    small = RAFTConfig.small_model(corr_impl="pallas")
    small_plain = dataclasses.replace(small, corr_impl="blockwise")
    base_small = fresh(small)
    _reset(*kernels)
    gk = grads(small, base_small, fixed)
    gparity["small"] = hold_grads("train grads raft-small vs plain", gk,
                                  grads(small_plain, base_small, fixed), True)
    gparity["small"]["launches"] = _launches(*kernels)
    del base_small
    mark("9.2 gradient parity")

    # -- 9.3 freeze_bn: statistics bitwise, affines move --------------------
    frozen_step("f32", cfg, fixed)
    mark("9.3 freeze_bn")

    # -- 9.4 a NaN batch is skipped by the captured step ---------------------
    state = nan_skipped("f32", cap, state, fixed)
    step_fn = cap.eager

    # -- 9.5 checkpoint at step k, restore, step k+1 (eager, deterministic) --
    ckdir = Path(tempfile.mkdtemp(prefix="chip_train_", dir="build"))
    save_checkpoint(ckdir / f"ckpt_{state.step}.npz", state)
    tx_r = make_optimizer(tc)
    restored = restore_checkpoint(ckdir / f"ckpt_{state.step}.npz",
                                  TrainState.create(fresh(seed=5), tx_r))
    step_r = make_train_step(cfg, tc, tx_r)
    deterministic(True)
    try:
        state, m_a = step_fn(state, fixed, 7)
        restored, m_b = step_r(restored, fixed, 7)
        torch.cuda.synchronize()
    finally:
        deterministic(False)
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(_state_leaves(state), _state_leaves(restored))) \
        and float(m_a["loss"]) == float(m_b["loss"])
    print(f"train checkpoint: step {restored.step} after a restore of step "
          f"{restored.step - 1} bitwise equal to the uninterrupted step, "
          f"deterministic algorithms on: {bitwise}")
    if not bitwise:
        raise AssertionError("train checkpoint: the resumed step differs")
    del restored, step_r
    mark("9.4-9.5 NaN, resume")

    # -- 9.7 numbers (f32, eager): the forward / backward split, the twins ---
    split = {"forward": [], "backward": []}
    mdl = state.model
    params = list(mdl.parameters())
    for _ in range(3):
        (s0, s1), (s2, s3) = ev_pair(), ev_pair()
        with precision():
            s0.record()
            out = raft_forward(mdl, fixed[0], fixed[1], cfg, train=True)
            loss, _ = sequence_loss(out.flow_iters, fixed[2], fixed[3],
                                    gamma=tc.gamma, max_flow=tc.max_flow)
            s1.record()
            s2.record()
            torch.autograd.grad(loss, params)
            s3.record()
        torch.cuda.synchronize()
        split["forward"].append(s0.elapsed_time(s1))
        split["backward"].append(s2.elapsed_time(s3))
    del out, loss
    fwd_ms = statistics.median(split["forward"])
    bwd_ms = statistics.median(split["backward"])

    # the twins' backward alone, per iteration, at the stage's shapes
    h8, w8 = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    gen = torch.Generator(device=dev).manual_seed(3)
    f1 = torch.randn(TRAIN_B, h8, w8, 256, device=dev, generator=gen)
    lv = [x.contiguous() for x in fmap2_pyramid(
        torch.randn(TRAIN_B, h8, w8, 256, device=dev, generator=gen), 4)]
    co = (coords_grid(TRAIN_B, h8, w8, device=dev)
          + 4.0 * torch.randn(TRAIN_B, h8, w8, 2, device=dev, generator=gen))
    gout = torch.randn(TRAIN_B, h8, w8, 324, device=dev, generator=gen)

    def lookup_bwd():
        leaves = [f1.requires_grad_(True)] + [x.requires_grad_(True) for x in lv]
        out = lookup_blockwise_onehot(leaves[0], leaves[1:], co, 4)
        return torch.autograd.grad(out, leaves, gout)

    gru = state.model.update_block.gru
    hg, mg, ctxg = gru_inputs(np.random.RandomState(4), dev, TRAIN_B, h8, w8)
    gh = torch.randn(TRAIN_B, h8, w8, 128, device=dev, generator=gen)

    def gru_bwd():
        fw = fuse_gru_weights(gru, 128, 128)
        leaves = [hg.requires_grad_(True), mg.requires_grad_(True),
                  ctxg[0].requires_grad_(True), ctxg[1].requires_grad_(True)]
        out = sep_conv_gru_plain(fw, leaves[0], leaves[1], tuple(leaves[2:]))
        return torch.autograd.grad(out, leaves + [getattr(gru, g + s).weight
                                                  for s in "12"
                                                  for g in ("convz", "convr",
                                                            "convq")], gh)
    with precision():
        lk_ms = _time_ms(lookup_bwd, 2, 5)
        gr_ms = _time_ms(gru_bwd, 2, 5)
    # bounds: the twins' products at the FP32 rate (TF32 off), recompute +
    # backward (the f1 . f2 product three times, the one-hot products
    # twice), and the bytes of the inputs and the gradients
    q = h8 * w8
    dots = onehot = 0
    for lvl in range(4):
        h2, w2 = lv[lvl].shape[1:3]
        dots += 2 * TRAIN_B * q * 256 * h2 * w2
        onehot += 2 * TRAIN_B * q * 9 * (h2 * w2 + w2 * 9)
    lk_bound = _bound_ms(2 * 4 * (f1.numel() + sum(x.numel() for x in lv))
                         + 4 * gout.numel(),
                         {"fp32": 3 * dots + 2 * onehot})
    gflops = _gru_flops(TRAIN_B, h8, w8, 128, 128, False)
    gr_bound = _bound_ms(4 * 2 * (hg.numel() * 2 + mg.numel()
                                  + ctxg[0].numel() * 2),
                         {"fp32": 3 * gflops["f32xf32"] + gflops["fp32"]})
    print(f"train backward twins per iteration, {TRAIN_B} x {h8}x{w8}: lookup "
          f"{lk_ms:.3f} ms (bound {lk_bound[0]:.3f}, {lk_bound[1]}), GRU "
          f"{gr_ms:.3f} ms (bound {gr_bound[0]:.3f}, {gr_bound[1]})")
    mark("9.7 split and twins")

    # -- 9.8 (d) each kernel of the two paths against its plain version at
    # the training shapes (batch 10, 46x62 at 1/8)
    kparity = {}
    with precision(), torch.no_grad():
        f1d, lvd = f1.detach(), [x.detach() for x in lv]
        kparity["corr_lookup"] = _compare(
            f"train shapes: corr_lookup f32 [{TRAIN_B}, {h8}, {w8}, 256]",
            corr_cuda.corr_lookup_cuda(f1d, lvd, co, 4),
            lookup_blockwise_onehot(f1d, lvd, co, 4))
        f1b = f1d.bfloat16().contiguous()
        lvb = [x.bfloat16().contiguous() for x in lvd]
        kparity["corr_packed_bf16"] = _compare(
            "train shapes: corr_packed bf16 (BF's 'window')",
            corr_cuda.corr_packed_cuda(f1b, lvb, co, 4, "window"),
            lookup_packed_plain(f1b, lvb, co, 4, "window"))
        fw = fuse_gru_weights(gru, 128, 128)
        hd, md, cd = hg.detach(), mg.detach(), tuple(c.detach() for c in ctxg)
        kparity["sep_conv_gru"] = _compare(
            "train shapes: sep_conv_gru f32",
            gru_cuda.sep_conv_gru_cuda(
                gru_cuda.prepare_gru_weights(fw, torch.float32), hd, md, cd),
            sep_conv_gru_plain(fw, hd, md, cd))
        fw16 = {k: v.bfloat16() for k, v in fw.items()}
        hb, mb_, cb = hd.bfloat16(), md.bfloat16(), tuple(c.bfloat16() for c in cd)
        kparity["sep_conv_gru_bf16"] = _compare_ulp(
            "train shapes: sep_conv_gru bf16 I/O",
            gru_cuda.sep_conv_gru_cuda(
                gru_cuda.prepare_gru_weights(fw16, torch.bfloat16), hb, mb_, cb),
            sep_conv_gru_plain({k: v.float() for k, v in fw16.items()},
                               hb, mb_, cb))
    del f1, lv, f1d, lvd, f1b, lvb, co, gout
    mark("9.8 kernel parity")

    # peak memory with remat off, if it fits (eager)
    cfg_nr = dataclasses.replace(cfg, remat_iters=False)
    tx_nr = make_optimizer(tc)
    nr = TrainState.create(fresh(), tx_nr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_nr = torch.cuda.memory_allocated(dev)
    peak_no_remat, nr_note = None, "fits"
    try:
        nr, _ = make_train_step(cfg_nr, tc, tx_nr)(nr, fixed, 0)
        torch.cuda.synchronize()
        peak_no_remat = torch.cuda.max_memory_allocated(dev) - base_nr
    except torch.cuda.OutOfMemoryError as e:
        nr_note = f"does not fit: {str(e).splitlines()[0]}"
    del nr
    # the eager step timed again once a profiler session has run in the
    # process (the host's time per launch after it)
    after_prof = []
    for i in range(3):
        t0 = time.perf_counter()
        state, m = step_fn(state, fixed, 60 + i)
        float(m["loss"])
        after_prof.append((time.perf_counter() - t0) * 1e3)
    release(cap)
    del state, cap, mdl, params, gru, base
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9.9 (b) BF training: captured, then eager ---------------------------
    rec_bf, sbf, cap_bf, fixed_bf = run_dtype("bf16", cfg_bf)
    mark("9.9 BF captured and eager")
    _reset(*kernels)
    one = copy.deepcopy(sbf)
    one, _ = cap_bf.eager(one, fixed_bf, 5)
    got_one = _launches(*kernels)
    expect("train bf16: one eager step", got_one, per_step["bf16"])
    print(f"train bf16: one eager step launches {got_one} (B5-bf16 "
          f"{2 * ITERS}, B2-bf16 {2 * ITERS * gru_cuda.LAUNCHES_PER_CALL})")
    rec_bf["launches"] = {k: v + got_one.get(k, 0)
                          for k, v in rec_bf["launches"].items()}
    del one
    fit_bf = fit("bf16", cfg_bf, fixed_bf)
    mark("9.9 BF fit")
    # the kernel path's bf16 gradients at 3 iterations against the plain
    # path's, each leaf within twice the plain path's own bf16-vs-f32
    # distance (L2), as phase 6c holds bf16
    base = fresh(cfg_bf)
    g_k16 = grads(cfg_bf, base, fixed_bf)
    g_p16 = grads(cfg_bf_plain, base, fixed_bf)
    g_p32 = grads(cfg_plain, base, fixed_bf)
    worst = (0.0, "")
    for k, p16 in g_p16.items():
        d = float((g_k16[k] - p16).double().norm())
        env = 2 * float((p16 - g_p32[k]).double().norm())
        r = d / env if env > 0 else (0.0 if d == 0 else float("inf"))
        if r > worst[0]:
            worst = (r, k)
    print(f"train bf16 grads kernel vs plain (bf16), 3 iterations: worst "
          f"leaf {worst[1]} at {worst[0]:.3f} of twice the plain path's "
          f"bf16-vs-f32 distance (bound 1)")
    if worst[0] > 1.0:
        raise AssertionError("train bf16: the kernel path's gradient leaves "
                             "the plain path's bf16 envelope")
    rec_bf["grad_parity"] = {"worst_ratio": worst[0], "worst_leaf": worst[1]}
    del base, g_k16, g_p16, g_p32
    frozen_step("bf16", cfg_bf, fixed_bf)
    mark("9.9 BF gradients and freeze_bn")

    # -- 9.10 (c) a captured bf16 run: NaN skipped, resumed bitwise ----------
    sbf = nan_skipped("bf16", cap_bf, sbf, fixed_bf)
    k = sbf.step
    save_checkpoint(ckdir / f"ckpt_bf16_{k}.npz", sbf)
    tx_r = make_optimizer(tc)
    resumed = restore_checkpoint(ckdir / f"ckpt_bf16_{k}.npz",
                                 TrainState.create(fresh(cfg_bf, seed=5), tx_r))
    deterministic(True)
    try:
        before = [t.clone() for t in _state_leaves(sbf)]
        a, ma = cap_bf(copy.deepcopy(sbf), fixed_bf, 8)
        resumed, mr = cap_bf(resumed, fixed_bf, 8)
        torch.cuda.synchronize()
    finally:
        deterministic(False)
    same = all(torch.equal(x, y) for x, y in
               zip(_state_leaves(a), _state_leaves(resumed))) and \
        float(ma["loss"]) == float(mr["loss"])
    print(f"train bf16 checkpoint: captured step {resumed.step} after a "
          f"restore of step {k} into a fresh state bitwise equal to the "
          f"uninterrupted one, deterministic algorithms on: {same}")
    if not same:
        raise AssertionError("train bf16 checkpoint: the resumed step differs")
    rec_bf["resume_bitwise"] = same
    release(cap_bf)
    del a, resumed, sbf, cap_bf, before
    gc.collect()
    torch.cuda.empty_cache()
    mark("9.10 BF NaN and resume")

    # -- 9.6 preemption: SIGTERM -> exit 17, readable checkpoint, resume -----
    # float32 (the default dtype) and bfloat16, the two runs side by side
    env = dict(os.environ, PYTHONPATH=os.getcwd())

    def preempt(dtype):
        """``python -m raft_tpu_torch.training --small`` in ``dtype`` (float32:
        the default, no flag): sent SIGTERM after step 2 it exits 17 with a
        readable checkpoint, and a rerun resumes from that checkpoint;
        returns what it printed."""
        run_dir = ckdir / f"cli_{dtype}"
        cmd = [sys.executable, "-m", "raft_tpu_torch.training", "--small",
               *([] if dtype == "float32" else ["--dtype", dtype]),
               "--iters", "2", "--batch", "2", "--train-size", "64", "96",
               "--num-steps", "1000", "--ckpt-every", "1000",
               "--log-every", "1", "--out", str(run_dir)]
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines = []
        try:
            deadline = time.monotonic() + 180
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if "[train] step 2 " in line:
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        ckpts = list_checkpoints(run_dir / "checkpoints")
        readable = bool(ckpts) and checkpoint_readable(ckpts[-1][1])
        said = [f"train preemption ({dtype}, captured): exit "
                f"{proc.returncode}, checkpoints {[s for s, _ in ckpts]}, "
                f"readable {readable}"]
        if proc.returncode != PREEMPT_EXIT_CODE or not readable:
            raise AssertionError(f"train preemption ({dtype}): "
                                 + "".join(lines) + rest)
        resumed = subprocess.run(cmd[:cmd.index("--num-steps") + 1]
                                 + [str(ckpts[-1][0] + 1)]
                                 + cmd[cmd.index("--num-steps") + 2:],
                                 env=env, capture_output=True, text=True,
                                 timeout=300)
        ok = (resumed.returncode == 0
              and f"at step {ckpts[-1][0]}" in resumed.stdout)
        said.append(f"train preemption ({dtype}): the rerun resumed from "
                    f"step {ckpts[-1][0]}: {ok}")
        if not ok:
            raise AssertionError(f"train resume ({dtype}): " + resumed.stdout
                                 + resumed.stderr)
        return said

    with ThreadPoolExecutor(2) as ex:
        runs = [ex.submit(preempt, d) for d in ("float32", "bfloat16")]
        for run in runs:
            print("\n".join(run.result()))
    mark("9.6 preemption")

    captures = sum(s.captures for s in graphs)
    keys = captures - sum(s.recaptures for s in graphs)
    print(f"train: {len(graphs)} captured train steps, {captures} captures "
          f"for {keys} keys (every key captured once)")
    cf, ce = rec_f32["captured"], rec_f32["eager"]
    rec = {
        "device": smi, "config": "RAFTConfig.full(corr_impl='pallas', "
        "gru_impl='pallas', iters=12), remat_iters on, float32, TF32 off; BF: "
        "pallas-bf16corr-ctx-gru-winpack, compute_dtype='bfloat16', float32 "
        "masters",
        "stage": "chairs", "batch": TRAIN_B, "accum_steps": tc.accum_steps,
        "image": list(TRAIN_HW), "data": "synthetic, PrefetchLoader",
        "step": "captured (training/capture.py); eager beside it",
        "step_ms_median": cf["step_ms_median"], "step_ms_min": cf["step_ms_min"],
        "step_ms_max": cf["step_ms_max"], "step_ms_all": cf["step_ms_all"],
        "samples_per_s": cf["samples_per_s"],
        "f32": rec_f32, "bf16": rec_bf,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "forward_ms_all": split["forward"], "backward_ms_all": split["backward"],
        "lookup_bwd_ms_per_iter": lk_ms, "lookup_bwd_bound_ms": lk_bound[0],
        "lookup_bwd_bound_by": lk_bound[1],
        "gru_bwd_ms_per_iter": gr_ms, "gru_bwd_bound_ms": gr_bound[0],
        "gru_bwd_bound_by": gr_bound[1], "kernel_parity_max_abs": kparity,
        "step_peak_alloc_mib_remat": ce["peak_alloc_mib"],
        "step_peak_alloc_mib_no_remat": (None if peak_no_remat is None
                                         else peak_no_remat / 2 ** 20),
        "no_remat": nr_note, "idle_share": cf["idle_share"],
        "eager_step_ms_after_profiler": after_prof,
        "fit_losses": {"f32": fit_losses, "bf16": fit_bf},
        "grad_parity": gparity,
        "captures": captures, "graph_keys": keys, "phase_marks_s": marks,
    }
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"train: f32 captured {cf['step_ms_median']:.1f} ms "
          f"({cf['step_ms_min']:.1f}-{cf['step_ms_max']:.1f}) / eager "
          f"{ce['step_ms_median']:.1f} ({ce['step_ms_min']:.1f}-"
          f"{ce['step_ms_max']:.1f}); BF captured "
          f"{rec_bf['captured']['step_ms_median']:.1f} / eager "
          f"{rec_bf['eager']['step_ms_median']:.1f} ms; forward "
          f"{fwd_ms:.1f} / backward {bwd_ms:.1f} ms (f32 eager); peak "
          f"{ce['peak_alloc_mib']:.0f} MiB remat on, "
          f"{'%.0f MiB' % rec['step_peak_alloc_mib_no_remat'] if peak_no_remat else nr_note}"
          f" off; eager after the profiler {[round(x, 1) for x in after_prof]} "
          f"ms; phase 9 {rec['phase_s']:.1f} s; {smi}")
    pool.shutdown(wait=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    rec["launches"] = {"f32": rec_f32["launches"], "bf16": rec_bf["launches"]}
    return rec


# -- 10. data and evaluation: the readers, augmentors, loader, evaluation ---

CHAIRS_HW, CHAIRS_PAIRS = (384, 512), 24          # FlyingChairs' frames
SINTEL_HW, SINTEL_FRAMES = (436, 1024), 6          # one scene
KITTI_SIZES = ((375, 1242), (375, 1242), (370, 1224), (370, 1224))
DATA_STEPS = 3                                     # timed, after 2 warm-up
KILL_DEADLINE_S = 60.0
AUG_ATOL = 1e-4


def _expect_launches(label: str, got: dict, want: dict) -> None:
    """``got`` (the launch counters) must hold ``want`` exactly and no
    other kernel may have launched."""
    extra = {k: v for k, v in got.items() if k not in want and v}
    if any(got.get(k, 0) != v for k, v in want.items()) or extra:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    print(f"{label}: launches {want} as expected")


def hold_eval(label: str, mdl, cfg_k, t1, t2, init) -> float:
    """Evaluation's kernels at its own shape and batch: from the encoders'
    features of the padded frames and the seed ``init`` the harness gave
    (NHWC [B, h, w, 2]; zeros at a scene start), every one of the
    ``cfg_k.iters`` iterations' kernel step held to the plain step from the
    same state at phase 4's float32 bound (:func:`_within`).  Returns the
    worst ratio."""
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.models.raft import (encode_pair, gru_step,
                                            prepare_loop, upsample_flow)
    cfg_p = RAFTConfig.full(corr_impl="blockwise", corr_lookup="onehot",
                            gru_impl="xla")
    with torch.no_grad():
        fm1, fm2, net, inp = encode_pair(mdl, t1, t2, cfg_k)
        loop_k = prepare_loop(mdl, fm1, fm2, inp, cfg_k)
        loop_p = prepare_loop(mdl, fm1, fm2, inp, cfg_p)
        c0, worst = loop_k.coords0, (0.0, "")
        coords1 = c0 + init.float()
        for it in range(cfg_k.iters):
            net_k, ck, mk = gru_step(mdl, cfg_k, loop_k, net, coords1)
            _, cp, mp = gru_step(mdl, cfg_p, loop_p, net, coords1)
            worst = max(worst, _within(
                f"iteration {it}", upsample_flow(cfg_k, ck - c0, mk),
                upsample_flow(cfg_p, cp - c0, mp)))
            net, coords1 = net_k, ck
    print(f"{label}, batch of {t1.shape[0]} at {t1.shape[1]}x{t1.shape[2]}, "
          f"seed max |flow| {float(init.abs().max()):.3g}: every one of "
          f"{cfg_k.iters} iterations vs the plain step from the same state, "
          f"worst {worst[1]}")
    if not worst[0] <= 1.0:
        raise AssertionError(f"{label}: a kernel step disagrees with the "
                             f"plain step")
    return worst[0]


def data_phases(dev, smi: str, kernels) -> dict:
    """Phase 10 (the module docstring): file-fed training, the device
    augmentor against the CPU, the loader's kill drill, evaluation.
    Returns the ``data`` record and, under ``launches``, its launches."""
    import argparse
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from raft_tpu_torch import RAFTConfig, init_raft_torch
    from raft_tpu_torch import imageio
    from raft_tpu_torch.data import fabricate
    from raft_tpu_torch.data.augment import STAGE_SCALES, FlowAugmentor
    from raft_tpu_torch.data.augment_device import (DecodeOnlyDataset,
                                                    make_batch_augment_fn,
                                                    make_device_augmentor,
                                                    params_from_host)
    from raft_tpu_torch.data.datasets import FlyingChairs, Kitti, MpiSintel
    from raft_tpu_torch.data.loader_bench import mp_rate
    from raft_tpu_torch.data.mp_loader import MPSampleLoader
    from raft_tpu_torch.data.pipeline import pad_to_multiple
    from raft_tpu_torch.ops import gru_cuda
    from raft_tpu_torch.ops.warmstart import warm_start_seed
    from raft_tpu_torch.training import (TrainState, epe_metrics,
                                         make_eval_step, make_optimizer,
                                         make_train_step,
                                         make_warm_eval_step)
    from raft_tpu_torch.training.__main__ import (build_parser, make_batches,
                                                  make_train_config)
    from raft_tpu_torch.training.evaluate import evaluate_dataset
    from raft_tpu_torch.utils.flow_io import read_flo, read_kitti_flow

    t_phase = time.perf_counter()
    rec = {"device": smi}
    tmp = Path(tempfile.mkdtemp(prefix="raft_data_"))
    try:
        t0 = time.perf_counter()
        chairs = fabricate.chairs_tree(tmp / "chairs", CHAIRS_PAIRS,
                                       CHAIRS_HW, seed=1)
        sintel = fabricate.sintel_tree(tmp / "sintel", n_frames=SINTEL_FRAMES,
                                       size=SINTEL_HW, seed=2)
        kitti = fabricate.kitti_tree(tmp / "kitti", KITTI_SIZES, seed=3)
        print(f"data: trees written in {time.perf_counter() - t0:.1f} s "
              f"(chairs {CHAIRS_PAIRS} x {CHAIRS_HW}, sintel "
              f"{SINTEL_FRAMES} frames x {SINTEL_HW}, kitti {KITTI_SIZES})")
        frames = sorted((sintel / "training" / "clean").rglob("*.png"))
        t0 = time.perf_counter()
        for p in frames * 3:
            imageio.read_image(p)
        rec["png_decode_ms_per_frame"] = ((time.perf_counter() - t0) * 1e3
                                          / (3 * len(frames)))
        cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                              iters=ITERS)
        per_step = {"corr_lookup": 2 * ITERS,
                    "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}
        launches = {k: 0 for k in per_step}

        # -- 10.1 the chairs stage from files: host, then device augmentation
        for tag, extra in (("host_aug", []), ("device_aug", ["--device-aug"])):
            args = build_parser().parse_args(
                ["--dataset", "chairs", "--data", str(chairs),
                 "--workers", "4", *extra])
            tc = make_train_config(args)
            assert (tc.batch_size, tuple(tc.image_size)) == (TRAIN_B, TRAIN_HW)
            tx = make_optimizer(tc)
            model = init_raft_torch(cfg, torch.Generator().manual_seed(0),
                                    device=dev)
            state = TrainState.create(model, tx)
            step_fn = make_train_step(cfg, tc, tx)
            batches, loader = make_batches(args, tc, dev, None)
            losses, step_ms, wait_ms = [], [], []
            try:
                for i in range(2 + DATA_STEPS):
                    if i == 2:
                        torch.cuda.synchronize()
                        _reset(*kernels)
                    t0 = time.perf_counter()
                    batch = next(batches)
                    t1 = time.perf_counter()
                    state, m = step_fn(state, batch, i)
                    losses.append(float(m["loss"]))
                    if i >= 2:
                        wait_ms.append((t1 - t0) * 1e3)
                        step_ms.append((time.perf_counter() - t0) * 1e3)
                got = _launches(*kernels)
            finally:
                batches.close()
                loader.close()
            if not all(np.isfinite(losses)):
                raise AssertionError(f"data {tag}: a non-finite loss {losses}")
            _expect_launches(f"data {tag}: {DATA_STEPS} chairs steps from "
                             f"files", got,
                             {k: v * DATA_STEPS for k, v in per_step.items()})
            for k in launches:
                launches[k] += got[k]
            rec[f"step_ms_{tag}"] = step_ms
            rec[f"step_ms_median_{tag}"] = statistics.median(step_ms)
            rec[f"data_wait_ms_{tag}"] = wait_ms
            print(f"data {tag}: chairs from files, 4 workers (shm): step "
                  f"{statistics.median(step_ms):.1f} ms median "
                  f"({min(step_ms):.1f}-{max(step_ms):.1f}), data wait "
                  f"{statistics.median(wait_ms):.2f} ms median, losses "
                  f"{[round(x, 3) for x in losses]}")
            del state, model, step_fn

        # -- 10.2 the device augmentor on the card vs the CPU, same params
        dec = DecodeOnlyDataset(FlyingChairs(chairs))
        raw = [dec[i] for i in range(TRAIN_B)]
        host = [np.stack([r[j] for r in raw]) for j in range(3)]
        lo, hi = STAGE_SCALES["chairs"]
        params = [FlowAugmentor(TRAIN_HW, min_scale=lo, max_scale=hi,
                                rng=np.random.RandomState(s)
                                ).sample_params(*CHAIRS_HW)
                  for s in range(TRAIN_B)]
        aug = make_device_augmentor("chairs", TRAIN_HW)
        on_card = aug.apply_params(params_from_host(params, dev),
                                   *(torch.from_numpy(x).to(dev)
                                     for x in host))
        on_cpu = aug.apply_params(params_from_host(params),
                                  *(torch.from_numpy(x) for x in host))
        errs = {}
        for name, a, b in zip(("im1", "im2", "flow", "valid"), on_card,
                              on_cpu):
            err = float((a.cpu() - b).abs().max())
            bound = AUG_ATOL * (1 + float(b.abs().max()))
            errs[name] = err
            if not err <= bound:
                raise AssertionError(f"device augmentor {name}: card vs CPU "
                                     f"{err:.3e} > {bound:.3e}")
        rec["device_aug_card_vs_cpu_max_abs"] = errs
        fn = make_batch_augment_fn(aug, hw=CHAIRS_HW)
        staged = tuple(torch.from_numpy(x).to(dev) for x in host)
        gen = torch.Generator(device=dev).manual_seed(0)
        rec["device_aug_ms_per_batch"] = _time_ms(lambda: fn(staged, gen), 3, 20)
        print(f"data: device augmentor, a batch of {TRAIN_B} at "
              f"{CHAIRS_HW} -> {TRAIN_HW}, card vs CPU on the same params "
              f"max |diff| {errs} (bound {AUG_ATOL:g} x (1 + max|value|)); "
              f"{rec['device_aug_ms_per_batch']:.3f} ms a batch")

        # -- 10.3 the loader under a kill, both transports
        aug_ds = FlyingChairs(chairs, augmentor=FlowAugmentor(
            TRAIN_HW, min_scale=lo, max_scale=hi))
        for transport in ("pickle", "shm"):
            ld = MPSampleLoader(aug_ds, num_workers=4, seed=0,
                                transport=transport)
            it = iter(ld)
            try:
                for _ in range(5):
                    next(it)
                os.kill(ld._workers[1].proc.pid, signal.SIGKILL)
                t0 = time.perf_counter()
                for _ in range(10):
                    next(it)
                    if time.perf_counter() - t0 > KILL_DEADLINE_S:
                        raise AssertionError(f"loader ({transport}): over "
                                             f"{KILL_DEADLINE_S} s after "
                                             f"a kill")
                secs = time.perf_counter() - t0
            finally:
                ld.close()
            if ld.respawns != 1:
                raise AssertionError(f"loader ({transport}): respawns "
                                     f"{ld.respawns}, want 1")
            rec[f"kill_recovery_s_{transport}"] = secs
            print(f"data: loader ({transport}, 4 workers) SIGKILL of a "
                  f"worker mid-stream: respawns 1, 10 more samples in "
                  f"{secs:.2f} s (deadline {KILL_DEADLINE_S:g} s)")
        rec["loader_samples_per_s"] = {
            f"{transport}_{w}": mp_rate(aug_ds, w, 8, transport)
            for w in (1, 2, 4) for transport in ("pickle", "shm")}
        print(f"data: loader samples/s (chairs host recipe, 384x512 -> "
              f"368x496): {rec['loader_samples_per_s']}")

        # -- 10.4 evaluation: Sintel (warm start), KITTI (bucket 64, pixel)
        ecfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
        model = init_raft_torch(ecfg, torch.Generator().manual_seed(4),
                                device=dev)
        c1_weights(model)
        n_it = ecfg.iters
        for name, ds, kw, n_calls in (
                ("sintel", MpiSintel(sintel),
                 dict(warm_start=True, bucket=8, pad_mode="sintel"),
                 SINTEL_FRAMES - 1),
                ("kitti", Kitti(kitti),
                 dict(bucket=64, pad_mode="kitti", weighting="pixel",
                      batch_size=2), len(KITTI_SIZES) // 2)):
            dump = tmp / f"dump_{name}"
            torch.cuda.synchronize()
            _reset(*kernels)
            got_m = evaluate_dataset(model, ecfg, ds, dump_dir=str(dump),
                                     verbose=False, **kw)
            torch.cuda.synchronize()
            got = _launches(*kernels)
            _expect_launches(
                f"data eval {name}: {n_calls} forwards of {n_it} iterations",
                got, {"corr_lookup": n_it * n_calls,
                      "sep_conv_gru": n_it * n_calls
                      * gru_cuda.LAUNCHES_PER_CALL})
            for k in launches:
                launches[k] += got[k]
            if not all(np.isfinite(v) for v in got_m.values()):
                raise AssertionError(f"eval {name}: non-finite {got_m}")
            # the same padded inputs through the eval step directly, in the
            # harness's order and batches (the random-weight recurrence
            # turns any other rounding into pixels of flow)
            items = []
            for idx in range(len(ds)):
                im1, im2, gt, valid = ds[idx]
                p1, pads = pad_to_multiple(im1[None], kw["bucket"],
                                           kw["pad_mode"])
                p2, _ = pad_to_multiple(im2[None], kw["bucket"],
                                        kw["pad_mode"])
                items.append((p1, p2, pads, gt, valid))
            # ``to_hold``: the device calls whose kernels are held to the
            # plain step below (label, image1, image2, seed), after the
            # direct calls, so that nothing runs between those
            flows, prev, to_hold = [], None, []
            if name == "sintel":
                warm = make_warm_eval_step(ecfg)
                for idx, (p1, p2, _, _, _) in enumerate(items):
                    init = warm_start_seed(prev, (p1.shape[1] // 8,
                                                  p1.shape[2] // 8),
                                           reset=ds.is_scene_start(idx))
                    args = tuple(torch.from_numpy(x).to(dev)
                                 for x in (p1, p2, init))
                    flow, lr = warm(model, *args)
                    prev = lr.cpu().numpy()
                    flows.append(flow[0])
                    if idx < 2:      # the scene's cold start, a warm start
                        to_hold.append((f"eval sintel frame {idx}", *args))
            else:
                if len({it[0].shape for it in items}) != 1:
                    raise AssertionError("kitti: bucket 64 left several "
                                         "padded shapes")
                step = make_eval_step(ecfg)
                for k in range(0, len(items), kw["batch_size"]):
                    group = items[k:k + kw["batch_size"]]
                    args = tuple(torch.from_numpy(np.concatenate(
                        [g[j] for g in group])).to(dev) for j in (0, 1))
                    flows.extend(step(model, *args))
                    to_hold.append((f"eval kitti batch {k // 2}", *args,
                                    torch.zeros(args[0].shape[0],
                                                args[0].shape[1] // 8,
                                                args[0].shape[2] // 8, 2,
                                                device=dev)))
            direct = []
            for flow, (_, _, pads, gt, valid) in zip(flows, items):
                t, _, l, _ = pads
                h, w = gt.shape[:2]
                flow = flow[t:t + h, l:l + w]
                m = epe_metrics(flow, torch.from_numpy(gt).to(dev),
                                torch.from_numpy(np.asarray(valid, np.float32)
                                                 ).to(dev), reduce="sum")
                direct.append((flow.cpu().numpy(),
                               {k: float(v) for k, v in m.items()}))
            if name == "sintel":
                want_epe = statistics.fmean(m["epe"] / max(m["valid_px"], 1)
                                            for _, m in direct)
                for idx, (flow, m) in enumerate(direct):
                    dumped = read_flo(dump / (ds.dump_name(idx)
                                              .rsplit(".", 1)[0] + ".flo"))
                    e_dump = float(np.sqrt(((dumped - items[idx][3]) ** 2)
                                           .sum(-1)).mean())
                    e_dir = m["epe"] / m["valid_px"]
                    if not abs(e_dump - e_dir) <= 1e-5 * (1 + e_dir):
                        raise AssertionError(f"eval sintel pair {idx}: EPE "
                                             f"{e_dump} vs direct {e_dir}")
            else:
                want_epe = (sum(m["epe"] for _, m in direct)
                            / sum(m["valid_px"] for _, m in direct))
                for idx, (flow, m) in enumerate(direct):
                    back, ok = read_kitti_flow(dump / ds.dump_name(idx))
                    # the format holds [-512, 512) px in steps of 1/64
                    held = np.clip(flow, -2 ** 15 / 64,
                                   (2 ** 16 - 1 - 2 ** 15) / 64)
                    q = float(np.abs(back - held).max())
                    if not (ok.all() and q <= 1 / 64 + 1e-4):
                        raise AssertionError(f"eval kitti pair {idx}: the "
                                             f"PNG read back is {q} px off")
            if not abs(got_m["epe"] - want_epe) <= 1e-5 * (1 + want_epe):
                raise AssertionError(f"eval {name}: harness EPE "
                                     f"{got_m['epe']} vs direct {want_epe}")
            rec[f"eval_kernel_vs_plain_worst_ratio_{name}"] = max(
                hold_eval(label, model, ecfg, *args)
                for label, *args in to_hold)
            # timed again, warm (the first run paid cuDNN's benchmark of
            # the new shapes)
            torch.cuda.synchronize()
            again = evaluate_dataset(model, ecfg, ds, verbose=False, **kw)
            rec[f"eval_{name}"] = got_m
            rec[f"eval_ms_per_pair_{name}"] = (again["seconds"] * 1e3
                                               / again["samples"])
            rec[f"eval_ms_per_pair_first_{name}"] = (
                got_m["seconds"] * 1e3 / got_m["samples"])
            print(f"data eval {name} ({'warm start' if name == 'sintel' else 'bucket 64, pixel, batch 2'}"
                  f", seeded random weights: these EPEs measure an "
                  f"untrained model): {got_m}; held to {len(direct)} "
                  f"direct eval-step calls")
        del model

        # -- 10.5 -m val as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.training", "-m", "val",
             "--dataset", "sintel", "--data", str(sintel), "--max-samples",
             "2"], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        print(proc.stdout.strip().splitlines()[-1] if proc.stdout.strip()
              else proc.stderr[-2000:])
        if proc.returncode != 0:
            raise AssertionError(f"-m val exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        rec["val_cli_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["launches"] = launches
    return rec


# -- 11. the command line: python -m raft_tpu_torch.cli ------------------------

def _cli(argv) -> str:
    """``raft_tpu_torch.cli.main(argv)`` in this process; raises unless it
    exits 0; returns what it printed (echoed with a ``cli:`` prefix)."""
    import contextlib
    import io
    from raft_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        print(f"cli: {ln}")
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}")
    return out


def _official_checkpoint(tree) -> dict:
    """A params tree as an official RAFT ``.pth`` holds it: torch names
    under ``{"model": ...}`` with DataParallel's ``module.`` prefix, a
    ``num_batches_tracked`` per batch norm, and each strided block's
    shortcut norm also under its attribute alias (``norm3``, or ``norm4``
    beside a ``conv3``)."""
    from raft_tpu_torch.convert import to_state_dict
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in to_state_dict(tree).items()}
    extra = {}
    for name, t in sd.items():
        parts = name.split(".")
        if "downsample" in parts and parts[parts.index("downsample") + 1] == "1":
            i = parts.index("downsample")
            block = ".".join(parts[:i])
            alias = "norm4" if f"{block}.conv3.weight" in sd else "norm3"
            extra[".".join(parts[:i] + [alias] + parts[i + 2:])] = t.clone()
        if parts[-1] == "running_mean":
            extra[".".join(parts[:-1] + ["num_batches_tracked"])] = \
                torch.tensor(0, dtype=torch.int64)
    sd.update(extra)
    return {"model": {f"module.{k}": v for k, v in sd.items()}}


def _graph_ops(program) -> list:
    """The ``raft_tpu_torch`` operators in an exported program's graphs."""
    ops = set()
    for mod in program.graph_module.modules():
        if hasattr(mod, "graph"):
            ops |= {str(n.target) for n in mod.graph.nodes
                    if n.op == "call_function"
                    and str(n.target).startswith("raft_tpu_torch.")}
    return sorted(ops)


def _device_kernels(fn) -> int:
    """Kernels the device ran in one ``fn()`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def cli_phases(dev, smi: str, train_step_ms: float) -> dict:
    """Phase 11: ``python -m raft_tpu_torch.cli`` on the card.  ``-m test``
    as a subprocess (cold start, steady ms, its ``.flo`` against the
    captured ``make_inference_fn`` flow in this process) and in process
    (launch counts); every ``--load`` format made from the C1 weights; ``-m
    export`` and its ``.pt2`` run on the card; ``-m flops`` against the
    CPU's count; the NaN sentinel eager and captured, its cost on and off;
    each kernel operator against its wrapper, bitwise; the eager cost of
    the operators' dispatch.  Returns the ``cli`` record and the launches
    of the in-process ``-m test``."""
    import gc
    import re
    import shutil
    import tempfile
    from pathlib import Path
    from raft_tpu_torch import (RAFTConfig, RAFT, cli, init_raft_torch,
                                make_inference_fn)
    from raft_tpu_torch import convert as pconv
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.models.raft import raft_forward, tf32_off
    from raft_tpu_torch.ops import corr_cuda, gru_cuda
    from raft_tpu_torch.ops.coords import coords_grid
    from raft_tpu_torch.telemetry import watchdogs
    from raft_tpu_torch.training.checkpoint import save_checkpoint
    from raft_tpu_torch.training.optim import make_optimizer
    from raft_tpu_torch.training.state import TrainState
    from raft_tpu_torch.utils.flow_io import read_flo

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    wrappers = (corr_cuda.corr_lookup_cuda, gru_cuda.sep_conv_gru_cuda)
    rec = {"device": smi}
    flags = ["--corr-impl", "pallas", "--gru-impl", "pallas", "--iters",
             str(ITERS)]
    # the CPU's FLOP counts, in processes of their own while the card works
    flop_flags = {"raft_things": ["--corr-impl", "pallas", "--gru-impl",
                                  "pallas"],
                  "raft_small": ["--small", "--corr-impl", "pallas"]}
    cpu_flops = {k: subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.cli", "-m", "flops", "--cpu",
         "--run-log", "none", *f], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, f in flop_flags.items()}
    try:
        # -- 11a. every --load format, from the C1 weights ----------------
        cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
        model = init_raft_torch(cfg, generator=torch.Generator().manual_seed(0),
                                device=dev)
        c1_weights(model)
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        tree = pconv.to_jax_params(state)
        files = {"params": tmp / "c1.npz", "pth": tmp / "c1.pth",
                 "torch_npz": tmp / "c1_torch.npz",
                 "tensorpack": tmp / "c1_reference.npz",
                 "trainstate": tmp / "ckpt_1.npz",
                 "params_swapped": tmp / "c1_swapped.npz"}
        pconv.save_params_npz(state, files["params"])
        torch.save(_official_checkpoint(tree), files["pth"])
        np.savez(files["torch_npz"], **pconv.to_state_dict(tree))
        pconv.to_reference_npz(tree, files["tensorpack"])
        host = RAFT(cfg)
        host.load_state_dict(state)
        save_checkpoint(files["trainstate"], TrainState.create(
            host, make_optimizer(TrainConfig.for_stage("chairs"))))
        swapped = pconv.to_jax_params(state)
        pconv.swap_rgb_bgr(swapped)
        pconv.save_params_npz(pconv.from_jax_params(swapped),
                              files["params_swapped"])
        for fmt, path in files.items():
            print(f"cli: {fmt} checkpoint {path.name}: detect_format "
                  f"{pconv.detect_format(path)}")

        def run_test(tag, load, *extra):
            out_dir = tmp / tag
            _cli(["-m", "test", *flags, "--save-flo", "--run-log", "none",
                  "--load", str(load), "--out", str(out_dir), *extra])
            flo = read_flo(out_dir / "raft_flow_raft-things.flo")
            gc.collect()
            torch.cuda.empty_cache()
            return flo

        _reset(*wrappers)
        params_flo = run_test("params", files["params"])
        test_launches = _launches(*wrappers)
        want = {"corr_lookup": 2 * ITERS,
                "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}
        print(f"cli: -m test in process: launches {test_launches} (the "
              f"capture's warm-up and captured forwards, replays none)")
        if test_launches != want:
            raise AssertionError(f"cli -m test launched {test_launches}, "
                                 f"expected {want}")
        # the captured factory on the same pair and weights, in process
        args = cli.build_parser().parse_args(
            ["--load", str(files["params"]), *flags])
        im1, im2 = cli.read_pair(args)
        loaded = cli.load_model(args, cfg)
        direct = make_inference_fn(cfg)(loaded, im1, im2)[0].cpu().numpy()
        same = bool(np.array_equal(direct, params_flo))
        print(f"cli: in-process .flo bitwise equal to make_inference_fn's "
              f"flow: {same}")
        if not same:
            raise AssertionError("the CLI's flow differs from the factory's")
        rgb = {fmt: run_test(f"{fmt}_rgb", files[fmt], "--rgb")
               for fmt in ("params", "pth", "torch_npz", "tensorpack",
                           "trainstate")}
        bgr_swapped = run_test("params_swapped", files["params_swapped"])
        bgr = {fmt: run_test(fmt, files[fmt]) for fmt in ("pth", "torch_npz")}
        formats = {}
        for fmt, flo in rgb.items():
            formats[f"{fmt} --rgb"] = bool(np.array_equal(flo, rgb["params"]))
        for fmt, flo in bgr.items():
            formats[f"{fmt} (swapped to BGR)"] = bool(
                np.array_equal(flo, bgr_swapped))
        print(f"cli: --load formats bitwise equal to the params npz run: {formats}")
        if not all(formats.values()):
            raise AssertionError(f"a --load format's flow differs: {formats}")
        rec["load_formats_bitwise"] = formats
        del loaded

        # -- 11b. -m export, and its program on the card --------------------
        t0 = time.perf_counter()
        _cli(["-m", "export", *flags, "--load", str(files["params"]),
              "--export-reference-npz", "--run-log", "none",
              "--out", str(tmp / "export")])
        rec["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = torch.export.load(str(tmp / "export" / "raft-things.pt2"))
        rec["export_load_s"] = time.perf_counter() - t0
        rec["export_ops"] = _graph_ops(program)
        print(f"cli: .pt2 graph operators {rec['export_ops']}, exported in "
              f"{rec['export_s']:.2f} s, loaded in {rec['export_load_s']:.2f} s")
        if rec["export_ops"] != ["raft_tpu_torch.corr_lookup.default",
                                 "raft_tpu_torch.sep_conv_gru.default"]:
            raise AssertionError("the exported graph lacks the kernel operators")
        t1, t2 = (torch.from_numpy(x).to(dev) for x in (im1, im2))
        _reset(*wrappers)
        with torch.no_grad(), tf32_off():
            got = program.module()(t1, t2)
            eager = raft_forward(model, t1, t2, cfg).flow
        prog_launches = _launches(*wrappers)
        worst, msg = _within("cli: the .pt2 program on the card vs the eager "
                             "forward", got, eager)
        rec["export_program_bitwise"] = bool(torch.equal(got, eager))
        rec["export_program_worst"] = worst
        print(f"{msg}; bitwise {rec['export_program_bitwise']}; launches of "
              f"the program and the eager forward {prog_launches}")
        if not worst <= 1.0 or prog_launches["corr_lookup"] != 2 * ITERS:
            raise AssertionError("the .pt2 program disagrees or ran no kernel")
        for name in ("raft-things.npz", "raft-things.reference.npz"):
            back = pconv.from_jax_params(pconv.load_checkpoint_auto(
                tmp / "export" / name))
            if not all(torch.equal(back[k], v) for k, v in state.items()):
                raise AssertionError(f"{name} does not reload bitwise")
        print("cli: the exported npz and reference npz reload bitwise")
        del program

        # -- 11c. -m flops on the card and on the CPU -----------------------
        rec["flops"] = {}
        for key, f in flop_flags.items():
            card = _cli(["-m", "flops", *f, "--run-log", "none"])
            out, _ = cpu_flops[key].communicate(timeout=600)
            if cpu_flops[key].returncode != 0:
                raise AssertionError(f"-m flops --cpu {key}: {out[-2000:]}")

            def counts(text):
                n = int(text.split("trainable parameters:")[1].split()[0]
                        .replace(",", ""))
                fl = int(re.search(r"total flops: ([\d,]+)", text).group(1)
                         .replace(",", ""))
                return n, fl
            (n, fl), (n_cpu, fl_cpu) = counts(card), counts(out)
            rec["flops"][key] = {"params": n, "flops": fl, "cpu_flops": fl_cpu}
            print(f"cli: -m flops {key} at 1x256x448: {n:,} parameters, "
                  f"{fl:,} FLOPs on the card, {fl_cpu:,} on the CPU")
            if (n, fl) != (n_cpu, fl_cpu):
                raise AssertionError(f"-m flops {key}: card and CPU differ")

        # -- 11d. each kernel operator against its wrapper, bitwise ---------
        k_in = kernel_inputs(np.random.RandomState(0), dev)
        f1, levels, coords = k_in["fmap1"], k_in["levels"], k_in["coords"]
        rf1, rlevels, rcoords, s8 = (k_in[k] for k in
                                     ("rf1", "rlevels", "rcoords", "sizes8"))
        h, mot, ctx = k_in["gru"]
        fw = gru_cuda.fuse_gru_weights(model.update_block.gru, 128, 128)
        kw32 = gru_cuda.prepare_gru_weights(fw, torch.float32)
        ops = torch.ops.raft_tpu_torch
        same_ops = {}
        for dt in (torch.float32, torch.bfloat16):
            tag = "" if dt == torch.float32 else "_bf16"
            a, lv = f1.to(dt), [x.to(dt) for x in levels]
            ra, rlv = rf1.to(dt), [x.to(dt) for x in rlevels]
            pairs_ = {
                "corr_lookup": (ops.corr_lookup(a, lv, coords, 4),
                                corr_cuda.corr_lookup_cuda(a, lv, coords, 4)),
                "corr_window": (ops.corr_window(a, lv, coords, 4),
                                corr_cuda.corr_window_cuda(a, lv, coords, 4)),
                "corr_packed": (ops.corr_packed(a, lv, coords, 4, "all"),
                                corr_cuda.corr_packed_cuda(a, lv, coords, 4)),
                "corr_ragged": (ops.corr_ragged(ra, rlv, rcoords, s8, 4),
                                corr_cuda.corr_ragged_cuda(ra, rlv, rcoords, s8, 4))}
            fw_d = {k: v.to(dt) for k, v in fw.items()}
            kw = gru_cuda.prepare_gru_weights(fw_d, dt)
            hd, md, cd = h.to(dt), mot.to(dt), tuple(c.to(dt) for c in ctx)
            pairs_["sep_conv_gru"] = (
                ops.sep_conv_gru(hd, md, *cd, [fw_d[k] for k in gru_cuda._WEIGHTS],
                                 [kw[k] for k in gru_cuda._WEIGHTS]),
                gru_cuda.sep_conv_gru_cuda(kw, hd, md, cd))
            for name, (x, y) in pairs_.items():
                same_ops[name + tag] = bool(torch.equal(x, y))
        print(f"cli: each operator bitwise its kernel wrapper: {same_ops}")
        if not all(same_ops.values()):
            raise AssertionError("an operator differs from its wrapper")
        rec["operators_bitwise"] = same_ops

        # a NaN operand (CUDA's own NaN, 0x7fffffff) comes out NaN, on the
        # MMA path and on the gather: one query's fmap1 row gives NaN in
        # every window entry of that query at the levels where its window
        # lies in the map (0-2), and nowhere else; one pixel of h gives NaN
        # in the GRU's output there, and not far from it
        cuda_nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(
            torch.float32).item()
        near = (coords_grid(1, H_IMG // 8, W_IMG // 8, device=dev)
                + 0.37).contiguous()
        f1_nan = f1.clone()
        f1_nan[0, 20, 60] = cuda_nan
        nan_same = {}
        for how, ratio in (("MMA", float("inf")), ("gather", 0.0)):
            got_nan = corr_cuda.corr_lookup_cuda(f1_nan, levels, near, 4,
                                                 mma_ratio=ratio).isnan()
            nan_same[f"corr_lookup {how}"] = bool(
                got_nan[0, 20, 60, :3 * 81].all()
                and int(got_nan.sum()) == int(got_nan[0, 20, 60].sum()))
        h_nan = h.clone()
        h_nan[0, 20, 60, 5] = cuda_nan
        out_nan = gru_cuda.sep_conv_gru_cuda(kw32, h_nan, mot, ctx).isnan()
        nan_same["sep_conv_gru"] = bool(out_nan[0, 20, 60].all()
                                        and not out_nan[0, 40, 10].any())
        print(f"cli: a NaN operand comes out NaN: {nan_same}")
        if not all(nan_same.values()):
            raise AssertionError("a kernel turns a NaN operand into a number")
        rec["nan_propagates"] = nan_same

        # host time to issue one call: the operator against the wrapper
        def issue_us(fn, n=200):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = time.perf_counter() - t0
            torch.cuda.synchronize()
            return 1e6 * t / n
        fw_l = [fw[k] for k in gru_cuda._WEIGHTS]
        kw_l = [kw32[k] for k in gru_cuda._WEIGHTS]
        issue = {
            "corr_lookup_op": issue_us(lambda: ops.corr_lookup(f1, levels, coords, 4)),
            "corr_lookup_wrapper": issue_us(
                lambda: corr_cuda.corr_lookup_cuda(f1, levels, coords, 4)),
            "sep_conv_gru_op": issue_us(
                lambda: ops.sep_conv_gru(h, mot, *ctx, fw_l, kw_l)),
            "sep_conv_gru_wrapper": issue_us(
                lambda: gru_cuda.sep_conv_gru_cuda(kw32, h, mot, ctx))}
        rec["host_issue_us"] = issue
        print(f"cli: host microseconds to issue one call: {issue}")

        # the eager requests with the operators and, in turns, with their
        # dispatch bypassed (the wrappers called as before the operators)
        cfg_bf = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas",
                                 compute_dtype="bfloat16",
                                 corr_precision="default", pallas_pack=True,
                                 pallas_p_select="window", pallas_p_blk=1024,
                                 iters=ITERS)
        model_bf = init_raft_torch(cfg_bf, generator=torch.Generator().manual_seed(0),
                                   device=dev)
        ops_now = (corr_cuda.corr_lookup_op, corr_cuda.corr_window_op,
                   corr_cuda.corr_packed_op, corr_cuda.corr_ragged_op,
                   gru_cuda.sep_conv_gru_op)
        raw = (corr_cuda._lookup_kernel, corr_cuda._window_kernel,
               corr_cuda._packed_kernel, corr_cuda._ragged_kernel,
               gru_cuda._gru_kernel)

        def dispatch(bypass: bool) -> None:
            (corr_cuda.corr_lookup_op, corr_cuda.corr_window_op,
             corr_cuda.corr_packed_op, corr_cuda.corr_ragged_op,
             gru_cuda.sep_conv_gru_op) = raw if bypass else ops_now

        def eager_ms(mdl, c):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad():
                raft_forward(mdl, t1, t2, c)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        eager = {}
        try:
            for key, mdl, c in (("main", model, cfg), ("bf", model_bf, cfg_bf)):
                for bypass in (False, True):
                    dispatch(bypass)
                    eager_ms(mdl, c)
                runs = {False: [], True: []}
                for _ in range(8):
                    for bypass in (False, True):
                        dispatch(bypass)
                        runs[bypass].append(eager_ms(mdl, c))
                eager[key] = {"ops_ms": statistics.median(runs[False]),
                              "bypass_ms": statistics.median(runs[True]),
                              "ops_ms_all": runs[False],
                              "bypass_ms_all": runs[True]}
        finally:
            dispatch(False)
        for key, v in eager.items():
            print(f"cli: eager {key} request, {ITERS} iters: through the "
                  f"operators median {v['ops_ms']:.2f} ms, their dispatch "
                  f"bypassed {v['bypass_ms']:.2f} ms")
        rec["eager_request"] = eager
        rec["train_step_ms_median"] = train_step_ms

        # -- 11e. the NaN/Inf sentinel, eager and captured --------------------
        sick = RAFT(cfg).to(dev).eval()
        sick.load_state_dict(model.state_dict())
        with torch.no_grad():
            sick.fnet.conv1.weight[0, 0, 0, 0] = float("nan")
        watchdogs.enable_nan_sentinel(True)
        try:
            with torch.no_grad():
                raft_forward(sick, t1, t2, cfg)
            ev_eager = list(watchdogs.nan_events())
            fn_on = make_inference_fn(cfg)
            ev_cap = []
            for _ in range(2):
                watchdogs.nan_events().clear()
                fn_on(sick, im1, im2)
                ev_cap.append(list(watchdogs.nan_events()))
            stages = [e["stage"] for e in ev_eager]
            print(f"cli: sentinel events eager {len(ev_eager)}, first "
                  f"{ev_eager[:3]}; stages {sorted(set(stages))}; captured "
                  f"(the capturing call, a replay) equal to eager: "
                  f"{[ev == ev_eager for ev in ev_cap]}")
            # the NaN reaches every stage after the encoder: no kernel turns
            # it into a number
            if (stages[0] != "raft/fnet" or "raft/fnet" in stages[1:]
                    or {"raft/corr_lookup", "raft/update"} - set(stages)
                    or any(ev != ev_eager for ev in ev_cap)):
                raise AssertionError("the sentinel's events differ")
            rec["sentinel_events"] = ev_eager[:3]
            fn_on(model, im1, im2)
            guards_on = fn_on.graphs.nan_guards()
        finally:
            watchdogs.enable_nan_sentinel(False)
        fn_off = make_inference_fn(cfg)
        watchdogs.nan_events().clear()
        fn_off(model, im1, im2)
        fn_off(model, im1, im2)
        guards_off = fn_off.graphs.nan_guards()
        if watchdogs.nan_events() or guards_off:
            raise AssertionError("the sentinel off recorded events or guards")
        kern = {"off": _device_kernels(lambda: fn_off(model, im1, im2)),
                "on": _device_kernels(lambda: fn_on(model, im1, im2))}
        cap = {"off": [], "on": []}
        for _ in range(8):
            for key, fn in (("off", fn_off), ("on", fn_on)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(model, im1, im2)
                end.record()
                torch.cuda.synchronize()
                cap[key].append(start.elapsed_time(end))
        rec["sentinel"] = {
            "guards_per_graph": {"off": guards_off, "on": guards_on},
            "device_kernels_per_request": kern,
            "captured_ms_median": {k: statistics.median(v) for k, v in cap.items()},
            "captured_ms_all": cap}
        print(f"cli: captured f32 main with the sentinel off: "
              f"{statistics.median(cap['off']):.2f} ms, {guards_off} guards, "
              f"{kern['off']} device kernels; on: "
              f"{statistics.median(cap['on']):.2f} ms, {guards_on} guards, "
              f"{kern['on']} device kernels")
        del fn_on, fn_off, sick
        gc.collect()
        torch.cuda.empty_cache()

        # -- 11f. the subprocess: a user's command line -----------------------
        cmd = [sys.executable, "-m", "raft_tpu_torch.cli", "-m", "test",
               *flags, "--save-flo", "--load", str(files["params"]),
               "--out", str(tmp / "sub")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600)
        rec["subprocess_wall_s"] = time.perf_counter() - t0
        for ln in proc.stdout.splitlines():
            print(f"cli subprocess: {ln}")
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        m = re.search(r"first call ([\d.]+)s  steady ([\d.]+) ms", proc.stdout)
        rec["subprocess_first_call_s"] = float(m.group(1))
        rec["subprocess_steady_ms"] = float(m.group(2))
        png = tmp / "sub" / "raft_flow_raft-things.png"
        sub = read_flo(tmp / "sub" / "raft_flow_raft-things.flo")
        if not png.is_file():
            raise AssertionError("the CLI wrote no PNG")
        rec["subprocess_flo_bitwise"] = bool(np.array_equal(sub, direct))
        worst, msg = _within("cli subprocess .flo vs the in-process factory",
                             torch.from_numpy(sub)[None],
                             torch.from_numpy(direct)[None])
        rec["subprocess_flo_worst"] = worst
        print(f"{msg}; bitwise {rec['subprocess_flo_bitwise']}"
              + ("" if rec["subprocess_flo_bitwise"] else
                 " (this process runs cuDNN in benchmark mode, the CLI's "
                 "process with its default algorithms)"))
        if not worst <= 1.0:
            raise AssertionError("the CLI subprocess's flow disagrees")
    finally:
        for p in cpu_flops.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"cli: phase 11 took {rec['phase_s']:.1f} s")
    return {"record": rec, "launches": test_launches}


# -- 12. the parallel layer: ring lookup, row-sharded model, DP train/serve --

PAR_MAP_HW = (512, 1024)      # (a): the ring's maps are these images' 1/8
PAR_MODEL_HW = (1024, 1920)   # (b): raft-things row-sharded over 2 ranks
PAR_NCCL_HW = (512, 1024)     # (b): the 1-rank NCCL run
PAR_ITERS_HELD = 3            # (b): per iteration over this many
PAR_TIMED = 2
PAR_CUDNN_TRIES = 3           # the ranks' cuDNN benchmark: algorithms tried


def _par_mark(who: str, t0: float, what: str) -> None:
    """A progress line, flushed at once (the ranks write to a pipe)."""
    print(f"parallel: {who} {what} at {time.perf_counter() - t0:.1f} s",
          flush=True)


def _par_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`_compare`'s check (rtol = atol = 1e-5, finite), silent;
    returns the max abs error, raises with the name."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite")
    err = (got - want).abs()
    if not bool((err <= TOL + TOL * want.abs()).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max_abs_err {float(err.max()):.3e}")
    return float(err.max())


def _par_ring_maps(dev, kind: str):
    """(a)'s seeded whole maps on the card: fmap1 and fmap2 [1, 64, 128,
    256] and the queries' coordinates, 'noisy' (phase 3's kind: +-(r+3) px
    around the grid, an eighth of the queries wholly off the map) or
    'scattered' (windows anywhere, as random-weight flows give: the
    kernel's gather path)."""
    from raft_tpu_torch.ops.coords import coords_grid
    h8, w8 = PAR_MAP_HW[0] // 8, PAR_MAP_HW[1] // 8
    rng = np.random.RandomState(12)
    f1 = rng.randn(1, h8, w8, 256).astype(np.float32)
    f2 = rng.randn(1, h8, w8, 256).astype(np.float32)
    if kind == "noisy":
        noise = rng.uniform(-7, 7, (1, h8, w8, 2))
        far = rng.rand(1, h8, w8) < 0.125
        noise[far] += np.array([-300.0, 700.0])
    else:
        noise = rng.uniform(-w8, w8, (1, h8, w8, 2))
    coords = coords_grid(1, h8, w8, device=dev) + torch.from_numpy(
        noise.astype(np.float32)).to(dev)
    return (torch.from_numpy(f1).to(dev), torch.from_numpy(f2).to(dev),
            coords.contiguous())


def _par_model(cfg, dev, dtype=torch.float32):
    """The phase's seeded weights with C1's biases and affines (phase 6d),
    the same in every process."""
    from raft_tpu_torch import init_raft_torch
    m = init_raft_torch(cfg, generator=torch.Generator().manual_seed(0),
                        device=dev, dtype=dtype)
    c1_weights(m)
    return m


def _par_frames(hw, seed: int):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(1, *hw, 3).astype(np.float32) for _ in range(2))


def _par_batch():
    """(c)'s global batch: the chairs stage's 10 x 368 x 496, seeded."""
    rng = np.random.RandomState(13)
    B, (H, W) = TRAIN_B, TRAIN_HW
    return (rng.rand(B, H, W, 3).astype(np.float32),
            rng.rand(B, H, W, 3).astype(np.float32),
            (3.0 * rng.randn(B, H, W, 2)).astype(np.float32),
            (rng.rand(B, H, W) > 0.3).astype(np.float32))


def _par_configs():
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    spatial = RAFTConfig.full(corr_impl="pallas", gru_impl="xla", iters=ITERS)
    train = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
    return spatial, train, TrainConfig.for_stage("chairs")


PAR_SP_HW, PAR_SP_B = (512, 1024), 2   # (f): the row-sharded step's batch
PAR_SP_TIMED = 2                       # (f): timed steps a rank
PAR_G_HW = (384, 496)                  # (g): the chairs crop, H rounded up
#                                        to required_h_multiple at 1 rank (64)
PAR_G_B = 2                            # (g): the captured steps' batch


def _par_sp_batch(hw=PAR_SP_HW, B=PAR_SP_B, seed=18):
    """(f)'s global batch (and (g)'s sp batch), seeded: frames, flows of a
    few pixels, about 70% of the pixels valid."""
    rng = np.random.RandomState(seed)
    H, W = hw
    return (rng.rand(B, H, W, 3).astype(np.float32),
            rng.rand(B, H, W, 3).astype(np.float32),
            (3.0 * rng.randn(B, H, W, 2)).astype(np.float32),
            (rng.rand(B, H, W) > 0.3).astype(np.float32))


def _par_sp_config(gru_impl: str, iters: int):
    """(f)'s raft-things f32: the B1 ring, ``remat_iters`` on (the chairs
    stage's default), the GRU as asked."""
    from raft_tpu_torch import RAFTConfig
    return RAFTConfig.full(corr_impl="pallas", gru_impl=gru_impl, iters=iters)


def _par_digest(state) -> str:
    """A hash of a train state's parameters, statistics and moments (two
    ranks' states compared bitwise)."""
    import hashlib
    h = hashlib.sha1()
    for t in _state_leaves(state):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


class _Capture:
    """An optimizer that keeps the gradients it is handed (after any
    averaging over the ranks) and then steps."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def update(self, grads, opt_state, params):
        self.grads = [g.detach().clone() for g in grads]
        return self.tx.update(grads, opt_state, params)


def _par_ms(fn, n: int) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _par_wait(go: str, who: str, t0: float) -> None:
    """Wait for the main process's go file (its own work on the card is
    done, so the ranks' timings share the card with each other only)."""
    end = time.perf_counter() + 300
    while not os.path.exists(go):
        if time.perf_counter() > end:
            raise TimeoutError(f"parallel: {who}: no go from the main "
                               f"process within 300 s")
        time.sleep(0.2)
    _par_mark(who, t0, "timings start")


def _parallel_rank(rank: int, world: int, go: str) -> dict:
    """One of phase 12's two ranks, both on cuda:0 over gloo (the device
    passed explicitly: the one way two ranks share a card): first the
    checks of (a) the ring lookups, (b) the row-sharded raft-things and (c)
    the data-parallel train step, then, once the main process's ``go``
    file exists, their timings.  Returns its checks, outputs and times."""
    from raft_tpu_torch.ops import corr_cuda, gru_cuda, spmd
    from raft_tpu_torch.ops.corr import (lookup_blockwise_onehot,
                                         lookup_operands, lookup_packed_plain,
                                         lookup_window_plain)
    from raft_tpu_torch.parallel import (DATA_AXIS, SPATIAL_AXIS, make_mesh,
                                         make_dp_train_step,
                                         make_pjit_train_step,
                                         make_shard_inference_fn, shard_batch,
                                         shard_rows)
    from raft_tpu_torch.parallel.mesh import rank_device
    from raft_tpu_torch.parallel.spatial import make_ring_lookup_local
    from raft_tpu_torch.training import TrainState, make_optimizer
    from raft_tpu_torch.training.step import Batch, pmean_tensors
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    # a rank's cuDNN benchmark of every new training shape is most of its
    # checks' time: it tries the heuristic's first PAR_CUDNN_TRIES
    # algorithms, not 10 (the default)
    torch.backends.cudnn.benchmark_limit = PAR_CUDNN_TRIES
    dev = torch.device("cuda", 0)
    out = {"rank": rank}
    t0 = time.perf_counter()
    who = f"rank {rank}"
    # no quiet sharing: a rank without a card of its own is refused
    try:
        rank_device(rank, world)
        out["own_card"] = True
    except RuntimeError as e:
        out["own_card"] = str(e)
    smesh = make_mesh((SPATIAL_AXIS,), device=dev)
    ax = smesh[SPATIAL_AXIS]
    if not ax.staged:
        raise AssertionError(f"parallel: gloo did not stage: {ax}")

    # (a) the ring lookups, B1 / B3 / B5 in both dtypes, two kinds of coords
    entries = {"corr_lookup": (corr_cuda.corr_lookup_cuda, lookup_blockwise_onehot,
                               {"p_select": "all"}),
               "corr_window": (corr_cuda.corr_window_cuda, lookup_window_plain,
                               {"p_select": "window"}),
               "corr_packed": (corr_cuda.corr_packed_cuda, lookup_packed_plain,
                               {"p_select": "all", "pack_rows": True})}
    ring, timed_rings = {}, {}
    for kind in ("noisy", "scattered"):
        f1, f2, coords = _par_ring_maps(dev, kind)
        hl = f1.shape[1] // world
        rows = slice(rank * hl, (rank + 1) * hl)
        c_loc = coords[:, rows].contiguous()
        for prec, dkey in (("highest", "f32"), ("default", "bf16")):
            F1, LV = lookup_operands(f1, f2, 4, prec)
            f1s = lookup_operands(f1[:, rows], f2[:, rows], 4, prec)[0]
            slabs = [lookup_operands(f1[:, s * hl:(s + 1) * hl],
                                     f2[:, s * hl:(s + 1) * hl], 4, prec)[1]
                     for s in range(world)]
            for name, (wrapper, plain, opts) in entries.items():
                extra = ("all",) if name == "corr_packed" else ()
                rec = {}
                # each slab's kernel partial (shifted coords) against its
                # plain twin, both tile paths forced in turn
                worst = 0.0
                for s in range(world):
                    sh = c_loc.clone()
                    sh[..., 1] -= float(s * hl)
                    p = plain(f1s, slabs[s], sh, 4, *extra)
                    for ratio in (float("inf"), 0.0):
                        k = wrapper(f1s, slabs[s], sh, 4, *extra,
                                    mma_ratio=ratio)
                        worst = max(worst, _par_close(
                            f"parallel (a) {kind} {dkey} {name} rank {rank} "
                            f"slab {s} mma_ratio {ratio}", k, p))
                rec["partial_max_abs_err"] = worst
                lookup = make_ring_lookup_local(
                    f1[:, rows].contiguous(), f2[:, rows].contiguous(), 4, 4,
                    ax, precision=prec, kernel="pallas", pallas_opts=opts)
                whole = wrapper(F1, LV, coords, 4, *extra)[:, rows]
                _reset(wrapper)
                got = lookup(c_loc)
                torch.cuda.synchronize()
                rec["launches"] = wrapper.launches
                if rec["launches"] != world:
                    raise AssertionError(f"parallel (a) {name}: {wrapper.launches}"
                                         f" launches a ring call, want {world}")
                rec["ring_max_abs_err"] = _par_close(
                    f"parallel (a) {kind} {dkey} {name} rank {rank} ring sum "
                    f"vs the whole-map kernel", got, whole)
                print(f"parallel (a) {kind} {dkey} {name} rank {rank}: "
                      f"partials vs plain (MMA and gather paths) "
                      f"{worst:.3e}, ring sum vs whole map "
                      f"{rec['ring_max_abs_err']:.3e} (rtol=atol={TOL:g}) ok",
                      flush=True)
                if kind == "noisy":          # timed below
                    timed_rings[f"{kind}/{dkey}/{name}"] = (lookup, c_loc)
                ring[f"{kind}/{dkey}/{name}"] = rec
        del f1, f2, F1, LV, slabs
    out["ring"] = ring
    _par_mark(who, t0, "(a) checked")

    # (b) raft-things f32 row-sharded at 1x1024x1920 over the two ranks
    cfg_s, cfg_t, tc = _par_configs()
    model = _par_model(cfg_s, dev).eval()
    im1, im2 = _par_frames(PAR_MODEL_HW, 14)
    a, b = shard_rows(im1, smesh), shard_rows(im2, smesh)
    flows = {}
    for k in range(1, PAR_ITERS_HELD + 1):
        flows[k] = make_shard_inference_fn(cfg_s, smesh, iters=k)(
            model, a, b).cpu().numpy()
        _par_mark(who, t0, f"(b) {k} iteration(s)")
    out["flows"] = flows
    _par_mark(who, t0, "(b) checked")

    # (c) the data-parallel train step: the chairs stage, 5 samples a rank.
    # Parity at 3 iterations, as phase 9.2 holds gradients (the recurrence
    # amplifies the two batch sizes' rounding past any bound by 12)
    dmesh = make_mesh((DATA_AXIS,), device=dev)
    local = shard_batch(dmesh, Batch(*_par_batch()))
    tx = make_optimizer(tc)
    cap = _Capture(tx)
    state = TrainState.create(_par_model(cfg_t, dev), tx)
    cfg_3 = dataclasses.replace(cfg_t, iters=PAR_ITERS_HELD)
    state, m = make_dp_train_step(cfg_3, tc, cap, dmesh)(state, local, 0)
    names = [n for n, _ in state.model.named_parameters()]
    out["train"] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
    if rank == 0:
        out["train"]["grads"] = {n: g.cpu().numpy()
                                 for n, g in zip(names, cap.grads)}
        out["train"]["bn"] = {n: v.detach().cpu().numpy()
                              for n, v in state.model.named_buffers()}
    out["train"]["param_sum"] = float(sum(p.detach().double().sum()
                                          for p in state.model.parameters()))
    _par_mark(who, t0, "(c) checked")
    del state
    # the card is shared by this process, the other rank, the NCCL rank and
    # the parent's references: give this rank's cache back before (f)
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the row-sharded train step, dp 1 x sp 2, raft-things f32 at
    # 2x512x1024, 3 iterations, under both GRUs (B2 on the halo'd slab)
    fmesh = make_mesh((DATA_AXIS, SPATIAL_AXIS), shape=(1, world), device=dev)
    flocal = shard_batch(fmesh, Batch(*_par_sp_batch()), DATA_AXIS,
                         SPATIAL_AXIS)
    out["sp"] = {}
    for gi in ("xla", "pallas"):
        cfg_f = _par_sp_config(gi, PAR_ITERS_HELD)
        cap_f = _Capture(tx)
        st = TrainState.create(_par_model(cfg_f, dev), tx)
        step = make_pjit_train_step(cfg_f, tc, cap_f, fmesh,
                                    spatial_axis=SPATIAL_AXIS)
        st, m = step(st, flocal, 0)
        rec = {"loss": float(m["loss"]), "digest": _par_digest(st)}
        if rank == 0:
            rec["grads"] = {n: g.cpu().numpy() for n, g in
                            zip(names, cap_f.grads)}
            rec["bn"] = {n: v.detach().cpu().numpy()
                         for n, v in st.model.named_buffers()}
        out["sp"][gi] = rec
        del st, step, cap_f
        _par_mark(who, t0, f"(f) sp step gru_impl={gi!r} checked")
    # the ring's backward alone (B1, B3, B5, f32): each rank's gradients of
    # its f1 and f2 slabs against the whole-map kernel's vjp
    f1, f2, coords = _par_ring_maps(dev, "noisy")
    hl = f1.shape[1] // world
    rows = slice(rank * hl, (rank + 1) * hl)
    c_loc = coords[:, rows].contiguous()
    ct = torch.from_numpy(np.random.RandomState(19).randn(
        1, f1.shape[1], f1.shape[2], 4 * 81).astype(np.float32)).to(dev)
    ring_bwd = {}
    for name, wrap, opts in (
            ("corr_lookup", corr_cuda.fused_lookup, {"p_select": "all"}),
            ("corr_window", corr_cuda.window_lookup, {"p_select": "window"}),
            ("corr_packed", lambda a, b, c, r: corr_cuda.packed_lookup(
                a, b, c, r, "all"), {"p_select": "all", "pack_rows": True})):
        F1, F2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        n1, lv = lookup_operands(F1, F2, 4, "highest")
        w1, w2 = torch.autograd.grad(wrap(n1, lv, coords, 4), [F1, F2], ct)
        a1 = f1[:, rows].clone().requires_grad_()
        a2 = f2[:, rows].clone().requires_grad_()
        got = make_ring_lookup_local(a1, a2, 4, 4, ax, kernel="pallas",
                                     pallas_opts=opts)(c_loc)
        g1, g2 = torch.autograd.grad(got, [a1, a2], ct[:, rows].contiguous())
        ring_bwd[name] = [
            _par_close(f"parallel (f) ring backward {name} rank {rank} "
                       f"d/d{which}", g, w[:, rows])
            for which, g, w in (("f1", g1, w1), ("f2", g2, w2))]
        print(f"parallel (f) ring backward {name} rank {rank}: d/df1, d/df2 "
              f"vs the whole-map kernel's vjp max abs err {ring_bwd[name]} "
              f"(rtol=atol={TOL:g}) ok", flush=True)
    out["ring_bwd"] = ring_bwd
    del f1, f2, coords, ct, F1, F2, w1, w2, a1, a2, g1, g2
    # B2 on the halo'd slab against the whole-image kernel and the plain twin
    from raft_tpu_torch.ops.gru_cuda import fuse_gru_weights, prepare_gru_weights
    gh, gm, (gc1, gc2) = gru_inputs(np.random.RandomState(20), dev, 1,
                                    PAR_MAP_HW[0] // 8, PAR_MAP_HW[1] // 8)
    fw = fuse_gru_weights(_par_model(_par_sp_config("pallas", 1), dev)
                          .update_block.gru, 128, 128)
    with torch.no_grad():
        fw = {k: v.detach() for k, v in fw.items()}
        kw = prepare_gru_weights(fw, torch.float32)

        def slab(t):
            return t[:, rows].contiguous()
        got = gru_cuda.sep_conv_gru_rows(fw, slab(gh), slab(gm),
                                         (slab(gc1), slab(gc2)), kw, axis=ax)
        whole = gru_cuda.sep_conv_gru(fw, gh, gm, (gc1, gc2), kw)[:, rows]
        plain = gru_cuda.sep_conv_gru_plain(fw, gh, gm, (gc1, gc2))[:, rows]
    out["gru_slab"] = {
        "vs_whole_kernel": _par_close(f"parallel (f) B2 halo'd slab rank "
                                      f"{rank} vs the whole-image kernel",
                                      got, whole),
        "vs_plain": _par_close(f"parallel (f) B2 halo'd slab rank {rank} vs "
                               f"the plain twin", got, plain)}
    print(f"parallel (f) B2 on the halo'd slab rank {rank}: {out['gru_slab']}"
          f" (rtol=atol={TOL:g}) ok", flush=True)
    del gh, gm, gc1, gc2, got, whole, plain
    _par_mark(who, t0, "(f) checked")

    # -- the timings, the card shared by the two ranks alone ----------------
    _par_wait(go, who, t0)
    # (a) a ring call a rank, and its collectives (staged, timed apart)
    for key, (lookup, c_loc) in timed_rings.items():
        rec = ring[key]
        rec["ms"] = _par_ms(lambda: lookup(c_loc), 10)
        spmd.reset_stats(timed=True)
        for _ in range(3):
            lookup(c_loc)
        st = spmd.STATS.snapshot()
        spmd.reset_stats(timed=False)
        rec["staged_bytes_per_call"] = st["staged_bytes"] / 3
        rec["staged_calls_per_call"] = st["staged_calls"] / 3
        rec["collective_ms_per_call"] = st["seconds"] * 1e3 / 3
    del timed_rings
    # (b) the row-sharded forward at 12 iterations: its launches, its own
    # peak above the weights and inputs held, ms, the collectives' share
    fn = make_shard_inference_fn(cfg_s, smesh, iters=ITERS)
    fn(model, a, b)                                  # warm (cuDNN's choices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _reset(corr_cuda.corr_lookup_cuda, gru_cuda.sep_conv_gru_cuda)
    fn(model, a, b)
    torch.cuda.synchronize()
    out["model_launches"] = {"corr_lookup": corr_cuda.corr_lookup_cuda.launches,
                             "sep_conv_gru": gru_cuda.sep_conv_gru_cuda.launches}
    out["model_peak_mib"] = (torch.cuda.max_memory_allocated(dev)
                             - base) / 2 ** 20
    out["model_ms"] = _par_ms(lambda: fn(model, a, b), PAR_TIMED)
    spmd.reset_stats(timed=True)
    ts = time.perf_counter()
    fn(model, a, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    st = spmd.STATS.snapshot()
    spmd.reset_stats(timed=False)
    out["model_collectives"] = {**st, "wall_s": wall,
                                "share": st["seconds"] / wall}
    del model, fn, a, b
    _par_mark(who, t0, "(b) timed")
    # (c) the stage itself, 12 iterations: one step's launches, 3 timed
    state = TrainState.create(_par_model(cfg_t, dev), tx)
    step = make_dp_train_step(cfg_t, tc, cap, dmesh)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(corr_cuda.corr_lookup_cuda, gru_cuda.sep_conv_gru_cuda)
    state, m = step(state, local, 0)
    float(m["loss"])
    out["train_launches"] = {"corr_lookup": corr_cuda.corr_lookup_cuda.launches,
                             "sep_conv_gru": gru_cuda.sep_conv_gru_cuda.launches}
    ms = []
    for i in range(3):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, m = step(state, local, i + 1)
        float(m["loss"])
        ms.append((time.perf_counter() - ts) * 1e3)
    out["train"]["step_ms"] = ms
    grads = cap.grads
    out["train"]["allreduce_ms"] = _par_ms(
        lambda: pmean_tensors(grads, dmesh[DATA_AXIS]), 3)
    out["train"]["allreduce_bytes"] = 4 * sum(g.numel() for g in grads)
    out["train"]["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    _par_mark(who, t0, "(c) timed")
    del state, step
    # (f) the row-sharded step at 12 iterations (B1 ring, B2 slab): the
    # launches, PAR_SP_TIMED timed steps, the last with its collectives
    # timed (forward and backward apart), the peak a rank
    cfg_f = _par_sp_config("pallas", ITERS)
    st = TrainState.create(_par_model(cfg_f, dev), tx)
    step = make_pjit_train_step(cfg_f, tc, cap, fmesh,
                                spatial_axis=SPATIAL_AXIS)
    # no warm-up step: the parity steps above ran every conv's shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(corr_cuda.corr_lookup_cuda, gru_cuda.sep_conv_gru_cuda)
    ms = []
    for i in range(PAR_SP_TIMED):
        # the last step's collectives timed too: under gloo every one of
        # them waits for its host copies anyway, so the timers' syncs add
        # little
        spmd.reset_stats(timed=i == PAR_SP_TIMED - 1)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        st, m = step(st, flocal, i + 1)
        float(m["loss"])
        ms.append((time.perf_counter() - ts) * 1e3)
    wall = ms[-1] / 1e3
    stc = spmd.STATS.snapshot()
    spmd.reset_stats(timed=False)
    out["sp_launches"] = {
        "corr_lookup": corr_cuda.corr_lookup_cuda.launches // PAR_SP_TIMED,
        "sep_conv_gru": gru_cuda.sep_conv_gru_cuda.launches // PAR_SP_TIMED}
    out["sp_launches_total"] = {
        "corr_lookup": corr_cuda.corr_lookup_cuda.launches,
        "sep_conv_gru": gru_cuda.sep_conv_gru_cuda.launches}
    out["sp_timing"] = {
        "step_ms": ms, "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
        "collectives": {**stc, "wall_s": wall},
        "share_fwd": stc["seconds"] / wall, "share_bwd": stc["bwd_seconds"] / wall,
        "loss": float(m["loss"])}
    _par_mark(who, t0, "(f) timed")
    return out


def _nccl_rank(rank: int, world: int) -> dict:
    """(b)'s one rank over NCCL (a process of its own, so that a stuck
    NCCL set-up cannot stall the script past its group's deadline): the
    row-sharded raft-things at 512x1024, each of 3 iterations against the
    single-process forward in the same process."""
    from raft_tpu_torch import raft_forward
    from raft_tpu_torch.ops import spmd
    from raft_tpu_torch.parallel import (SPATIAL_AXIS, make_mesh,
                                         make_shard_inference_fn)
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark_limit = PAR_CUDNN_TRIES
    dev = torch.device("cuda", 0)
    mesh = make_mesh((SPATIAL_AXIS,), device=dev)
    ax = mesh[SPATIAL_AXIS]
    if ax.staged:
        raise AssertionError(f"parallel (b): the NCCL axis stages: {ax}")
    cfg_s = _par_configs()[0]
    model = _par_model(cfg_s, dev).eval()
    u1, u2 = (torch.from_numpy(x).to(dev) for x in _par_frames(PAR_NCCL_HW, 15))
    spmd.reset_stats()
    worst = []
    for k in range(1, PAR_ITERS_HELD + 1):
        got = make_shard_inference_fn(cfg_s, mesh, iters=k)(model, u1, u2)
        with torch.no_grad():
            want = raft_forward(model, u1, u2, cfg_s, iters=k).flow
        w, msg = _within(f"parallel (b) NCCL 1 rank, {k} iterations", got,
                         want)
        print(msg, flush=True)
        worst.append(w)
    out = {**spmd.STATS.snapshot(), "worst_ratio_to_bound": worst,
           "backend": str(dist.get_backend())}
    out["captured"] = _nccl_captures(dev, model, u1, u2)
    return out


def _nccl_captures(dev, model, u1, u2) -> dict:
    """(g): on the one NCCL rank, each of ``make_dp_train_step`` (batch 2
    at the chairs crop, 3 iterations), the dp x sp step (batch 2 at
    384x496, 3 iterations) and ``make_shard_inference_fn`` (512x1024, 12
    iterations) captured as one CUDA graph with its collectives inside:
    the collectives recorded in the graph counted (> 0), and the first
    replay after the capture bitwise equal to the eager call from the same
    state (phase 9's recipe: the replay and the eager step under
    deterministic algorithms).  At one rank the ring and the halos move
    nothing by point to point: no P2P is issued, and none is covered."""
    import copy
    from raft_tpu_torch.ops import spmd
    from raft_tpu_torch.parallel import (DATA_AXIS, SPATIAL_AXIS, make_mesh,
                                         make_dp_train_step,
                                         make_pjit_train_step,
                                         make_shard_inference_fn)
    from raft_tpu_torch.training import TrainState, make_optimizer
    from raft_tpu_torch.training.capture import GraphedTrainStep
    from raft_tpu_torch.training.step import Batch
    cfg_s, cfg_t, tc = _par_configs()
    cfg_3 = dataclasses.replace(cfg_t, iters=PAR_ITERS_HELD)
    tx = make_optimizer(tc)
    cudnn = torch.backends.cudnn

    def deterministic(on: bool):
        torch.use_deterministic_algorithms(on, warn_only=True)
        cudnn.deterministic, cudnn.benchmark = on, not on

    def hold(label, step, batch):
        if not isinstance(step, GraphedTrainStep):
            raise AssertionError(f"parallel (g) {label}: not captured over "
                                 f"NCCL: {type(step)}")
        state = TrainState.create(_par_model(cfg_3, dev), tx)
        spmd.reset_stats()
        state, _ = step(state, batch, 0)          # warm-up, capture, replay
        torch.cuda.synchronize()
        st = spmd.STATS.snapshot()
        deterministic(True)
        try:
            a, b = copy.deepcopy(state), copy.deepcopy(state)
            a, ma = step(a, batch, 1)
            b, mb = step.eager(b, batch, 1)
            torch.cuda.synchronize()
        finally:
            deterministic(False)
        same = all(torch.equal(x, y) for x, y in
                   zip(_state_leaves(a), _state_leaves(b))) and all(
            float(ma[k]) == float(mb[k]) for k in ("loss", "grad_norm"))
        rec = {"collectives_in_graph": st["captured_calls"],
               "p2p_calls": st["p2p_calls"] + st["bwd_p2p_calls"],
               "captures": step.captures, "replay_bitwise_eager": same,
               "loss": float(ma["loss"])}
        print(f"parallel (g) {label}: {rec['collectives_in_graph']} "
              f"collectives recorded in the graph, replay bitwise equal to "
              f"eager: {same}; P2P issued {rec['p2p_calls']} (one rank: the "
              f"ring and the halos exchange nothing, P2P in a graph is not "
              f"covered here)", flush=True)
        if not same or rec["collectives_in_graph"] == 0:
            raise AssertionError(f"parallel (g) {label}: {rec}")
        return rec

    out = {}
    dmesh = make_mesh((DATA_AXIS,), device=dev)
    dbatch = Batch(*(torch.from_numpy(x).to(dev) for x in _par_sp_batch(
        TRAIN_HW, PAR_G_B, 22)))
    out["dp_step"] = hold(f"make_dp_train_step, batch {PAR_G_B} at the chairs "
                          f"crop {TRAIN_HW[0]}x{TRAIN_HW[1]}, {PAR_ITERS_HELD} "
                          f"iterations", make_dp_train_step(cfg_3, tc, tx, dmesh),
                          dbatch)
    del dbatch
    gc.collect()                  # the captured step's pool, back to the card
    torch.cuda.empty_cache()
    smesh = make_mesh((DATA_AXIS, SPATIAL_AXIS), shape=(1, 1), device=dev)
    sbatch = Batch(*(torch.from_numpy(x).to(dev) for x in _par_sp_batch(
        PAR_G_HW, PAR_G_B, 21)))
    out["sp_step"] = hold(
        f"make_pjit_train_step(spatial_axis), batch {PAR_G_B} at "
        f"{PAR_G_HW[0]}x{PAR_G_HW[1]} (368 rounded up to the 1-rank "
        f"required_h_multiple 64), {PAR_ITERS_HELD} iterations",
        make_pjit_train_step(cfg_3, tc, tx, smesh, spatial_axis=SPATIAL_AXIS),
        sbatch)
    del sbatch
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh((SPATIAL_AXIS,), device=dev)
    fn = make_shard_inference_fn(cfg_s, mesh, iters=ITERS)
    if fn.graphs is None:
        raise AssertionError("parallel (g): the shard forward is not captured "
                             "over NCCL")
    spmd.reset_stats()
    got = fn(model, u1, u2)
    torch.cuda.synchronize()
    st = spmd.STATS.snapshot()
    again = fn(model, u1, u2)
    eager = fn.graphs._eager(model, u1, u2)[0]
    same = torch.equal(again, eager) and torch.equal(got, again)
    out["shard_inference"] = {"collectives_in_graph": st["captured_calls"],
                              "p2p_calls": st["p2p_calls"],
                              "replay_bitwise_eager": same,
                              "captures": fn.graphs.captures}
    print(f"parallel (g) make_shard_inference_fn 1x{PAR_NCCL_HW[0]}x"
          f"{PAR_NCCL_HW[1]}, {ITERS} iterations: {st['captured_calls']} "
          f"collectives recorded in the graph, replay bitwise equal to eager: "
          f"{same}; P2P issued {st['p2p_calls']} (one rank)", flush=True)
    if not same or st["captured_calls"] == 0:
        raise AssertionError(f"parallel (g) shard inference: "
                             f"{out['shard_inference']}")
    return out


def _release_captures(namespace: dict) -> int:
    """Drop the captured graphs (and their pools) of every factory found in
    ``namespace`` (a function's locals; containers looked into two levels
    deep), then return the cache to the card.  Returns how many
    factories held graphs."""
    from raft_tpu_torch.models.capture import GraphedForward
    seen, found = set(), []

    def visit(v, depth):
        if id(v) in seen or depth > 2:
            return
        seen.add(id(v))
        g = v if isinstance(v, GraphedForward) else getattr(v, "graphs", None)
        if isinstance(g, GraphedForward) and id(g) not in seen:
            seen.add(id(g))
            found.append(g)
        if isinstance(v, dict):
            for x in v.values():
                visit(x, depth + 1)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x, depth + 1)

    for v in list(namespace.values()):
        visit(v, 0)
    n = 0
    for g in found:
        if g.graph_count():
            n += 1
        g._graphs.clear()
        g.pool = None
    gc.collect()
    torch.cuda.empty_cache()
    return n


def parallel_phases(dev, smi: str) -> dict:
    """Phase 12: the parallel layer on one card.  Two ranks on cuda:0 over
    gloo (``parallel/launch.py``; each CUDA tensor staged through the host,
    counted) run :func:`_parallel_rank`'s checks while this process
    computes the single-process references; then the ranks time their
    paths (the card shared by the two alone), then this process times its
    own: (a) each ring slab's kernel partial against
    its plain twin, both tile paths, and each ring sum against the kernel
    on the whole maps (B1, B3, B5; f32 and bf16; rtol = atol = 1e-5);
    (b) raft-things f32 (``corr_impl='pallas'``, ``gru_impl='xla'``) at
    1x1024x1920, each of 3 iterations against the single-process forward at
    phase 4's bound, its 12-iteration ms, collectives' share and peak per
    rank, and a 1-rank run of the same path over NCCL at 512x1024; (c) the
    chairs stage's data-parallel step (5 samples a rank) against one
    single-process eager step on the whole batch at 3 iterations (loss and
    gradients at phase 9's bounds, batch-norm statistics 1e-5), then 3
    timed steps of the stage and the gradient all-reduce; (d)
    ``make_dp_eval_fn`` over [cuda:0, cuda:0] at 2x432x1024 against the
    factory's batch of 2; (e) ``-m test --spatial 2`` and ``dp_devices=2``
    refused on a one-card machine; (f) the row-sharded train step (dp 1 x
    sp 2) of raft-things at 2x512x1024 under both GRUs against one
    single-process step at 3 iterations, the ring's backward (B1, B3, B5)
    and B2's halo'd slab held at 1e-5, then timed at 12 iterations beside
    the single process; (g) on the NCCL rank, the DP step, the dp x sp
    step and the shard forward captured, collectives inside, each replay
    bitwise equal to eager.  Returns the
    ``parallel`` record and the launches by kernel (``launches``)."""
    import gc
    import shutil
    import tempfile

    from raft_tpu_torch import make_inference_fn, raft_forward
    from raft_tpu_torch.ops import corr_cuda, gru_cuda
    from raft_tpu_torch.parallel import make_dp_eval_fn
    from raft_tpu_torch.parallel.launch import start_ranks
    from raft_tpu_torch.serving.config import ServeConfig
    from raft_tpu_torch.serving.engine import InferenceEngine
    from raft_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from raft_tpu_torch.training.step import Batch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"parallel: {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free "
          f"at the start of phase 12")
    tmp = tempfile.mkdtemp(prefix="chip_par_", dir=os.environ.get("TMPDIR"))
    nccl_group = None
    go = os.path.join(tmp, "go")
    group = start_ranks(_parallel_rank, 2, args=(go,),
                        init_method=f"file://{tmp}/store", backend="gloo",
                        group_timeout_s=300, deadline_s=600)
    try:
        rec = {"device": smi, "ranks": 2, "backend": "gloo, CUDA tensors staged "
               "through the host; both ranks on cuda:0"}
        print("parallel: 2 ranks on cuda:0 over gloo, started", flush=True)
        launches = {"f32": {}, "bf16": {}}

        def add(dkey, name, n):
            launches[dkey][name] = launches[dkey].get(name, 0) + n

        cfg_s, cfg_t, tc = _par_configs()
        # the 1-rank NCCL run of (b), in a process of its own (deadline)
        nccl_group = start_ranks(_nccl_rank, 1,
                                 init_method=f"file://{tmp}/nccl",
                                 backend="nccl", group_timeout_s=120,
                                 deadline_s=400)
        _par_mark("main", t_phase, "ranks started")
        # (f) the single-process eager steps on the whole batch, both GRUs,
        # first: the ranks' own first checks, (a) and (b), are light
        tx = make_optimizer(tc)
        fwhole = Batch(*(torch.from_numpy(x).to(dev) for x in _par_sp_batch()))
        f_ref = {}
        for gi in ("xla", "pallas"):
            cfg_f = _par_sp_config(gi, PAR_ITERS_HELD)
            st = TrainState.create(_par_model(cfg_f, dev), tx)
            capf = _Capture(tx)
            st, m = make_train_step(cfg_f, tc, capf)(st, fwhole, 0)
            f_ref[gi] = {"loss": float(m["loss"]),
                         "grads": {n: g for (n, _), g in
                                   zip(st.model.named_parameters(), capf.grads)},
                         "bn": {n: v.detach().clone()
                                for n, v in st.model.named_buffers()}}
            del st, capf
        # this process's cache goes back to the card after each of its big
        # references: the ranks and the NCCL rank share it meanwhile
        gc.collect()
        torch.cuda.empty_cache()
        _par_mark("main", t_phase, "(f) whole-batch steps done")
        # (b) references while the ranks run: per iteration, and the peak
        model = _par_model(cfg_s, dev).eval()
        im1, im2 = _par_frames(PAR_MODEL_HW, 14)
        t1, t2 = (torch.from_numpy(x).to(dev) for x in (im1, im2))
        ref = {}
        with torch.no_grad():
            for k in range(1, PAR_ITERS_HELD + 1):
                ref[k] = raft_forward(model, t1, t2, cfg_s, iters=k).flow
        torch.cuda.empty_cache()
        _par_mark("main", t_phase, "(b) references done")

        # (c) the single-process eager step on the whole batch
        state = TrainState.create(_par_model(cfg_t, dev), tx)
        cap = _Capture(tx)
        whole = Batch(*(torch.from_numpy(x).to(dev) for x in _par_batch()))
        cfg_3 = dataclasses.replace(cfg_t, iters=PAR_ITERS_HELD)
        state, m = make_train_step(cfg_3, tc, cap)(state, whole, 0)
        sp_loss = float(m["loss"])
        names = [n for n, _ in state.model.named_parameters()]
        sp_grads = dict(zip(names, cap.grads))
        sp_bn = {n: v.detach().clone() for n, v in state.model.named_buffers()}
        del state, cap, whole
        gc.collect()
        torch.cuda.empty_cache()
        _par_mark("main", t_phase, "(c) whole-batch step done")

        # (d) data-parallel serving over [cuda:0, cuda:0], while the ranks run
        cfg_m = cfg_t
        served = _par_model(cfg_m, dev).eval()
        p1, p2 = (np.concatenate([a, b]) for a, b in zip(
            _par_frames((H_IMG, W_IMG), 16), _par_frames((H_IMG, W_IMG), 17)))
        # parity at 3 iterations (the random-weight recurrence amplifies the
        # rounding of two batch sizes' algorithms past any bound by 12)
        want = make_inference_fn(cfg_m, iters=PAR_ITERS_HELD)(served, p1, p2)
        got = make_dp_eval_fn(cfg_m, [dev, dev], iters=PAR_ITERS_HELD)(
            served, p1, p2)
        w, msg = _within(f"parallel (d) dp_eval [cuda:0, cuda:0] vs the batch of "
                         f"2, {PAR_ITERS_HELD} iterations", got, want)
        print(msg, flush=True)
        if w > 1.0:
            raise AssertionError("parallel (d): data-parallel serving disagrees")
        rec["dp_serving"] = {"hw": [H_IMG, W_IMG], "batch": 2,
                             "worst_ratio_to_bound": w}
        del want, got
        gc.collect()
        torch.cuda.empty_cache()
        _par_mark("main", t_phase, "(d) checked")

        # (e) the one-card refusals
        import contextlib
        import io
        from raft_tpu_torch import cli
        refusals = {}
        if torch.cuda.device_count() == 1:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-m", "test", "--spatial", "2", "--size", "512",
                               "1024", "--out", tmp])
            said = buf.getvalue().strip().splitlines()[-1]
            print(f"parallel (e): -m test --spatial 2 -> exit {rc}: {said}")
            if rc != 2 or "needs 2 devices, have 1" not in said:
                raise AssertionError(f"parallel (e): --spatial 2 on one card: "
                                     f"exit {rc}, {said!r}")
            refusals["spatial_2"] = said
            try:
                InferenceEngine(cfg_m, served, ServeConfig(
                    dp_devices=2, buckets=((64, 64),), max_sessions=0))
            except ValueError as e:
                refusals["dp_devices_2"] = str(e)
                print(f"parallel (e): ServeConfig(dp_devices=2) -> {e}")
            else:
                raise AssertionError("parallel (e): dp_devices=2 served on one card")
        else:
            refusals["skipped"] = f"{torch.cuda.device_count()} cards"
        rec["refusals"] = refusals

        nccl = nccl_group.results()[0]
        if (nccl["calls"] == 0 or nccl["staged_calls"]
                or max(nccl["worst_ratio_to_bound"]) > 1.0):
            raise AssertionError(f"parallel (b) NCCL: {nccl}")
        rec["nccl_1_rank_512x1024"] = nccl
        _par_mark("main", t_phase, f"(b) NCCL 1 rank: {nccl['calls']} "
                  f"collectives over {nccl['backend']}, worst "
                  f"{max(nccl['worst_ratio_to_bound']):.3f} of phase 4's bound")
        # this process is done with the card until the ranks have timed
        print(f"parallel: {torch.cuda.mem_get_info(dev)[0] / 2 ** 30:.1f} GiB "
              f"free when the ranks start timing", flush=True)
        open(go, "w").close()
        ranks = group.results()
        _par_mark("main", t_phase, "the ranks' results in")
        # this process's timings, the card its own again: (b) the
        # single-process forward at 12 iterations (ms, its own peak), (d)
        # the served path at 12 iterations (launches, ms)
        with torch.no_grad():
            raft_forward(model, t1, t2, cfg_s, iters=ITERS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            raft_forward(model, t1, t2, cfg_s, iters=ITERS)
            torch.cuda.synchronize()
            single_peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            single_ms = _par_ms(lambda: raft_forward(model, t1, t2, cfg_s,
                                                     iters=ITERS), PAR_TIMED)
        del model, t1, t2
        single = make_inference_fn(cfg_m)
        dp = make_dp_eval_fn(cfg_m, [dev, dev])
        _reset(corr_cuda.corr_lookup_cuda, gru_cuda.sep_conv_gru_cuda)
        dp(served, p1, p2)
        torch.cuda.synchronize()
        dp_launches = {"corr_lookup": corr_cuda.corr_lookup_cuda.launches,
                       "sep_conv_gru": gru_cuda.sep_conv_gru_cuda.launches}
        # one graph at batch 1 serves both halves: its capture counts two
        # eager forwards' launches (warm-up and capture), the replay none
        expect = {"corr_lookup": 2 * ITERS,
                  "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}
        if dp_launches != expect:
            raise AssertionError(f"parallel (d): launches {dp_launches}, want "
                                 f"{expect}")
        for k, v in dp_launches.items():
            add("f32", k, v)
        single(served, p1, p2)
        rec["dp_serving"].update(
            launches=dp_launches,
            ms=_par_ms(lambda: dp(served, p1, p2), PAR_TIMED),
            single_factory_ms=_par_ms(lambda: single(served, p1, p2),
                                      PAR_TIMED))
        del dp, single, served
        # (f) the single process's step on the whole batch at 12 iterations
        cfg_f = _par_sp_config("pallas", ITERS)
        st = TrainState.create(_par_model(cfg_f, dev), tx)
        one = make_train_step(cfg_f, tc, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        st, m = one(st, fwhole, 0)
        float(m["loss"])
        single_sp_peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        single_sp_ms = []
        for i in range(PAR_SP_TIMED):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            st, m = one(st, fwhole, i + 1)
            float(m["loss"])
            single_sp_ms.append((time.perf_counter() - ts) * 1e3)
        del st, one, fwhole
        _par_mark("main", t_phase, "its own timings done")
        for r in ranks:
            if r["own_card"] is not True and r["rank"] == 0:
                raise AssertionError(f"parallel: rank 0 has no card: {r['own_card']}")
        if ranks[1]["own_card"] is True and torch.cuda.device_count() == 1:
            raise AssertionError("parallel: rank 1 got a card of its own on a "
                                 "one-card machine")
        rec["rank1_without_device_arg"] = ranks[1]["own_card"]
        # (a)
        ring = {}
        for key in ranks[0]["ring"]:
            kind, dkey, name = key.split("/")
            per = [r["ring"][key] for r in ranks]
            n = sum(p["launches"] for p in per)
            add(dkey, name, n)
            ring[key] = {"launches": n,
                         "partial_max_abs_err": max(p["partial_max_abs_err"] for p in per),
                         "ring_max_abs_err": max(p["ring_max_abs_err"] for p in per)}
            if kind == "noisy":
                ring[key].update(
                    ms_per_call_rank=[statistics.median(p["ms"]) for p in per],
                    staged_bytes_per_call=per[0]["staged_bytes_per_call"],
                    staged_calls_per_call=per[0]["staged_calls_per_call"],
                    collective_ms_per_call=[p["collective_ms_per_call"] for p in per])
        rec["ring"] = ring
        # (b)
        worst = []
        for k in range(1, PAR_ITERS_HELD + 1):
            got = torch.from_numpy(np.concatenate([r["flows"][k] for r in ranks],
                                                  axis=1)).to(dev)
            w, msg = _within(f"parallel (b) 2 ranks, {k} iterations", got, ref[k])
            print(msg)
            worst.append(w)
        if max(worst) > 1.0:
            raise AssertionError("parallel (b): the row-sharded forward disagrees")
        want_l = {"corr_lookup": 2 * ITERS, "sep_conv_gru": 0}
        for r in ranks:
            if r["model_launches"] != want_l:
                raise AssertionError(f"parallel (b): rank {r['rank']} launches "
                                     f"{r['model_launches']}, want {want_l}")
            add("f32", "corr_lookup", r["model_launches"]["corr_lookup"])
        rec["spatial_1024x1920"] = {
            "worst_ratio_to_bound": worst,
            "ms_median_per_rank": [statistics.median(r["model_ms"]) for r in ranks],
            "ms_all": [r["model_ms"] for r in ranks],
            "collective_share": [r["model_collectives"]["share"] for r in ranks],
            "collectives": [r["model_collectives"] for r in ranks],
            "peak_mib_per_rank": [r["model_peak_mib"] for r in ranks],
            "single_process_peak_mib": single_peak,
            "single_process_ms_median": statistics.median(single_ms),
            "launches_per_rank": want_l}
        # (c)
        r0 = ranks[0]["train"]
        if r0["param_sum"] != ranks[1]["train"]["param_sum"] or \
                r0["loss"] != ranks[1]["train"]["loss"]:
            raise AssertionError("parallel (c): the ranks' updates differ")
        rel = abs(r0["loss"] - sp_loss) / abs(sp_loss)
        print(f"parallel (c): DP loss {r0['loss']:.6f} vs whole batch "
              f"{sp_loss:.6f}, {PAR_ITERS_HELD} iterations (rel {rel:.2e}, "
              f"bound {GRAD_RTOL:g})")
        if rel > GRAD_RTOL:
            raise AssertionError("parallel (c): the DP step's loss disagrees")
        held = hold_grads(f"parallel (c) DP vs whole-batch step, "
                          f"{PAR_ITERS_HELD} iterations",
                          {k: torch.from_numpy(v).to(dev) for k, v in r0["grads"].items()},
                          sp_grads, small=False)
        bn_worst = 0.0
        for k, v in sp_bn.items():
            if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var"):
                continue
            d = float((torch.from_numpy(r0["bn"][k]).to(dev) - v).abs().max())
            bn_worst = max(bn_worst, d / float(v.abs().max()))
        print(f"parallel (c): BN statistics worst {bn_worst:.2e} of a leaf's max "
              f"(bound 1e-5)")
        if bn_worst > 1e-5:
            raise AssertionError("parallel (c): the synchronized BN statistics "
                                 "disagree")
        per_step = {"corr_lookup": 2 * ITERS,
                    "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}
        for r in ranks:
            if r["train_launches"] != per_step:
                raise AssertionError(f"parallel (c): rank {r['rank']} launches "
                                     f"{r['train_launches']}, want {per_step}")
            for k, v in r["train_launches"].items():
                add("f32", k, v)
        rec["dp_train"] = {
            "global_batch": TRAIN_B, "hw": list(TRAIN_HW),
            "parity_iters": PAR_ITERS_HELD, "loss": r0["loss"],
            "single_loss": sp_loss, "loss_rel": rel, "grads": held,
            "bn_worst_rel": bn_worst,
            "step_ms_per_rank": [r["train"]["step_ms"] for r in ranks],
            "allreduce_ms_per_rank": [r["train"]["allreduce_ms"] for r in ranks],
            "allreduce_mib": r0["allreduce_bytes"] / 2 ** 20,
            "peak_mib_per_rank": [r["train"]["peak_mib"] for r in ranks],
            "launches_per_rank_first_step": per_step}
        # (f)
        sp_rec = {}
        for gi in ("xla", "pallas"):
            per = [r["sp"][gi] for r in ranks]
            if len({p["digest"] for p in per}) != 1 or \
                    len({p["loss"] for p in per}) != 1:
                raise AssertionError(f"parallel (f) gru_impl={gi!r}: the "
                                     f"ranks' updated states differ")
            ref = f_ref[gi]
            rel = abs(per[0]["loss"] - ref["loss"]) / abs(ref["loss"])
            print(f"parallel (f) sp step gru_impl={gi!r}: loss "
                  f"{per[0]['loss']:.6f} vs whole batch {ref['loss']:.6f}, "
                  f"{PAR_ITERS_HELD} iterations (rel {rel:.2e}, bound 1e-5); "
                  f"the ranks' states bitwise equal")
            if rel > 1e-5:
                raise AssertionError(f"parallel (f) gru_impl={gi!r}: the sp "
                                     f"step's loss disagrees")
            held = hold_grads(
                f"parallel (f) sp step gru_impl={gi!r} vs whole-batch step, "
                f"{PAR_ITERS_HELD} iterations",
                {k: torch.from_numpy(v).to(dev)
                 for k, v in per[0]["grads"].items()},
                ref["grads"], small=False)
            bn_w = 0.0
            for k, v in ref["bn"].items():
                if k.rsplit(".", 1)[-1] in ("running_mean", "running_var"):
                    d = float((torch.from_numpy(per[0]["bn"][k]).to(dev)
                               - v).abs().max())
                    bn_w = max(bn_w, d / float(v.abs().max()))
            print(f"parallel (f) sp step gru_impl={gi!r}: BN statistics worst "
                  f"{bn_w:.2e} of a leaf's max (bound 1e-5)")
            if bn_w > 1e-5:
                raise AssertionError(f"parallel (f) gru_impl={gi!r}: the BN "
                                     f"statistics disagree")
            sp_rec[gi] = {"loss": per[0]["loss"], "single_loss": ref["loss"],
                          "loss_rel": rel, "grads": held, "bn_worst_rel": bn_w}
        sp_step = {"corr_lookup": 2 * 2 * ITERS,
                   "sep_conv_gru": 2 * ITERS * gru_cuda.LAUNCHES_PER_CALL}
        for r in ranks:
            if r["sp_launches"] != sp_step:
                raise AssertionError(f"parallel (f): rank {r['rank']} launches "
                                     f"{r['sp_launches']}, want {sp_step}")
            for k, v in r["sp_launches_total"].items():
                add("f32", k, v)
        tim = [r["sp_timing"] for r in ranks]
        rec["sp_train"] = {
            "mesh": "dp 1 x sp 2", "global_batch": PAR_SP_B,
            "hw": list(PAR_SP_HW), "parity_iters": PAR_ITERS_HELD,
            "parity": sp_rec,
            "ring_backward_max_abs_err": {k: max(max(r["ring_bwd"][k])
                                                 for r in ranks)
                                          for k in ranks[0]["ring_bwd"]},
            "gru_slab_max_abs_err": {k: max(r["gru_slab"][k] for r in ranks)
                                     for k in ranks[0]["gru_slab"]},
            "launches_per_rank_step": sp_step,
            "step_ms_per_rank": [t["step_ms"] for t in tim],
            "collective_share_fwd": [t["share_fwd"] for t in tim],
            "collective_share_bwd": [t["share_bwd"] for t in tim],
            "collectives": [t["collectives"] for t in tim],
            "peak_mib_per_rank": [t["peak_mib"] for t in tim],
            "single_process_step_ms": single_sp_ms,
            "single_process_peak_mib": single_sp_peak}
        print(f"parallel (f): the sp step at {ITERS} iterations, "
              f"{PAR_SP_B}x{PAR_SP_HW[0]}x{PAR_SP_HW[1]}: "
              f"{rec['sp_train']['step_ms_per_rank']} ms a rank, collectives "
              f"and staging fwd {rec['sp_train']['collective_share_fwd']} bwd "
              f"{rec['sp_train']['collective_share_bwd']} of a step, peak "
              f"{rec['sp_train']['peak_mib_per_rank']} MiB a rank; one "
              f"process {single_sp_ms} ms, peak {single_sp_peak:.0f} MiB; {smi}")
        # (g)
        rec["captured_nccl"] = nccl["captured"]
        rec["phase_s"] = time.perf_counter() - t_phase
        print(f"parallel: phase 12 took {rec['phase_s']:.1f} s; {smi}")
    finally:
        # on any way out: every rank still running killed, the queues shut
        group._stop()
        if nccl_group is not None:
            nccl_group._stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"record": rec, "launches": launches}


# -- 13. the fleet: serve processes on the card behind the port's router -----

FLEET_ARGS = ("--corr-impl", "pallas", "--gru-impl", "pallas",
              "--iters", str(ITERS), "--buckets", f"{H_IMG}x{W_IMG}",
              "--max-batch", "1", "--max-sessions", "2", "--port", "0",
              "--pin-cpus", "--health-poll-s", "0.5")
# the warm grid of FLEET_ARGS: pair, encode, stream, szero, sbatch and
# scommit, each at batch 1 (lint/budget.py::enumerate_warmup_grid)
FLEET_KEYS = 6


def _tree_copy() -> "Path":
    """A copy of the package in a new directory: no ``build/`` beside it,
    so nothing is built there yet."""
    import shutil
    import tempfile
    from pathlib import Path
    tree = Path(tempfile.mkdtemp(prefix="raft_fleet_tree_"))
    shutil.copytree(Path(__file__).resolve().parent / "raft_tpu_torch",
                    tree / "raft_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tree


def _pids_of(needle: str) -> list:
    """Pids of the live processes whose command line holds ``needle``."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if needle in cmd:
            out.append(int(d))
    return out


class _Fleet:
    """One ``python -m raft_tpu_torch.cli -m serve_fleet`` launcher run
    from ``tree`` (PYTHONPATH pinned to it), its output in
    ``<out>.log``; the constructor returns once the router listens."""

    def __init__(self, tree, out, extra, timeout_s: float):
        import re
        self.tree, self.out = tree, out
        self.log = out.with_name(out.name + ".log")
        env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=str(tree))
        self.t0 = time.time()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "raft_tpu_torch.cli", "-m",
                 "serve_fleet", *FLEET_ARGS, *extra, "--out", str(out)],
                cwd=tree, env=env, stdout=log, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + timeout_s
        while True:
            text = self.log.read_text()
            m = re.search(r"\[fleet\] router listening on (\S+)", text)
            if m:
                self.url = m.group(1)
                break
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise AssertionError(
                    f"fleet {out.name}: no router after "
                    f"{time.time() - self.t0:.0f} s (exit "
                    f"{self.proc.returncode}); its log ends:\n{text[-3000:]}"
                    + "".join(f"\nreplica log {p}:\n{p.read_text()[-3000:]}"
                              for p in sorted(out.glob("replica-*/serve.log"))))
            time.sleep(0.2)
        self.ready_s = time.time() - self.t0

    def health(self) -> dict:
        return json.loads(_http(self.url + "/healthz", None)[1])

    def replicas(self) -> dict:
        """{idx: url} of the routable replicas."""
        return {r["idx"]: r["url"] for r in self.health()["replicas"]
                if r["state"] in ("ready", "degraded")}

    def boot(self, idx: int) -> dict:
        """Replica ``idx``'s ``[serve] boot`` record (its serve.log)."""
        for line in (self.out / f"replica-{idx}" / "serve.log").read_text(
                ).splitlines():
            if line.startswith("[serve] boot "):
                return json.loads(line[len("[serve] boot "):])
        raise AssertionError(f"replica {idx} printed no boot line")

    def launches(self, url: str) -> dict:
        """A replica's kernel launches (its /metrics)."""
        import re
        text = _http(url + "/metrics", None)[1].decode()
        return {m.group(1): int(float(m.group(2))) for m in re.finditer(
            r'^raft_kernel_launches\{kernel="(\w+)"\} (\S+)$', text, re.M)}

    def stop(self) -> None:
        """SIGTERM the launcher (it drains and stops its replicas), then
        SIGKILL whatever of this fleet is left."""
        import signal
        _drop_conns()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(90)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        for pid in _pids_of(f"--out {self.out}/replica-"):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _card_used_mib() -> int:
    """The card's used memory, MiB, as ``nvidia-smi`` reads it (every
    process on it, CUDA contexts included)."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def fleet_phases(dev, smi: str) -> dict:
    """Phase 13: ``python -m raft_tpu_torch.cli -m serve_fleet`` on the
    card — raft-things f32 at full width with the kernels (``--corr-impl
    pallas --gru-impl pallas``), bucket 432x1024, 12 iterations, streaming
    on, seeded weights with C1's biases saved as a native npz and given by
    ``--load``, every replica a process of its own on cuda:0.

    (a) cold boot: a fleet of 2 on an empty ``--engine-cache-dir`` from a
    copy of the package with no ``build/``: replica 0 builds the kernels
    (a compiler run) and writes an entry per key, each replica's boot
    split into its parts.  (b) warm boot on the filled directory, from a
    new copy with no ``build/``: every replica hits on every key, misses 0,
    runs no compiler (the kernel objects come from the cache).  (c)
    routing: seeded pairs through the router from 2 clients at once, each
    response tagged with its replica and bitwise that replica's own answer
    to the pair (asked directly), and each held bitwise to a captured
    call of this process on the same weights; the phase fails when this
    process's probe digest of the pair key is not the cache entry's (its
    graph computes other bits, which no tolerance at 12 iterations can
    judge).  (d) a rolling /admin/reload of new weights
    through the router while a client sends a pair: no request fails,
    each answer bitwise the old or the new weights' flow of its replica,
    no replica captures at serve time.  (e) SIGKILL the replica a stream
    session is pinned to: its next advance migrates, bitwise the flow of
    a session opened on the survivor with the same previous frame and
    advanced with the same frame; the respawn boots from the cache with
    misses 0.  (f) pairs/s through the router at 4 clients, 2 windows
    with 2 replicas and, after ``POST /admin/scale?replicas=1`` retired
    one, 2 with 1; at 1 client, the HTTP latency through the router and
    direct to a replica, windows of each taken in turns; the card's memory
    with 2 replicas (nvidia-smi's used memory over this process's own,
    and each replica's allocator).  The replicas' kernel
    launches (their /metrics, read before each replica stops) are the
    phase's launches.  Every fleet is stopped in ``finally``."""
    import shutil
    import signal
    import tempfile
    from pathlib import Path
    from raft_tpu_torch import RAFT, RAFTConfig, init_raft_torch, make_inference_fn
    from raft_tpu_torch.convert.weights import (from_jax_params,
                                                load_params_npz,
                                                save_params_npz)
    from raft_tpu_torch.serving.aot_cache import digest_outputs, probe_rng

    t_phase = time.perf_counter()

    def mark(what):
        print(f"fleet: {what} at {time.perf_counter() - t_phase:.1f} s "
              f"into phase 13", flush=True)
    torch.cuda.empty_cache()
    used0 = _card_used_mib()              # this process alone on the card
    work = Path(tempfile.mkdtemp(prefix="raft_fleet_"))
    trees = []
    cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", iters=ITERS)
    wpath = {}
    for tag, seed in (("old", 13), ("new", 14)):
        m = init_raft_torch(cfg, generator=torch.Generator().manual_seed(seed),
                            device="cpu", dtype=torch.float32)
        c1_weights(m, seed=1000 + seed)
        wpath[tag] = work / f"weights_{tag}.npz"
        save_params_npz(m.state_dict(), wpath[tag])
    cache = work / "engine-cache"
    common = ["--load", str(wpath["old"]), "--engine-cache-dir", str(cache)]
    launches = {"corr_lookup": 0, "sep_conv_gru": 0}
    boots = []                      # every replica boot's record

    def take_launches(fleet, url):
        for k, v in fleet.launches(url).items():
            if k in launches:
                launches[k] += v

    def new_fleet(name, extra, timeout_s):
        trees.append(_tree_copy())
        fl = _Fleet(trees[-1], work / name, common + extra, timeout_s)
        fleets.append(fl)
        return fl

    rec = {"device": smi, "keys_per_replica": FLEET_KEYS}
    fleets = []
    try:
        # (a) cold boot
        fa = new_fleet("cold", ["--replicas", "2"], 600)
        mark(f"(a) cold fleet ready in {fa.ready_s:.1f} s")
        cold = {i: fa.boot(i) for i in fa.replicas()}
        for i, b in sorted(cold.items()):
            print(f"fleet: (a) cold replica {i} boot: {json.dumps(b)}")
        assert (cold[0]["compiler_runs"] > 0
                and cold[0]["kernels"] == "built"), cold[0]
        assert cold[0]["engine_cache"]["saves"] == FLEET_KEYS, cold[0]
        boots += [("cold", i, b) for i, b in sorted(cold.items())]
        for url in fa.replicas().values():
            take_launches(fa, url)
        fa.stop()
        mark("(a) cold fleet stopped")

        # (b) warm boot from a copy with no build/
        fb = new_fleet("warm", ["--replicas", "2"], 300)
        mark(f"(b) warm fleet ready in {fb.ready_s:.1f} s")
        warm = {i: fb.boot(i) for i in fb.replicas()}
        boots += [("warm", i, b) for i, b in sorted(warm.items())]
        for i, b in sorted(warm.items()):
            print(f"fleet: (b) warm replica {i} boot: {json.dumps(b)}")
        for i in sorted(cold):
            print(f"fleet: spawn to ready, replica {i}: cold "
                  f"{cold[i]['spawn_to_ready_s']:.2f} s, warm "
                  f"{warm[i]['spawn_to_ready_s']:.2f} s")
        ec = fb.health()
        print(f"fleet: (b) router /healthz: {json.dumps(ec)}")
        stats = [(w, i, b["engine_cache"]) for w, i, b in boots]
        print(f"fleet: probe digests: " + "; ".join(
            f"{w} replica {i}: hits {e['hits']} misses {e['misses']} "
            f"mismatches {e['mismatches']}" for w, i, e in stats))
        for i, b in warm.items():
            e = b["engine_cache"]
            assert (e["hits"] == FLEET_KEYS and e["misses"] == 0
                    and b["compiler_runs"] == 0
                    and b["kernels"] == "found"), (i, b)
        rec["cold"] = cold
        rec["warm"] = warm

        # (c) routing
        reps = fb.replicas()
        rng = np.random.RandomState(130)
        pairs = [tuple(rng.rand(H_IMG, W_IMG, 3).astype(np.float32)
                       for _ in range(2)) for _ in range(3)]

        def flow_of(url, k):
            hdr = {}
            _, body = _http(url + "/v1/flow", _npz(image1=pairs[k][0],
                                                   image2=pairs[k][1]),
                            headers=hdr)
            return hdr.get("X-Raft-Replica"), _unnpz(body)["flow"]
        own = {(i, k): flow_of(url, k)[1] for i, url in reps.items()
               for k in range(len(pairs))}
        _drop_conns()

        def client(c):
            return [(k, *flow_of(fb.url, k)) for _ in range(2)
                    for k in range(len(pairs))]
        routed = [x for got in _clients(2, client) for x in got]
        used = sorted({int(r) for _, r, _ in routed})
        for k, r, f in routed:
            assert np.array_equal(f, own[(int(r), k)]), (k, r)
        print(f"fleet: (c) {len(routed)} routed answers from replicas "
              f"{used}, each bitwise its replica's own answer")
        model = RAFT(cfg)
        model.load_state_dict(from_jax_params(load_params_npz(wpath["old"])),
                              strict=True)
        model = model.to(dev).eval()
        direct_fn = make_inference_fn(cfg, iters=ITERS, device=dev)
        entry = json.loads(next(
            (cache).glob(f"*/pair-{H_IMG}x{W_IMG}-b1-*.bin")).read_text())
        prng = probe_rng(int(entry["seed"]))
        p1, p2 = (prng.rand(1, H_IMG, W_IMG, 3).astype(np.float32)
                  for _ in range(2))
        own_digest = digest_outputs(direct_fn(model, p1, p2))
        same = own_digest == entry["digest"]
        worst = 0.0
        for (i, k), f in sorted(own.items()):
            want = direct_fn(model, pairs[k][0][None],
                             pairs[k][1][None])[0].cpu().numpy()
            worst = max(worst, float(np.abs(f - want).max()))
        print(f"fleet: (c) this process's probe digest of the pair key "
              f"{'equals' if same else 'differs from'} the replicas' entry; "
              f"largest |fleet - direct| {worst:.3g} over {len(own)} answers")
        assert same, ("(c) this process's captured graph computes other bits "
                      "than the replicas' (cuDNN chose other algorithms); "
                      "at 12 iterations no tolerance can hold the answers")
        assert worst == 0.0, worst
        rec["routing"] = {"answers": len(routed), "replicas": used,
                          "direct_digest_equal": same,
                          "direct_max_abs_diff": worst}
        del model, direct_fn
        torch.cuda.empty_cache()
        mark("(c) routing checked")

        # (d) rolling hot swap under a client
        new_body = wpath["new"].read_bytes()
        old0 = {i: own[(i, 0)] for i in reps}
        stop_client = threading.Event()
        seen = []

        def swap_client(_):
            while not stop_client.is_set():
                seen.append(flow_of(fb.url, 0))
        errors = []

        def run_client():
            try:
                _clients(1, swap_client)
            except BaseException as e:      # noqa: BLE001 — raised below
                errors.append(e)
        th = threading.Thread(target=run_client)
        th.start()
        time.sleep(0.5)
        t_roll = time.perf_counter()
        _, body = _http(fb.url + "/admin/reload", new_body, timeout=300)
        roll_s = time.perf_counter() - t_roll
        roll = json.loads(body)
        time.sleep(0.5)
        stop_client.set()
        th.join(120)
        if errors:
            raise errors[0]
        assert roll["status"] == "reloaded", roll
        new0 = {i: flow_of(url, 0)[1] for i, url in reps.items()}
        n_old = n_new = 0
        for r, f in seen:
            if np.array_equal(f, old0[int(r)]):
                n_old += 1
            else:
                assert np.array_equal(f, new0[int(r)]), r
                n_new += 1
        misses = {i: _metric(_http(url + "/metrics", None)[1].decode(),
                             "raft_serving_compile_cache_misses_total")
                  for i, url in reps.items()}
        assert all(v == 0 for v in misses.values()), misses
        assert all(not np.array_equal(old0[i], new0[i]) for i in reps)
        print(f"fleet: (d) rolling reload in {roll_s:.2f} s "
              f"({[r['status'] for r in roll['replicas']]}); {len(seen)} "
              f"answers during it, none failed: {n_old} old, {n_new} new "
              f"weights' flow; serve-time captures {misses}")
        rec["hot_swap"] = {"roll_s": roll_s, "answers": len(seen),
                           "old": n_old, "new": n_new,
                           "serve_time_captures": misses}
        mark("(d) hot swap checked")

        # (e) SIGKILL the replica a stream session is pinned to
        frames = [rng.rand(H_IMG, W_IMG, 3).astype(np.float32)
                  for _ in range(3)]
        hdr = {}
        _, body = _http(fb.url + "/v1/stream", _npz(op=np.asarray("open"),
                                                    image=frames[0]),
                        headers=hdr)
        sid, pinned = str(_unnpz(body)["session"]), int(hdr["X-Raft-Replica"])
        hdr = {}
        _http(fb.url + "/v1/stream", _npz(session=np.asarray(sid),
                                          image=frames[1]), headers=hdr)
        assert int(hdr["X-Raft-Replica"]) == pinned
        take_launches(fb, reps[pinned])
        (pid,) = _pids_of(f"--out {fb.out}/replica-{pinned} ")
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        hdr = {}
        _, body = _http(fb.url + "/v1/stream", _npz(session=np.asarray(sid),
                                                    image=frames[2]),
                        headers=hdr)
        got = _unnpz(body)
        survivor = int(hdr["X-Raft-Replica"])
        migrate_s = time.perf_counter() - t_kill
        assert bool(got["migrated"]) and survivor != pinned, (got, survivor)
        # migration is open(previous frame) + advance on the survivor: a
        # session opened there on frames[1] and advanced with frames[2]
        # runs the same graphs on the same weights
        _, body = _http(reps[survivor] + "/v1/stream",
                        _npz(op=np.asarray("open"), image=frames[1]))
        fresh = str(_unnpz(body)["session"])
        _, body = _http(reps[survivor] + "/v1/stream",
                        _npz(session=np.asarray(fresh), image=frames[2]))
        want = _unnpz(body)["flow"]
        _http(reps[survivor] + "/v1/stream", _npz(op=np.asarray("close"),
                                                  session=np.asarray(fresh)))
        assert np.array_equal(got["flow"], want), float(
            np.abs(got["flow"] - want).max())
        print(f"fleet: (e) replica {pinned} killed; the session's next "
              f"advance migrated to replica {survivor} in {migrate_s:.2f} s, "
              f"bitwise a session opened there on the same frames")
        deadline = time.monotonic() + 240
        while not set(fb.replicas()) - set(reps):
            assert time.monotonic() < deadline, "no respawn in 240 s"
            time.sleep(0.5)
        respawned = max(fb.replicas())
        rb = fb.boot(respawned)
        boots.append(("respawn", respawned, rb))
        print(f"fleet: (e) respawned replica {respawned} ready "
              f"{time.perf_counter() - t_kill:.1f} s after the kill; its "
              f"boot: {json.dumps(rb)}")
        assert (rb["engine_cache"]["misses"] == 0
                and rb["compiler_runs"] == 0), rb
        _http(fb.url + "/v1/stream", _npz(op=np.asarray("close"),
                                          session=np.asarray(sid)))
        rec["death"] = {"killed": pinned, "survivor": survivor,
                        "migrate_s": migrate_s,
                        "migrated_bitwise_fresh_session": True,
                        "respawn": rb}
        mark("(e) death and respawn checked")

        # (f) timings with 2 replicas, then 1
        def timed(url):
            def request(c, i):
                t0 = time.perf_counter()
                _http(url + "/v1/flow", _npz(image1=pairs[i % 3][0],
                                             image2=pairs[i % 3][1]))
                return (time.perf_counter() - t0) * 1e3
            return request
        reps = fb.replicas()
        two, _ = _windows(4, timed(fb.url), n_win=1, secs=3.0)
        _drop_conns()
        # one client, router and direct (replica min(reps)) in turns
        lat = {"router": [], "direct": []}
        turns = {"router": [], "direct": []}
        for _ in range(2):
            for via, url in (("router", fb.url), ("direct", reps[min(reps)])):
                win, every = _windows(1, timed(url), n_win=1, secs=3.0)
                lat[via] += every
                turns[via].append(win[0]["ms_median"])
        _drop_conns()
        used2 = _card_used_mib()
        rep_mib = {i: fb.boot(i)["cuda_reserved_mib"] for i in reps}
        for url in reps.values():
            take_launches(fb, url)
        _, body = _http(fb.url + "/admin/scale?replicas=1", b"")
        assert json.loads(body)["desired"] == 1
        assert len(fb.replicas()) == 1
        one, _ = _windows(4, timed(fb.url), n_win=1, secs=3.0)
        _drop_conns()
        fb.stop()
        med = {via: statistics.median(v) for via, v in lat.items()}
        p90 = {via: float(np.percentile(v, 90)) for via, v in lat.items()}
        per_s = {n: [w["per_s"] for w in ws] for n, ws in (("2", two),
                                                           ("1", one))}
        rec["timings"] = {
            "pairs_per_s_4_clients": per_s,
            "windows": {"2": two, "1": one},
            "http_ms_1_client": {
                via: {"requests": len(lat[via]), "median": med[via],
                      "p90": p90[via], "turn_medians": turns[via]}
                for via in lat},
            "card_mib": {"two_replicas": used2 - used0,
                         "reserved_by_replica": rep_mib}}
        print(f"fleet: (f) pairs/s through the router at 4 clients, per "
              f"3 s window: {per_s['2']} with 2 replicas, {per_s['1']} "
              f"with 1; at 1 client, HTTP median (p90) {med['router']:.2f} "
              f"({p90['router']:.2f}) ms through the router over "
              f"{len(lat['router'])} requests, {med['direct']:.2f} "
              f"({p90['direct']:.2f}) ms direct over {len(lat['direct'])}, "
              f"per-turn medians {turns}; card memory of 2 replicas "
              f"{used2 - used0} MiB (nvidia-smi, over this process's "
              f"{used0}), their allocators {rep_mib} MiB; {smi}")
    finally:
        for fl in fleets:
            fl.stop()
        _drop_conns()
        for tree in trees:
            shutil.rmtree(tree, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    hits = sum(b["engine_cache"]["hits"] for _, _, b in boots)
    loads = sum(b["engine_cache"]["loads"] for _, _, b in boots)
    mism = sum(b["engine_cache"]["mismatches"] for _, _, b in boots)
    rec["digests"] = {"boots": len(boots), "entries_checked": loads,
                      "matched": hits, "mismatched": mism}
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: probe digests over {len(boots)} boots: {hits} of {loads} "
          f"entries checked matched bitwise, {mism} differed; replicas' "
          f"launches {launches}; phase 13 took {rec['phase_s']:.1f} s; {smi}")
    return rec


# -- 14. the lint on the card: envelopes, graph pools, contracts, spans --

POOL_TOL = 0.20                  # static graph-pool price vs the measured
SPAN_CLIENTS, SPAN_REQUESTS = 8, 96


def start_pricing() -> subprocess.Popen:
    """The graph pools' static prices (``lint/budget.py``, fake tensors on
    the CPU) of phase 8's S1 and phase 9's f32 chairs step, computed in a
    process of its own beside the build; :func:`lint_phases` reads its one
    JSON line."""
    code = (
        "import json, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from raft_tpu_torch.config import RAFTConfig, TrainConfig\n"
        "from raft_tpu_torch.lint import budget\n"
        "from raft_tpu_torch.serving import ServeConfig\n"
        "cfg = RAFTConfig.full(corr_impl='pallas', gru_impl='pallas', "
        f"iters={ITERS})\n"
        f"sc = ServeConfig(buckets=(({H_IMG}, {W_IMG}),), max_batch=4, "
        "max_sessions=4)\n"
        "s1 = budget.serving_pool_prices(cfg, sc)\n"
        "tc = TrainConfig.for_stage('chairs')\n"
        "tr = budget.train_pool_price(cfg, tc, tc.batch_size, "
        "*tc.image_size)\n"
        "print(json.dumps({'s1': s1, 'train_f32': tr}))\n")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _ptxas_registers() -> dict:
    """{demangled kernel instantiation: registers} from the build's ptxas
    report (``c++filt`` demangles; None when it is missing)."""
    from raft_tpu_torch import _build
    regs, names = {}, []
    for stem in ("corr_lookup", "sep_conv_gru"):
        log = _build.build_dir() / f"{stem}.log"
        entry = None
        for ln in log.read_text().splitlines():
            if "Compiling entry function" in ln and "'" in ln:
                entry = ln.split("'")[1]
            elif "Used " in ln and entry is not None:
                n = int(ln.split("Used ")[1].split()[0])
                regs[entry] = n
                names.append(entry)
                entry = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    plain = {}
    for mangled, dem in zip(names, out):
        # "void (anonymous namespace)::corr_lookup_kernel<float, true, 2,
        # false>(...)": keep "corr_lookup_kernel<float, true, 2, false>"
        dem = dem.replace("(anonymous namespace)::", "")
        head = dem.split("(")[0]
        plain[head[5:] if head.startswith("void ") else head] = regs[mangled]
    return plain


def lint_phases(dev, smi: str, pricing: subprocess.Popen,
                measured_pools: dict) -> dict:
    """Phase 14 (module docstring): the lint's envelopes, pool prices and
    contracts held on the card, and the span accounting of C8's regime."""
    t0 = time.perf_counter()
    rec = {"device": smi, "envelopes": lint_envelopes()}
    rec["envelopes_s"] = time.perf_counter() - t0
    rec.update(lint_pools(pricing, measured_pools))
    rec["contracts"] = lint_contracts(dev)
    rec["span_accounting"] = lint_spans(dev)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"lint: phase 14 took {rec['phase_s']:.1f} s; {smi}")
    return rec


def lint_envelopes() -> list:
    """(a) every kernel entry's envelope: the Python mirror equal to the
    source's query and to the runtime's attributes and occupancy."""
    import ctypes

    from raft_tpu_torch import RAFTConfig, _build
    from raft_tpu_torch.lint import budget
    ptxas = _ptxas_registers()
    lims = budget.H100_LIMITS
    out_t = ctypes.POINTER(ctypes.c_int)
    corr_query = _build.load("corr_lookup.cu").corr_lookup_envelope
    corr_query.argtypes = [ctypes.c_int] * 5 + [out_t]
    gru_query = _build.load("sep_conv_gru.cu").sep_conv_gru_envelope
    gru_query.argtypes = [ctypes.c_int] * 3 + [out_t]
    corr_query.restype = gru_query.restype = ctypes.c_int
    rows = []
    for cfg_name, cfg in (("full", RAFTConfig.full()),
                          ("small", RAFTConfig.small_model())):
        for e in budget.kernel_envelopes(cfg)["entries"]:
            if cfg_name == "small" and e["kernel"] == "B2":
                continue                  # raft-small runs no GRU kernel
            bf16 = int(e["entry"].endswith("bf16"))
            out = (ctypes.c_int * 12)()
            if e["kernel"] == "B2":
                err = gru_query(bf16, e["launch"], 1, out)
            else:
                err = corr_query(bf16, int(e["kernel"] == "B4"),
                                 cfg.fnet_dim, cfg.corr_radius, 1, out)
            if err:
                raise AssertionError(f"lint: {e['entry']} envelope query "
                                     f"returned cudaError {err}")
            q = list(out)
            got = {"dynamic_smem": q[0], "threads": q[1],
                   "launch_bounds_min_blocks": q[2], "static_smem": q[8]}
            want = {k: e[k] for k in got}
            if e["kernel"] != "B2":
                got.update(opt_in_smem=q[3], vec=q[4], nv=q[5], mma=q[6])
                want.update({k: e[k] for k in ("opt_in_smem", "vec", "nv",
                                               "mma")})
            if got != want:
                raise AssertionError(f"lint: {cfg_name} {e['entry']}#"
                                     f"{e['launch']}: the mirror {want} != "
                                     f"the source's query {got}")
            regs = q[7]
            if ptxas.get(e["instantiation"]) not in (None, regs):
                raise AssertionError(f"lint: {e['instantiation']}: ptxas "
                                     f"{ptxas[e['instantiation']]} registers"
                                     f" != cudaFuncGetAttributes' {regs}")
            blocks, limiter = budget.blocks_per_sm(
                e["threads"], e["dynamic_smem"] + e["static_smem"], regs)
            if blocks != q[11]:
                raise AssertionError(f"lint: {e['instantiation']}: "
                                     f"{blocks} blocks an SM by the mirror "
                                     f"({limiter}), the occupancy API says "
                                     f"{q[11]}")
            smem = e["dynamic_smem"] + e["static_smem"]
            if smem > lims["smem_per_block"] \
                    or blocks < e["launch_bounds_min_blocks"]:
                raise AssertionError(f"lint: {e['instantiation']}: {smem} B "
                                     f"a block, {blocks} blocks an SM")
            rows.append({"config": cfg_name, "kernel": e["kernel"],
                         "entry": e["entry"], "launch": e["launch"],
                         "instantiation": e["instantiation"],
                         "block_smem": smem, "threads": e["threads"],
                         "registers": regs,
                         "registers_ptxas": ptxas.get(e["instantiation"]),
                         "local_bytes": q[10],
                         "blocks_per_sm": blocks, "limited_by": limiter})
            print(f"lint: (a) {cfg_name} {e['entry']}#{e['launch']} "
                  f"{e['instantiation']}: {smem} B shared a block, "
                  f"{e['threads']} threads, {regs} registers (ptxas "
                  f"{ptxas.get(e['instantiation'])}), {q[10]} B local, "
                  f"{blocks} blocks an SM ({limiter}) = the occupancy "
                  f"API's")
    return rows


def lint_pools(pricing: subprocess.Popen, measured_pools: dict) -> dict:
    """(b) the graph pools' static prices against the measured pools."""
    out, err = pricing.communicate(timeout=300)
    if pricing.returncode:
        raise AssertionError(f"lint: the pricing process failed:\n{err}")
    priced = json.loads(out.strip().splitlines()[-1])
    pools = {}
    for name, price_b, key in (
            ("s1", priced["s1"]["total_bytes"], "s1"),
            ("train_f32", priced["train_f32"]["price_bytes"], "train_f32")):
        got_mib = measured_pools.get(key)
        price = price_b / 2 ** 20
        ratio = None if not got_mib else price / got_mib
        pools[name] = {"price_mib": price, "measured_mib": got_mib,
                       "ratio": ratio}
        print(f"lint: (b) {name} graph pools: priced {price:.0f} MiB, "
              f"measured {got_mib} MiB"
              + ("" if ratio is None else f" ({ratio:.3f}x)"))
        if ratio is None or abs(ratio - 1.0) > POOL_TOL:
            raise AssertionError(f"lint: {name}: the priced pool is not "
                                 f"within {POOL_TOL:.0%} of the measured")
    return {"pools": pools, "pools_per_key": priced["s1"]["keys"]}


def lint_contracts(dev) -> dict:
    """(c) contract checking on: one captured request and one eager train
    step raise nothing; a wrong shape raises."""
    from raft_tpu_torch import RAFTConfig, init_raft_torch, make_inference_fn
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.lint import contracts
    from raft_tpu_torch.models.raft import raft_forward
    from raft_tpu_torch.training import TrainState, make_optimizer
    from raft_tpu_torch.training.step import make_train_step
    t1 = time.perf_counter()
    was = contracts.checking_enabled()
    contracts.enable_checking(True)
    try:
        cfg = RAFTConfig.small_model(iters=2, corr_impl="pallas")
        model = init_raft_torch(cfg, torch.Generator().manual_seed(0),
                                device=dev)
        rng = np.random.RandomState(14)
        im = rng.rand(2, 1, 64, 96, 3).astype(np.float32)
        fn = make_inference_fn(cfg, device=dev)
        flow = fn(model, im[0], im[1])
        flow = fn(model, im[0], im[1])           # a replay
        captures = fn.graphs.captures
        tc = TrainConfig(batch_size=2, image_size=(64, 96))
        tx = make_optimizer(tc)
        state = TrainState.create(init_raft_torch(
            cfg, torch.Generator().manual_seed(1), device=dev).train(), tx)
        batch = (rng.rand(2, 64, 96, 3).astype(np.float32),
                 rng.rand(2, 64, 96, 3).astype(np.float32),
                 rng.randn(2, 64, 96, 2).astype(np.float32),
                 np.ones((2, 64, 96), np.float32))
        state, metrics = make_train_step(cfg, tc, tx)(state, batch)
        loss = float(metrics["loss"])
        a = torch.as_tensor(im[0], device=dev)
        try:
            raft_forward(model, a, a[:, :32], cfg)
            raise AssertionError("lint: a wrong shape passed the contract")
        except contracts.ContractError as e:
            wrong = str(e)
    finally:
        contracts.enable_checking(was)
    finite = bool(torch.isfinite(torch.as_tensor(flow)).all())
    if not (finite and np.isfinite(loss) and captures == 1):
        raise AssertionError(f"lint: (c) flow finite {finite}, loss "
                             f"{loss}, captures {captures}")
    print(f"lint: (c) contracts on: a captured raft-small request "
          f"({captures} capture) and an eager train step (loss {loss:.3f}) "
          f"raised nothing; a wrong shape raised: {wrong[:120]}")
    return {"captures": captures, "loss": loss, "violations": 0,
            "wrong_shape_error": wrong[:160], "s": time.perf_counter() - t1}


def lint_spans(dev) -> dict:
    """(d) C8's regime: the span accounting of a closed loop at 8 clients
    on raft-small at 32x48 (serve_bench's smoke server)."""
    from raft_tpu_torch import RAFTConfig, init_raft_torch
    from raft_tpu_torch.serving import FlowServer, ServeConfig
    from raft_tpu_torch.tools.serve_bench import (SMOKE_CUDNN, _pair_body,
                                                  fetch_trace_accounting,
                                                  run_closed)
    t2 = time.perf_counter()
    cfg = RAFTConfig.small_model(iters=2, corr_impl="pallas", gru_impl="xla")
    model = init_raft_torch(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    sc = ServeConfig(buckets=((32, 48),), max_batch=4, port=0,
                     max_sessions=0, iters_policy="converge:1e-2",
                     history_interval_s=0.0, cudnn=SMOKE_CUDNN)
    bench0 = torch.backends.cudnn.benchmark     # the server sets its mode
    server = FlowServer(cfg, model, sc, iters=2)
    server.start()
    try:
        body = _pair_body(32, 48)
        run_closed(sc.host, server.port, body, SPAN_CLIENTS, 16)
        results, elapsed = run_closed(sc.host, server.port, body,
                                      SPAN_CLIENTS, SPAN_REQUESTS)
        acc, problems = fetch_trace_accounting(sc.host, server.port)
    finally:
        server.stop()
        torch.backends.cudnn.benchmark = bench0
    ok = sum(st == 200 for st, _ in results)
    rec = dict(acc or {}, clients=SPAN_CLIENTS, requests=SPAN_REQUESTS,
               ok=ok, pairs_per_s=ok / elapsed, s=time.perf_counter() - t2)
    print(f"lint: (d) closed loop, raft-small 32x48, {SPAN_CLIENTS} "
          f"clients: {ok / elapsed:.1f} pairs/s, spans cover "
          f"{(acc or {}).get('span_coverage_mean')} of a request on average, "
          f"{(acc or {}).get('span_coverage_min')} at least")
    if problems or ok != SPAN_REQUESTS:
        raise AssertionError(f"lint: (d) {ok}/{SPAN_REQUESTS} answered; "
                             f"{problems}")
    return rec


# -- 15. 8b: the host codec and the classical flow ------------------------

HOST_LIBS = ("jpeg.cpp", "dis_flow.cpp")   # built beside phase 2's nvcc
HOST_HW = (436, 1024)                      # Sintel's frame
HOST_SHIFT = (2.3, -1.7)                   # the flow pair's motion, px
JPEG_QUALITIES = (70, 85, 95, 99)
# sha256 of cv2.imencode(".jpg", host_jpeg_frame(), [IMWRITE_JPEG_QUALITY,
# q]) and of cv2.imdecode of those bytes, with OpenCV 5.0.0 and
# libjpeg-turbo 3.1.2 (tests/test_torch_port_jpeg.py ties them to cv2)
JPEG_SHA256 = {
    70: ("8133d313eca9597e2df09fccc56e57dc99d94b0e0923663fbf6898fb2ea1420e",
         "d82f76fee2e0cf948d240ced10336ecdae060eca1ff74841fef65229a63e1524"),
    85: ("63a03b233e23b09b662014f83a85dd87ef5d194918da35b5a2f4e92d5a82b287",
         "cf7351768fc78099716cc2639e110536979f25c953c9c0a6cacace87e41ca493"),
    95: ("3578e610c9679eed723dbf7a5aca72df044d82ca4271df6d56355847c2f0e25a",
         "d936d2c7738843beda5d00211745a51c86e4c8fb6c9d5b7207dc9c503bf5fa6f"),
    99: ("51621fa66b7b30ed1bc3492a4da2c1b2e3eec5b198f0ba9cba0a6e07a64f8c2a",
         "20b0e8268f0fb8ca78b76367a27a340b3fd5d3f05475c8507cd3bf4d6ae72190"),
}
# calc_flow on host_texture_pair(*HOST_HW, shift=HOST_SHIFT): the interior
# EPE (16 px border left out) against the true motion measured on the CPU
# test host (0.03421 px; cv2's raw DIS 0.03489) and its gate; the flows'
# sha256 there (printed beside the card host's, not gated: the guided
# filter's float64 sums may round otherwise on another numpy)
DIS_EPE_MEASURED = 0.03421209752559662
DIS_EPE_BOUND = 0.05
FLOW_SHA256_CPU_HOST = {
    "dis": "cc2de69b35d3602b7685e747cc05af133f05268ebe74413718cd379237b6dbe7",
    "calc_flow": "2da7c709b3a0e12b4f3d391b0bd1ff57fa75a384d60114d7c64091e370b5532f"}
HOST_PHASE_LIMIT_S = 8.0


def host_texture_pair(h: int, w: int, seed: int = 0, shift=(0.0, 0.0),
                      angle_deg: float = 0.0, zoom: float = 1.0):
    """A seeded BGR texture (24 plane waves, periods 8-48 px; numpy only)
    and the same texture under a known motion about the frame's centre
    (rotation ``angle_deg``, scale ``zoom``, then ``shift``), with the true
    flow from the first frame to the second: ([H, W, 3] uint8 twice,
    [H, W, 2] float32).  A warped plane wave is a plane wave, so each frame
    is two matrix products of per-row and per-column sines."""
    rng = np.random.RandomState(seed)
    n = 24
    period = np.exp(rng.uniform(np.log(8.0), np.log(48.0), n))
    theta = rng.uniform(0, np.pi, n)
    k = np.stack([np.cos(theta), np.sin(theta)], -1) * (2 * np.pi / period)[:, None]
    phase = rng.uniform(0, 2 * np.pi, n)
    amp = rng.uniform(0.5, 1.0, n)
    mix = rng.uniform(0.3, 1.0, (n, 3))
    weight = amp[:, None] * mix / (amp[:, None] * mix).sum(0)     # [n, 3]
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    a = np.deg2rad(angle_deg)
    A = zoom * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])

    def image(kk, ph):
        # sum_n weight_n sin(kk_n . (x, y) + ph_n), split over x and y
        ax = kk[:, 0:1] * xs + ph[:, None]                         # [n, W]
        ay = kk[:, 1:2] * ys                                       # [n, H]
        out = np.stack([(np.cos(ay).T * weight[:, ch]) @ np.sin(ax)
                        + (np.sin(ay).T * weight[:, ch]) @ np.cos(ax)
                        for ch in range(3)], -1)
        return np.clip(np.rint(127.5 + 110.0 * out), 0, 255).astype(np.uint8)

    # frame 1 at q is the texture at A^-1 (q - c - shift) + c
    Ai = np.linalg.inv(A)
    k1 = k @ Ai
    ph1 = phase + k @ c - k1 @ (c + np.asarray(shift, np.float64))
    X, Y = np.meshgrid(xs - c[0], ys - c[1])
    flow = np.stack([A[0, 0] * X + A[0, 1] * Y + c[0] + shift[0] - (X + c[0]),
                     A[1, 0] * X + A[1, 1] * Y + c[1] + shift[1] - (Y + c[1])], -1)
    return image(k, phase), image(k1, ph1), flow.astype(np.float32)


def host_jpeg_frame(texture: np.ndarray) -> np.ndarray:
    """Phase 15's JPEG frame: ``texture`` (host_texture_pair's first frame
    at HOST_HW) plus seeded uniform noise of +-12 levels, uint8 BGR."""
    noise = np.random.RandomState(1).randint(-12, 13, texture.shape)
    return np.clip(texture.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def interior_epe(flow: np.ndarray, truth: np.ndarray, border: int = 16) -> float:
    """Mean endpoint error over the frame less ``border`` px on each side."""
    d = np.sqrt(((flow.astype(np.float64) - truth) ** 2).sum(-1))
    return float(d[border:-border, border:-border].mean())


def host_phases(smi: str) -> dict:
    """Phase 15: the port's JPEG codec and DIS + guided-filter flow on the
    card's host (no libjpeg, no OpenCV there).  Gates the JPEG digests
    against cv2's, the flow's interior EPE and the phase's seconds (the
    host libraries' builds, which ran beside phase 2's nvcc, included)."""
    import hashlib
    from raft_tpu_torch import _build, imageio
    from raft_tpu_torch.utils import frame_utils

    def sha(b) -> str:
        return hashlib.sha256(bytes(b)).hexdigest()

    t0 = time.perf_counter()
    build_s = max(_build.BUILD_SECONDS.get(src, 0.0) for src in HOST_LIBS)
    im0, im1, truth = host_texture_pair(*HOST_HW, seed=0, shift=HOST_SHIFT)
    frame = host_jpeg_frame(im0)
    digests = {}
    for q in JPEG_QUALITIES:
        enc = imageio.encode_jpeg(frame, q)
        dec = imageio.decode_jpeg(enc)
        got = (sha(enc), sha(dec.tobytes()))
        digests[q] = got == JPEG_SHA256[q]
        print(f"host: JPEG q{q}: {len(enc)} bytes, encoded sha256 "
              f"{'equals' if got[0] == JPEG_SHA256[q][0] else 'DIFFERS from'} "
              f"cv2's, decoded {'equals' if got[1] == JPEG_SHA256[q][1] else 'DIFFERS from'} "
              f"cv2's")
    if not all(digests.values()):
        raise AssertionError(f"phase 15: JPEG digests differ from cv2's at "
                             f"{[q for q, ok in digests.items() if not ok]}")
    trip = []
    for _ in range(3):
        ta = time.perf_counter()
        imageio.decode_jpeg(imageio.encode_jpeg(frame, 95))
        trip.append((time.perf_counter() - ta) * 1e3)
    g0, g1 = frame_utils._gray(im0), frame_utils._gray(im1)
    dis_ms = []
    for _ in range(2):
        ta = time.perf_counter()
        dis = frame_utils._dis_flow(g0, g1)
        dis_ms.append((time.perf_counter() - ta) * 1e3)
    ta = time.perf_counter()
    flow = frame_utils.calc_flow(im0, im1)
    flow_ms = [(time.perf_counter() - ta) * 1e3]
    epe, epe_dis = interior_epe(flow, truth), interior_epe(dis, truth)
    shas = {"dis": sha(dis.tobytes()), "calc_flow": sha(flow.tobytes())}
    for k, v in shas.items():
        print(f"host: {k} flow sha256 {v} (CPU test host "
              f"{FLOW_SHA256_CPU_HOST[k]}: "
              f"{'same' if v == FLOW_SHA256_CPU_HOST[k] else 'differs'})")
    if not (np.isfinite(flow).all() and flow.shape == HOST_HW + (2,)):
        raise AssertionError("phase 15: calc_flow is not finite [436, 1024, 2]")
    if epe > DIS_EPE_BOUND:
        raise AssertionError(f"phase 15: calc_flow's interior EPE {epe:.5f} px "
                             f"> {DIS_EPE_BOUND} px")
    phase_s = build_s + (time.perf_counter() - t0)
    rec = {"jpeg_digests_equal": True, "jpeg_round_trip_ms": min(trip),
           "jpeg_round_trip_ms_all": trip, "dis_ms": min(dis_ms),
           "calc_flow_ms": min(flow_ms), "calc_flow_ms_all": flow_ms,
           "epe_px": epe, "epe_dis_px": epe_dis, "epe_bound_px": DIS_EPE_BOUND,
           "flow_sha256": shas,
           "flow_sha256_same_as_cpu_host": {
               k: v == FLOW_SHA256_CPU_HOST[k] for k, v in shas.items()},
           "host_build_s": build_s, "phase_s": phase_s, "device": smi}
    print(f"host: JPEG q95 round trip {min(trip):.2f} ms, DIS {min(dis_ms):.1f} ms, "
          f"calc_flow {min(flow_ms):.1f} ms (DIS + guided filter) at "
          f"{HOST_HW[0]}x{HOST_HW[1]} on the card's host; interior EPE "
          f"{epe:.5f} px (raw DIS {epe_dis:.5f}; bound {DIS_EPE_BOUND}); "
          f"phase 15 took {phase_s:.2f} s with its builds ({build_s:.2f} s); {smi}")
    if phase_s > HOST_PHASE_LIMIT_S:
        raise AssertionError(f"phase 15 took {phase_s:.2f} s > "
                             f"{HOST_PHASE_LIMIT_S} s")
    return rec


def main() -> int:
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        """Where the script's time goes: each phase's start, flushed."""
        print(f"chip_smoke: phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # cuBLAS's deterministic mode (phase 9.5) needs its workspace fixed
    # before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    stamp("2")
    pricing = start_pricing()          # phase 14's, beside the build
    secs = _build.build_all(host=HOST_LIBS)
    print(f"build: {secs:.1f} s into {_build.build_dir()} (host libraries "
          f"{', '.join(f'{k} {_build.BUILD_SECONDS.get(k, 0.0):.1f} s' for k in HOST_LIBS)})")
    print(_build.compiler_report())

    # -- 9. training, first: its host-bound eager step is timed before any
    # profiler session of phases 7 and 8 (9.7 times it after one too)
    stamp("9")
    train = training_phases(dev, smi, kernels)
    train_launches = train.pop("launches")
    # -- 10. data and evaluation, right after it
    stamp("10")
    data = data_phases(dev, smi, kernels)
    data_launches = data.pop("launches")

    # -- 3. kernels vs plain at the main paths' shapes --------------------
    stamp("3")
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
    stamp("4")
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
    stamp("5")
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
    stamp("6")
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
    stamp("6b")
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
    stamp("6c")
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
    stamp("6d")
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
    stamp("6e")
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
    stamp("6f")
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
    stamp("6g")
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
    stamp("6h")
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
    stamp("6i")
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
    stamp("6j")
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
    stamp("6k")
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
    stamp("7")
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
    # call each, then 3 turns): converge beside the fixed policy's graph and
    # converge:0 (which runs every iteration as 12 replays, each with a
    # flag read: its excess over the fixed graph per iteration is a replay
    # launch, the flag read and the masked freeze's copies); the stream
    # steps beside the pairwise request; the batch step beside 3 solo steps
    def timed_turns(calls, n=3):
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
                                    "eager": lambda: run_x(model, *pairs[0])}, n=2)
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
                f"{how} {key} call", f"{how} {key} calls", 1,
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

    # -- 8. serving ----------------------------------------------------
    stamp("8")
    def hold_served(label, cfg_s, mdl, im1, im2, sizes=None):
        """A served device batch's kernels at that batch, on its own
        frames: every iteration's kernel step held to the plain step from
        the same state, as in phase 4 (float32) and phase 6c (bfloat16:
        within the plain bf16 step's own distance from the plain f32
        step); ``sizes``: the rows' live extents (ragged)."""
        t1, t2 = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (im1, im2))
        sz = crops_ = None
        if sizes is not None:
            sz = torch.from_numpy(np.asarray(sizes, np.int32)).to(dev)
            crops_ = [tuple(x) for x in np.asarray(sizes).tolist()]
        with torch.no_grad():
            if cfg_s.compute_dtype == "bfloat16":
                worst = bf16_step_parity(cfg_s, t1, t2, sz, crops_, mdl_bf=mdl)
                what = f"{worst[1]} (ratio {worst[0]:.3f})"
            else:
                worst = step_parity(cfg_s, cfg_p, t1, t2, sz, crops_, mdl=mdl)
                what = worst[1]
        print(f"{label}, batch of {t1.shape[0]}: every iteration vs the "
              f"plain step from the same state, worst {what}")
        if not worst[0] <= 1.0:
            raise AssertionError(f"{label}, batch of {t1.shape[0]}: a kernel "
                                 f"step disagrees with the plain step")

    serving = serving_phases(dev, kernels, ITERS, np.random.RandomState(8),
                             hold_served, kernel_vs_plain)
    for dtype_key, got in serving.pop("launches").items():
        add_launches(dtype_key, got)
    serving["device"] = smi
    print(json.dumps({"serving": serving}))

    print(json.dumps({"train": train}))
    print(json.dumps({"data": data}))

    # -- 11. the command line
    stamp("11")
    cli_out = cli_phases(dev, smi, train["step_ms_median"])
    cli_launches = cli_out["launches"]
    print(json.dumps({"cli": cli_out["record"]}))

    # -- 12. the parallel layer (two ranks on this card, gloo; NCCL at 1)
    stamp("12")
    # the paths' captured graphs are timed and held: their pools go back
    # to the card, which phase 12's ranks share with this process
    free0 = torch.cuda.mem_get_info(dev)[0]
    n_rel = _release_captures(locals())
    print(f"chip_smoke: released the graphs of {n_rel} captured factories, "
          f"{(torch.cuda.mem_get_info(dev)[0] - free0) / 2 ** 30:.1f} GiB",
          flush=True)
    par = parallel_phases(dev, smi)
    par_launches = par["launches"]
    print(json.dumps({"parallel": par["record"]}))

    # -- 13. the fleet: serve_fleet's replicas on this card
    stamp("13")
    fleet = fleet_phases(dev, smi)
    fleet_launches = fleet.pop("launches")
    print(json.dumps({"fleet": fleet}))

    # -- 14. the lint's checks on the card
    stamp("14")
    lint = lint_phases(dev, smi, pricing, {
        "s1": serving["s1"]["graph_pool_mib"],
        "train_f32": train["f32"]["graph_pool_mib"]})
    print(json.dumps({"lint": lint}))

    # -- 15. 8b: the host codec and the classical flow
    stamp("15")
    host = host_phases(smi)
    print(json.dumps({"host": host}))

    tools = dict(serving["s1"]["tools"], device=smi)
    print(json.dumps({"tools": tools}))
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
        # train_launches: phase 9's share of launches (its captures and
        # eager steps, f32 main and BF); fleet_launches: phase 13's (the
        # replicas' captures, probe-thread forwards and reload probes);
        # tools_launches: the kernels phase 8's tools sub-step ran, as
        # replays of S1's graphs (none through the wrappers)
        dtype_key = "bf16" if name.endswith("_bf16") else "f32"
        trained = train_launches[dtype_key].get(name.replace("_bf16", ""), 0)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None,
                "train_launches": trained,
                "fleet_launches": fleet_launches.get(name, 0),
                "tools_launches": tools["launches_by_replay"].get(name, 0)}

    # phase 12's main-path launches: the ring (B1, B3, B5 in both dtypes),
    # the row-sharded model (B1), the DP train step and serving (B1, B2)
    par_f32, par_bf16 = par_launches["f32"], par_launches["bf16"]
    print(f"device: {smi}")
    print(json.dumps({"kernels": [
        entry("corr_lookup", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:349",
              launches["corr_lookup"] + launches_s["corr_lookup"]
              + new_launches["f32"].get("corr_lookup", 0)
              + train_launches["f32"]["corr_lookup"] + data_launches["corr_lookup"]
              + cli_launches["corr_lookup"] + par_f32.get("corr_lookup", 0)
              + fleet_launches["corr_lookup"],
              corr_err, corr_ms, corr_plain_ms, corr_bound, corr_by),
        entry("sep_conv_gru", "raft_tpu_torch/csrc/sep_conv_gru.cu",
              "raft_tpu/ops/gru_pallas.py:242",
              launches["sep_conv_gru"] + new_launches["f32"].get("sep_conv_gru", 0)
              + train_launches["f32"]["sep_conv_gru"] + data_launches["sep_conv_gru"]
              + cli_launches["sep_conv_gru"] + par_f32.get("sep_conv_gru", 0)
              + fleet_launches["sep_conv_gru"],
              gru_err, gru_ms, gru_plain_ms, gru_bound_ms, gru_by),
        entry("corr_window", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:342",
              launches_w["corr_window"] + par_f32.get("corr_window", 0),
              win_err, win_ms, win_plain_ms, corr_bound, corr_by),
        entry("corr_ragged", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:604",
              launches_r["corr_ragged"] + new_launches["f32"].get("corr_ragged", 0),
              rag_err, rag_ms, rag_plain_ms, rag_bound_ms, rag_by),
        entry("corr_packed", "raft_tpu_torch/csrc/corr_lookup.cu",
              "raft_tpu/ops/corr_pallas.py:125",
              launches_p32["all"]["corr_packed"] + launches_p32["window"]["corr_packed"]
              + par_f32.get("corr_packed", 0),
              pack_err, pk["all"], pk["all_plain"], corr_bound, corr_by),
    ] + [entry(f"{name}_bf16", f"raft_tpu_torch/csrc/{src}", replaces,
               runs + par_bf16.get(name, 0),
               bf_err[name], bf_ms[name][0], bf_ms[name][1], *bf_ms[name][2])
         for name, src, replaces, runs in (
             ("corr_lookup", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:349",
              launches_bfc["corr_lookup"] + launches_sb["corr_lookup"]),
             ("corr_window", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:342",
              launches_bfw["corr_window"]),
             ("corr_packed", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:125",
              launches_bf["corr_packed"] + new_launches["bf16"].get("corr_packed", 0)
              + train_launches["bf16"]["corr_packed"]),
             ("corr_ragged", "corr_lookup.cu", "raft_tpu/ops/corr_pallas.py:604",
              launches_rbf["corr_ragged"] + new_launches["bf16"].get("corr_ragged", 0)),
             ("sep_conv_gru", "sep_conv_gru.cu", "raft_tpu/ops/gru_pallas.py:242",
              launches_bf["sep_conv_gru"] + launches_bfc["sep_conv_gru"]
              + launches_bfw["sep_conv_gru"] + launches_rbf["sep_conv_gru"]
              + new_launches["bf16"].get("sep_conv_gru", 0)
              + train_launches["bf16"]["sep_conv_gru"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _descendants() -> list:
    """Pids of every live process below this one (``/proc``)."""
    kids = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            kids.setdefault(ppid, []).append(int(d))
    out, todo = [], [os.getpid()]
    while todo:
        for k in kids.get(todo.pop(), []):
            out.append(k)
            todo.append(k)
    return out


def stop_children() -> list:
    """Stop every process the script started that is still running, on
    every way out: multiprocessing's forkserver (phase 10's loaders start
    it) and resource tracker are asked to stop and are waited for, then
    whatever is left below this process is killed and, where it is a
    child, reaped.  Returns the pids that had to be killed."""
    import multiprocessing.forkserver as mp_fs
    import multiprocessing.resource_tracker as mp_rt
    import signal
    for helper in (getattr(mp_fs, "_forkserver", None),
                   getattr(mp_rt, "_resource_tracker", None)):
        try:
            helper._stop()
        except Exception as e:          # noqa: BLE001 — killed below
            print(f"stop_children: {type(helper).__name__}: {e!r}",
                  file=sys.stderr)
    left = _descendants()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:       # a grandchild: init reaps it
            pass
    if left:
        print(f"stop_children: killed {left}", file=sys.stderr)
    return left


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
