"""``python -m raft_tpu_torch.cli``: the port's command line.

The counterpart of the JAX package's ``python -m raft_tpu.cli``, flag for
flag, on the CUDA device unless ``--cpu`` asks for the CPU::

    python -m raft_tpu_torch.cli -m test --corr-impl pallas --gru-impl pallas \\
        [--load ckpt.pth] [--save-flo]
    python -m raft_tpu_torch.cli -m test --cpu --small --iters 2 --size 48 64

Modes:

  test    two frames (``--im1``/``--im2``, default the two of ``assets/``)
          -> ``raft_flow_<variant>.png`` (+ ``.flo`` with ``--save-flo``),
          through :func:`~raft_tpu_torch.models.raft.make_inference_fn`
          (a captured CUDA graph on the card): the first call and a
          steady one are timed, ``--trace`` profiles the second
  val     EPE over a dataset (``training/evaluate.py``)
  train   the training loop (``python -m raft_tpu_torch.training``)
  export  the native params npz (+ the reference's tensorpack npz with
          ``--export-reference-npz``) and ``<variant>.pt2``, a
          ``torch.export`` program of the eval forward at ``--batch`` and
          ``--size`` (the JAX package writes StableHLO; the card's kernels
          are the operators ``raft_tpu_torch::corr_*`` and
          ``sep_conv_gru`` in its graph)
  flops   the parameter table and count, and the products' FLOPs of the
          eval forward at 1x256x448 (``utils/profiling.py``)
  serve   the HTTP server (``serving/``)
  serve_fleet  N serve processes behind the fleet's router
          (``fleet/``: least-loaded pairs, stream affinity and migration,
          the autoscaler, rolling hot-swap), every replica booting
          through one shared ``--engine-cache-dir`` (default
          ``<--out>/engine-cache``)

``--load`` reads every checkpoint format the JAX package reads
(:func:`load_state_dict`): the official torch ``.pth``/``.pt`` (its stem
convs turned to BGR input unless ``--rgb``), an npz of torch names, the
reference's tensorpack npz, a training checkpoint and the native npz.
``python -m raft_tpu_torch.serving`` and ``python -m raft_tpu_torch.training``
are built from this module's flag groups and loader.

Deviations from the JAX CLI, by design: ``--dtype`` defaults to float32
(the JAX package picks bfloat16 only on a TPU; no TPU measurement carries
over); ``-m export`` writes a ``torch.export`` program in place of
StableHLO; the frames are resized by :func:`~raft_tpu_torch.data.synthetic.
resize_linear_u8`, bitwise OpenCV's uint8 resize, with no OpenCV.  What the
port does not have raises NotImplementedError: ``--show``
(``cv2.imshow``: the card's machine has no OpenCV and no display).

The parallel layer (``raft_tpu_torch/parallel``):

* ``-m test --spatial N`` runs the model row-sharded over N ranks, one
  process a card (``cuda:<rank>``; under ``--cpu``, N CPU processes), and
  writes rank 0's gathered flow; H must be a multiple of
  ``required_h_multiple``, and fewer than N cards is an error, never two
  ranks on one card;
* ``-m train`` with ``--coordinator HOST:PORT --num-processes N
  --process-id I`` (or their ``RAFT_TPU_*`` variables), run once per rank,
  trains data-parallel (``--batch`` the global batch); ``--shard-data``
  lets each rank read its own 1/N of the dataset (required with
  ``--workers``);
* ``-m serve --serve-dp N`` serves each batch over ``cuda:0..N-1``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

MODES = ("train", "val", "test", "export", "flops", "serve", "serve_fleet")
FLOPS_SHAPE = (1, 256, 448, 3)      # the reference profiled at 1x256x448x3


def _iters_policy_spec(spec: str) -> str:
    """argparse type hook: a malformed policy exits 2 with the usage line."""
    from .config import parse_iters_policy
    parse_iters_policy(spec)
    return spec


# -- flag groups (the CLI, serving's and training's entries share them) ------

def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The model, its weights and the device."""
    p.add_argument("--load", default=None,
                   help="checkpoint: torch .pth/.pt, an npz of torch names, "
                        "the reference's tensorpack npz, a training "
                        "checkpoint or the native params npz; default: "
                        "seeded random weights")
    p.add_argument("--rgb", action="store_true",
                   help="input is RGB (default BGR, matching the reference; "
                        "a torch checkpoint's stem convs are turned to BGR "
                        "unless this is given)")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument("--small", action="store_true", help="raft-small variant")
    p.add_argument("--iters", type=int, default=None,
                   help="GRU iterations (default: 32 full / 12 small)")
    p.add_argument("--iters-policy", type=_iters_policy_spec, default=None,
                   metavar="POLICY",
                   help="'fixed' (default) or 'converge:eps[:min_iters]' "
                        "(per-sample early exit)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")


def add_dtype_flag(p: argparse.ArgumentParser) -> None:
    """``--dtype``: the compute dtype (training keeps float32 masters)."""
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (default float32; the JAX CLI picks "
                        "bfloat16 only on a TPU)")


def add_config_flags(p: argparse.ArgumentParser) -> None:
    """The inference configuration's knobs."""
    p.add_argument("--corr-impl", default="dense",
                   choices=["dense", "blockwise", "pallas"],
                   help="correlation: 'pallas' runs the CUDA lookup kernels")
    p.add_argument("--corr-lookup", default=None, choices=["gather", "onehot"],
                   help="window-lookup formulation (default onehot)")
    add_dtype_flag(p)
    p.add_argument("--ctx-hoist", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="precompute the GRU gate convs' context terms "
                        "outside the iteration loop (default on)")
    p.add_argument("--gru-impl", default=None, choices=["xla", "pallas"],
                   help="SepConvGRU: 'pallas' runs the CUDA GRU kernel, "
                        "'xla' its plain version")
    p.add_argument("--gru-block-rows", type=int, default=None, metavar="T",
                   help="the TPU kernel's row block; validated as in JAX, "
                        "changes no value here")
    p.add_argument("--quant", default=None,
                   choices=("none", "int8", "bf16w", "int8+bf16w"),
                   help="'int8' slot-pool rows, 'bf16w' encoder weights "
                        "stored bfloat16, or both")


def add_telemetry_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace: train steps "
                        "5..5+N, val/serve device calls after the first, "
                        "test the second run")
    p.add_argument("--trace-steps", type=int, default=None, metavar="N",
                   help="steps or device calls in the --trace window "
                        "(default 4)")
    p.add_argument("--watchdogs", action="store_true",
                   help="the watchdogs: graph-capture watch, device-memory "
                        "gauges and the NaN/Inf sentinel with stage "
                        "provenance (equivalent to RAFT_TPU_WATCHDOGS=1)")
    p.add_argument("--run-log", default=None, metavar="PATH",
                   help="run-event log: a directory or a .jsonl path "
                        "(default <--out>/events.jsonl; 'none' disables)")


def add_train_flags(p: argparse.ArgumentParser,
                    dataset_default: str) -> None:
    """Training's, evaluation's and the data layer's flags."""
    p.add_argument("--dataset", default=dataset_default,
                   choices=["sintel", "chairs", "things", "kitti",
                            "synthetic"],
                   help="curriculum stage (its presets) / dataset to "
                        "evaluate; every stage but synthetic reads --data")
    p.add_argument("--data", default=None, metavar="ROOT",
                   help="dataset root directory")
    p.add_argument("--weighting", default=None, choices=["sample", "pixel"],
                   help="val: average per-image means (sample; Sintel) or "
                        "pool valid pixels (pixel; the kitti default)")
    p.add_argument("--max-samples", type=int, default=None, metavar="N",
                   help="val: evaluate the first N samples only")
    p.add_argument("--dump-flow", default=None, metavar="DIR",
                   help="val: also write every prediction (KITTI 16-bit "
                        "PNGs for kitti, .flo otherwise)")
    p.add_argument("--split", default=None, choices=["training", "testing"],
                   help="val, --dataset kitti/sintel: the split (testing "
                        "has no ground truth and needs --dump-flow)")
    p.add_argument("--dstype", default=None, choices=["clean", "final"],
                   help="val, --dataset sintel: the render pass "
                        "(default clean)")
    p.add_argument("--warm-start", action="store_true",
                   help="val, --dataset sintel: the official video "
                        "protocol (each frame's flow seeds the next)")
    p.add_argument("--eval-batch", type=int, default=None, metavar="N",
                   help="val: samples per forward, grouped by padded shape")
    p.add_argument("--bucket", type=int, default=None,
                   help="val: pad H, W to this multiple (default 8, 64 for "
                        "kitti)")
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (default: 1 for test/export, the stage "
                        "preset's for train, 4 under --demo-train)")
    p.add_argument("--accum", type=int, default=None, metavar="K",
                   help="gradient accumulation micro-batches per step")
    p.add_argument("--train-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="training crop size")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("-o", "--optimizer", default="adamw",
                   choices=["adam", "adamw", "sgd", "sgd_cyclic",
                            "sgd_1cycle"])
    p.add_argument("--freeze-bn", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="batch norm in eval mode (stage default otherwise)")
    p.add_argument("--ckpt-every", type=int, default=None, metavar="N")
    p.add_argument("--log-every", type=int, default=None, metavar="N")
    p.add_argument("--keep-checkpoints", type=int, default=None, metavar="N",
                   help="retention: keep the newest N checkpoints")
    p.add_argument("--async-ckpt", dest="async_ckpt", action="store_true",
                   default=None, help="background checkpoint writer "
                                      "(default)")
    p.add_argument("--sync-ckpt", dest="async_ckpt", action="store_false",
                   help="write checkpoints inline")
    p.add_argument("--max-rollbacks", type=int, default=None, metavar="N",
                   help="consecutive divergence rollbacks before giving "
                        "up (0 disables)")
    p.add_argument("--chaos-train", default=None, metavar="SPEC",
                   help="ARM FAULT INJECTION (drills only), e.g. "
                        "'seed=12,nan_loss=0.15,torn_ckpt=0.5,preempt=6'")
    p.add_argument("--workers", type=int, default=0,
                   help="train: decode/augment worker processes (0 = in "
                        "the prefetch thread)")
    p.add_argument("--device-aug", action="store_true",
                   help="train: run the FlowAugmentor recipe on the device "
                        "(data/augment_device.py); workers only decode "
                        "(dense-ground-truth stages only)")
    p.add_argument("--prefetch-depth", type=int, default=2, metavar="N",
                   help="train: staged device batches buffered ahead of "
                        "the step")
    p.add_argument("--shm-slots", type=int, default=None, metavar="N",
                   help="train, with --workers: shared-memory sample slots "
                        "(default 2*workers+2; 0 pickles samples through "
                        "the pipes instead)")
    p.add_argument("--mp-start", default="forkserver",
                   choices=["fork", "forkserver", "spawn"],
                   help="worker start method (default forkserver: safe "
                        "under the parent's threads)")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   help="replace a worker that holds tasks but delivers "
                        "nothing for this many seconds; 0 disables")
    p.add_argument("--worker-respawns", type=int, default=None, metavar="N",
                   help="train, with --workers: respawns of dead or stalled "
                        "workers allowed per 2-minute window (default 3; "
                        "0 = fail fast)")


def add_multiprocess_flags(p: argparse.ArgumentParser) -> None:
    """Multi-process training's flags (the JAX CLI's; each falls back to
    its ``RAFT_TPU_*`` environment variable)."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process train: rank 0's rendezvous address "
                        "(a tcp:// or file:// URL also works)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process train: the number of ranks")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process train: this process's rank")
    p.add_argument("--shard-data", action="store_true",
                   help="multi-process train: each rank reads its own 1/N "
                        "of the dataset (needed with --workers)")


def init_distributed(args) -> bool:
    """Join the run's process group from the multi-process flags (a no-op
    for one process): gloo on the CPU (``--cpu``), NCCL and gloo on the
    cards."""
    from .parallel.distributed import initialize
    return initialize(coordinator_address=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id,
                      device="cpu" if args.cpu else "cuda")


def add_serve_flags(p: argparse.ArgumentParser) -> None:
    """The server's flags (the JAX package's serve flags, same names and
    defaults)."""
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=8000,
                   help="bind port (0 = ephemeral, printed)")
    p.add_argument("--buckets", default="432x1024", metavar="HxW,HxW",
                   help="resolution buckets; a request pads to the "
                        "smallest fitting one (sides multiples of 8)")
    p.add_argument("--max-batch", type=int, default=4,
                   help="micro-batcher coalescing cap")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time the oldest queued request waits for "
                        "batch-mates")
    p.add_argument("--queue-depth", type=int, default=128,
                   help="admission-queue bound (429 beyond it)")
    p.add_argument("--deadline-ms", type=float, default=2000.0,
                   help="default per-request deadline (504 past it)")
    p.add_argument("--serve-dp", type=int, default=None, metavar="N",
                   help="data-parallel serving over N devices "
                        "(cuda:0..N-1)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the warm grid (the first request "
                        "per shape then pays its capture)")
    p.add_argument("--max-sessions", type=int, default=64, metavar="N",
                   help="streaming sessions holding slot-pool rows; 0 "
                        "disables /v1/stream")
    p.add_argument("--session-ttl-s", type=float, default=300.0,
                   metavar="T", help="idle streaming sessions are reaped")
    p.add_argument("--ragged", action="store_true",
                   help="ragged mixed-resolution batching: one graph per "
                        "(kind, batch step) at the max box serves every "
                        "bucket")
    p.add_argument("--ragged-batch-pixels", type=int, default=0,
                   metavar="N", help="cap a ragged batch's live pixels")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="ARM FAULT INJECTION (drills only), e.g. "
                        "'seed=11,engine_error=0.05,nan=0.03'")
    p.add_argument("--breaker-window", type=int, default=64, metavar="N",
                   help="circuit-breaker window (device calls); 0 disables")
    p.add_argument("--breaker-threshold", type=float, default=0.5,
                   metavar="R", help="error rate that opens the breaker")
    p.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                   metavar="T", help="seconds the breaker stays open")
    p.add_argument("--trace-sample", type=float, default=1.0, metavar="P",
                   help="fraction of request traces retained; 0 disables "
                        "request tracing")
    p.add_argument("--slo-pair-ms", type=float, default=1000.0, metavar="T",
                   help="/v1/flow latency objective")
    p.add_argument("--slo-stream-ms", type=float, default=500.0,
                   metavar="T", help="/v1/stream latency objective")
    p.add_argument("--flightrec", default=None, metavar="PATH",
                   help="flight-recorder dump path (default "
                        "<--out>/flightrec.jsonl; '' disables the file)")
    p.add_argument("--engine-cache-dir", default=None, metavar="DIR",
                   help="the AOT engine cache: kernel objects and a probe "
                        "digest per warm key (serve_fleet default: "
                        "<--out>/engine-cache)")
    p.add_argument("--cudnn", default=None, choices=["benchmark",
                                                     "heuristic"],
                   help="cuDNN's algorithm choice for the captured graphs "
                        "(default: the serving config's)")
    p.add_argument("--history-interval-s", type=float, default=1.0,
                   metavar="T", help="metric-history sampling interval; 0 "
                                     "disables history and sentinels")
    p.add_argument("--history-window", type=int, default=600, metavar="N",
                   help="metric-history ring depth")
    p.add_argument("--history-path", default=None, metavar="PATH",
                   help="metric time-series spill (default "
                        "<--out>/metrics_ts.jsonl; '' skips the file)")
    p.add_argument("--no-anomaly", action="store_true",
                   help="disable the anomaly sentinels")
    p.add_argument("--anomaly-window-s", type=float, default=15.0,
                   metavar="T", help="sentinel rule window")
    p.add_argument("--anomaly-baseline-s", type=float, default=60.0,
                   metavar="T", help="p95-drift baseline window")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.cli",
        description="RAFT optical flow (PyTorch/CUDA port)")
    p.add_argument("-m", "--mode", default="test", choices=list(MODES),
                   help="run mode")
    p.add_argument("--im1", default="assets/frame_0016.png",
                   help="left image")
    p.add_argument("--im2", default="assets/frame_0017.png",
                   help="right image")
    p.add_argument("--size", type=int, nargs=2, default=(432, 1024),
                   metavar=("H", "W"), help="inference resolution")
    p.add_argument("--save-flo", action="store_true", help="also write .flo")
    p.add_argument("--export-reference-npz", action="store_true",
                   help="export: also write the params in the reference's "
                        "tensorpack naming")
    p.add_argument("--show", action="store_true",
                   help="cv2.imshow the result (not ported: raises)")
    p.add_argument("--spatial", type=int, default=None, metavar="N",
                   help="test: row-shard the model over N ranks, one "
                        "process a card (halo'd convs, ring correlation)")
    p.add_argument("--demo-train", action="store_true",
                   help="shortcut: train raft-small on the synthetic "
                        "dataset (no --data) for a few hundred steps")
    add_multiprocess_flags(p)
    add_model_flags(p)
    add_config_flags(p)
    add_telemetry_flags(p)
    add_train_flags(p, dataset_default="sintel")
    add_serve_flags(p)
    add_fleet_flags(p)
    return p


def add_fleet_flags(p: argparse.ArgumentParser) -> None:
    """``-m serve_fleet``'s flags (the serve flags go to every replica)."""
    p.add_argument("--replicas", type=int, default=2,
                   help="serve_fleet: initial replica count")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="serve_fleet: autoscaler floor (default 1)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="serve_fleet: autoscaler ceiling (default "
                        "max(replicas, 2))")
    p.add_argument("--autoscale", action="store_true",
                   help="serve_fleet: run the autoscaler")
    p.add_argument("--fleet-port", type=int, default=None,
                   help="serve_fleet: the router's port (default --port)")
    p.add_argument("--pin-cpus", action="store_true",
                   help="serve_fleet: pin each replica to its own slice "
                        "of the host's cores")
    p.add_argument("--health-poll-s", type=float, default=None,
                   help="serve_fleet: replica health-poll period")
    p.add_argument("--scale-poll-s", type=float, default=None,
                   help="serve_fleet: autoscaler poll period")


def check_unported(args) -> None:
    """Raise NotImplementedError for each flag given that the port does
    not have."""
    if getattr(args, "show", False):
        raise NotImplementedError(
            "--show is cv2.imshow: the port has no OpenCV and the card's "
            "machine no display; open the written PNG instead")


# -- the pieces every mode shares --------------------------------------------

def make_config(args):
    """The model configuration of the flags (the JAX CLI's
    ``_make_config``): float32 unless ``--dtype bfloat16``."""
    from .config import RAFTConfig
    overrides = dict(corr_impl=getattr(args, "corr_impl", "dense"),
                     compute_dtype=getattr(args, "dtype", None) or "float32")
    for flag, field in (("ctx_hoist", "gru_ctx_hoist"),
                        ("gru_impl", "gru_impl"),
                        ("gru_block_rows", "gru_block_rows"),
                        ("corr_lookup", "corr_lookup"),
                        ("iters_policy", "iters_policy"),
                        ("quant", "quant"), ("iters", "iters")):
        value = getattr(args, flag, None)
        if value is not None:
            overrides[field] = value
    if args.small:
        return RAFTConfig.small_model(**overrides)
    return RAFTConfig.full(**overrides)


def start_run_log(args, config, mode=None):
    """Open the run's event log (``telemetry.events``, the manifest first)
    at ``--run-log`` (default ``<--out>/events.jsonl``; 'none' disables)
    and make it the process's current one; with the watchdogs on, the
    NaN/Inf sentinel reports into it."""
    from .telemetry import events, watchdogs
    dest = getattr(args, "run_log", None)
    if dest == "none":
        return None
    if dest is None:
        dest = getattr(args, "out", None)
        if not dest:
            return None
    log = events.start_run(Path(dest), mode=mode or args.mode, config=config)
    events.set_current(log)
    if watchdogs.watchdogs_enabled():
        watchdogs.enable_nan_sentinel(True, run_log=log)
    return log


def device_of(args):
    """The device of the run: CUDA unless ``--cpu`` (raises without CUDA)."""
    from .models.raft import resolve_device
    return resolve_device("cpu" if args.cpu else None)


def load_state_dict(path, rgb: bool = False):
    """Any checkpoint ``--load`` takes as a ``RAFT`` ``state_dict``
    (``convert.load_checkpoint_auto``).  A torch checkpoint was trained on
    RGB input: its stem convs are turned to take BGR unless ``rgb`` (the
    JAX CLI's ``_load_params``)."""
    from .convert import (detect_format, from_jax_params, load_checkpoint_auto,
                          swap_rgb_bgr)
    params = load_checkpoint_auto(path)
    if not rgb and detect_format(path) == "torch":
        swap_rgb_bgr(params)
        print("swapped stem convs RGB->BGR for torch checkpoint")
    state = from_jax_params(params)
    print(f"loaded checkpoint from {path}")
    return state


def load_model(args, config):
    """The model of a run: ``--load``'s weights, else seeded random ones
    (with a warning), on the run's device in the compute dtype, eval mode,
    the encoders stored bfloat16 under ``quant='bf16w'``."""
    from .models.raft import (RAFT, cast_encoder_weights, compute_dtype,
                              init_raft_torch)
    device = device_of(args)
    if args.load:
        model = RAFT(config)
        model.load_state_dict(load_state_dict(args.load,
                                              getattr(args, "rgb", False)),
                              strict=True)
        model = model.to(device, compute_dtype(config)).eval()
    else:
        model = init_raft_torch(config, device=device)
        print("WARNING: no --load given; using RANDOM weights",
              file=sys.stderr)
    return cast_encoder_weights(model, config)


def read_pair(args):
    """The two frames as [1, H, W, 3] float32 in [0, 1], BGR (RGB with
    ``--rgb``), resized to ``--size`` as uint8 first, as the JAX CLI's
    ``cv2.resize`` does."""
    from .data.synthetic import resize_linear_u8
    from .imageio import read_image
    h, w = args.size
    out = []
    for path in (args.im1, args.im2):
        if not Path(path).is_file():
            raise FileNotFoundError(f"could not read {args.im1} / {args.im2}")
        im = read_image(path)
        if args.rgb:
            im = im[:, :, ::-1]
        out.append(resize_linear_u8(im, (w, h)).astype(np.float32)[None]
                   / 255.0)
    return out[0], out[1]


def _variant(args) -> str:
    return "raft-small" if args.small else "raft-things"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the modes ----------------------------------------------------------------

def _timed_pair(fn, device, trace, *args):
    """``fn(*args)`` twice: the first call (a capture on the card) and a
    steady one, the second profiled under ``trace``; returns the first's
    flow on the host and the two times (s)."""
    from .telemetry.trace import TraceWindow
    t0 = time.perf_counter()
    flow = fn(*args).cpu().numpy()
    t1 = time.perf_counter()
    window = TraceWindow(trace, first=1, steps=1, log_fn=print)
    window.on_step(1)
    try:
        fn(*args)
        _sync(device)
        t2 = time.perf_counter()
    finally:
        window.stop()
    return flow, t1 - t0, t2 - t1


def _spatial_rank(rank: int, world: int, args, im1, im2):
    """One rank of ``-m test --spatial``: its card (or the CPU), its
    copy of the weights, its row slabs; returns rank 0's gathered flow and
    the times."""
    from .parallel import (SPATIAL_AXIS, gather_rows, make_mesh,
                           make_shard_inference_fn, shard_rows)
    config = make_config(args)
    mesh = make_mesh((SPATIAL_AXIS,), device="cpu" if args.cpu else None)
    model = load_model(args, config).to(mesh.device)
    fn = make_shard_inference_fn(config, mesh)

    def run(a, b):
        return gather_rows(fn(model, a, b), mesh)
    flow, first, steady = _timed_pair(
        run, mesh.device, args.trace if rank == 0 else None,
        shard_rows(im1, mesh), shard_rows(im2, mesh))
    return (flow if rank == 0 else None), first, steady


def _test_spatial(args, config, im1, im2):
    """``-m test --spatial N``: the JAX CLI's checks (N devices, H a
    multiple of ``required_h_multiple``; each an ``ERROR`` line and exit
    2), then N ranks (``parallel/launch.py``); returns (flow, first,
    steady) or the exit code."""
    from .parallel.distributed import default_backend
    from .parallel.launch import run_ranks
    from .parallel.spatial import required_h_multiple
    n = args.spatial
    have = os.cpu_count() if args.cpu else torch.cuda.device_count()
    if not args.cpu and have < n:
        print(f"ERROR: --spatial {n} needs {n} devices, have {have}")
        return 2
    need = required_h_multiple(config, n)
    h = im1.shape[1]
    if h % need:
        print(f"ERROR: --spatial {n} requires H divisible by {need} "
              f"(8 * N devices * 2^(corr_levels-1)); got H={h}. "
              f"Pick --size accordingly, e.g. H={((h // need) + 1) * need}")
        return 2
    print(f"[test] sequence-parallel: rows sharded over {n} "
          f"{'CPU processes' if args.cpu else 'cards'}")
    res = run_ranks(_spatial_rank, n, args=(args, im1, im2),
                    backend=default_backend("cpu" if args.cpu else "cuda"),
                    threads=max(1, have // n) if args.cpu else None,
                    deadline_s=3600)
    flow, first, _ = res[0]
    return flow, first, max(r[2] for r in res)


def mode_test(args) -> int:
    from .models.raft import make_inference_fn
    from .utils.flow_io import write_flo
    from .utils.flow_viz import flow_to_color
    from .imageio import write_image

    config = make_config(args)
    start_run_log(args, config)
    device = device_of(args)
    im1, im2 = read_pair(args)
    if args.batch > 1:
        im1 = np.repeat(im1, args.batch, axis=0)
        im2 = np.repeat(im2, args.batch, axis=0)
    if args.spatial and args.spatial > 1:
        out = _test_spatial(args, config, im1, im2)
        if isinstance(out, int):
            return out
        flow, first, steady = out
    else:
        model = load_model(args, config)
        fn = make_inference_fn(config, device=device)
        flow, first, steady = _timed_pair(fn, device, args.trace, model,
                                          im1, im2)
    print(f"flow {flow.shape}  first call {first:.3f}s  steady "
          f"{steady * 1e3:.3f} ms")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    variant = _variant(args)
    png = outdir / f"raft_flow_{variant}.png"
    write_image(png, flow_to_color(flow[0], convert_to_bgr=True))
    print(f"wrote {png}")
    if args.save_flo:
        flo = outdir / f"raft_flow_{variant}.flo"
        write_flo(flow[0], flo)
        print(f"wrote {flo}")
    return 0


def mode_flops(args) -> int:
    from .models.raft import init_raft_torch, raft_forward
    from .utils.profiling import count_params, flops_report, param_table

    config = make_config(args)
    start_run_log(args, config)
    device = device_of(args)
    model = init_raft_torch(config, device=device)
    print(param_table(model))
    print(f"trainable parameters: {count_params(model):,}")
    im = torch.zeros(FLOPS_SHAPE, dtype=torch.float32, device=device)
    _, msg = flops_report(raft_forward, model, im, im, config)
    print(msg)
    return 0


class EvalForward(torch.nn.Module):
    """The eval forward as a module ``torch.export`` takes:
    ``(image1, image2) -> flow``, ``raft_forward(train=False)``."""

    def __init__(self, model, config):
        super().__init__()
        self.model = model
        self.config = config

    def forward(self, image1, image2):
        from .models.raft import raft_forward
        return raft_forward(self.model, image1, image2, self.config).flow


def export_program(model, config, batch: int, size):
    """``torch.export`` of the eval forward at [batch, H, W, 3] float32
    inputs on the model's device (the NaN sentinel held off: a program
    carries no host report).  The program runs TF32 as the caller's
    switches say: hold them off (``models.raft.tf32_off``) for the float32
    configuration's numerics."""
    from .models.raft import tf32_off
    from .telemetry.watchdogs import suppress_nan_sentinel
    dev = next(model.parameters()).device
    h, w = size
    # two tensors: one passed twice would be traced as one input
    ims = tuple(torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev)
                for _ in range(2))
    with suppress_nan_sentinel(), tf32_off():
        return torch.export.export(EvalForward(model, config), ims)


def mode_export(args) -> int:
    from .convert import save_params_npz, to_jax_params, to_reference_npz

    config = make_config(args)
    start_run_log(args, config)
    model = load_model(args, config)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    variant = _variant(args)

    ckpt = outdir / f"{variant}.npz"
    save_params_npz(model.state_dict(), ckpt)
    print(f"wrote {ckpt}")
    if args.export_reference_npz:
        ref = outdir / f"{variant}.reference.npz"
        to_reference_npz(to_jax_params(model.state_dict()), ref)
        print(f"wrote {ref} (reference/tensorpack naming)")

    t0 = time.perf_counter()
    program = export_program(model, config, args.batch, args.size)
    pt2 = outdir / f"{variant}.pt2"
    torch.export.save(program, str(pt2))
    print(f"wrote {pt2} (torch.export program of the eval forward, input "
          f"{(args.batch, *args.size, 3)}, {time.perf_counter() - t0:.2f}s)")
    return 0


def mode_val(args) -> int:
    from .training.evaluate import evaluate_cli
    config = make_config(args)
    start_run_log(args, config)
    return evaluate_cli(args, config, load_model)


def mode_train(args) -> int:
    from .training.__main__ import train_cli
    config = make_config(args)
    start_run_log(args, config)
    return train_cli(args, config)


def mode_serve(args) -> int:
    from .serving.server import serve_cli
    config = make_config(args)
    start_run_log(args, config)
    return serve_cli(args, config, load_model)


def mode_serve_fleet(args) -> int:
    from .fleet import serve_fleet_cli
    config = make_config(args)
    start_run_log(args, config)
    return serve_fleet_cli(args, config)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.demo_train:
        args.mode = "train"
        args.dataset = "synthetic"
        args.small = True
        if args.num_steps is None:
            args.num_steps = 300
        if args.lr is None:
            args.lr = 2e-4
        if args.iters is None:
            args.iters = 8
        if args.batch is None:
            args.batch = 4
    if args.batch is None and args.mode != "train":
        # train mode leaves None so the stage preset's batch size applies
        args.batch = 1
    check_unported(args)
    if args.watchdogs:
        # one switch for every subsystem: the training loop, the serving
        # stack and the model's NaN sentinel read this variable
        os.environ["RAFT_TPU_WATCHDOGS"] = "1"
    device_of(args)                 # no CUDA and no --cpu: raise, run nothing
    if args.mode == "train":
        # before anything touches a device: join the run's process group
        # (the flags or their RAFT_TPU_* variables; one process: no-op)
        init_distributed(args)
    return {"test": mode_test, "flops": mode_flops, "export": mode_export,
            "val": mode_val, "train": mode_train,
            "serve": mode_serve,
            "serve_fleet": mode_serve_fleet}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
