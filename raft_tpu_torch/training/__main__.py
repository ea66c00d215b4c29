"""``python -m raft_tpu_torch.training``: the port's training and
evaluation entry point.

``-m train`` (the default) is the counterpart of the JAX package's
``python -m raft_tpu.cli -m train``, ``-m val`` of its ``-m val``.  Both run
on the CUDA device unless ``--cpu`` asks for the CPU::

    python -m raft_tpu_torch.training --dataset chairs --data ROOT \
        --workers 4 --num-steps 100000 --out runs/chairs
    python -m raft_tpu_torch.training --dataset chairs --data ROOT \
        --workers 4 --device-aug --out runs/chairs_da
    python -m raft_tpu_torch.training -m val --dataset sintel --data ROOT \
        --warm-start --load runs/chairs/params.npz
    python -m raft_tpu_torch.training -m val --dataset kitti --data ROOT \
        --eval-batch 2 --dump-flow out/kitti
    python -m raft_tpu_torch.training --cpu --small --iters 2 --batch 2 \
        --train-size 32 48 --num-steps 4 --ckpt-every 2 --out /tmp/run

``--dataset`` names a curriculum stage (its ``TrainConfig.for_stage``
preset; explicit flags win) and ``--data`` its root: FlyingChairs,
FlyingThings3D, MPI-Sintel or KITTI in their release layouts
(``data/datasets.py``), read with the port's own codec; ``synthetic`` is
procedural and needs no root.  ``--workers N`` decodes and augments in N
processes (``data/mp_loader.py``; shared-memory transport unless
``--shm-slots 0``), ``--device-aug`` augments on the card instead
(workers only decode).  The model is ``RAFTConfig.full(corr_impl='pallas',
gru_impl='pallas')`` (the CUDA kernels; their plain versions on the CPU)
or, with ``--small``, raft-small.  ``--load`` takes the native params npz;
other formats raise (ROADMAP item 14).  ``-m val`` without ``--load``
evaluates seeded random weights and says so.  A preempted training run
(SIGTERM/SIGINT) writes an emergency checkpoint and exits 17; the same
command resumes from the newest readable checkpoint in
``<--out>/checkpoints``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _iters_policy_spec(spec: str) -> str:
    from ..config import parse_iters_policy
    parse_iters_policy(spec)
    return spec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.training",
        description="RAFT training and evaluation (PyTorch/CUDA port)")
    p.add_argument("-m", "--mode", default="train", choices=["train", "val"],
                   help="train (default) or val: EPE over a dataset")
    p.add_argument("--dataset", default="synthetic",
                   choices=["chairs", "things", "sintel", "kitti",
                            "synthetic"],
                   help="curriculum stage (its presets) / dataset to "
                        "evaluate; every stage but synthetic reads --data")
    p.add_argument("--data", default=None, metavar="ROOT",
                   help="dataset root directory")
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
    p.add_argument("--split", default=None, choices=["training", "testing"],
                   help="val, --dataset kitti/sintel: the split (testing "
                        "has no ground truth and needs --dump-flow)")
    p.add_argument("--dstype", default=None, choices=["clean", "final"],
                   help="val, --dataset sintel: the render pass "
                        "(default clean)")
    p.add_argument("--bucket", type=int, default=None,
                   help="val: pad H, W to this multiple (default 8, 64 for "
                        "kitti)")
    p.add_argument("--eval-batch", type=int, default=None, metavar="N",
                   help="val: samples per forward, grouped by padded shape")
    p.add_argument("--max-samples", type=int, default=None, metavar="N",
                   help="val: evaluate the first N samples only")
    p.add_argument("--weighting", default=None, choices=["sample", "pixel"],
                   help="val: average per-image means (sample; Sintel) or "
                        "pool valid pixels (pixel; the kitti default)")
    p.add_argument("--warm-start", action="store_true",
                   help="val, --dataset sintel: the official video "
                        "protocol (each frame's flow seeds the next)")
    p.add_argument("--dump-flow", default=None, metavar="DIR",
                   help="val: also write every prediction (KITTI 16-bit "
                        "PNGs for kitti, .flo otherwise)")
    p.add_argument("--load", default=None,
                   help="warm-start weights: the native params npz")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument("--small", action="store_true", help="raft-small variant")
    p.add_argument("--iters", type=int, default=None,
                   help="GRU iterations (default: 32 full / 12 small)")
    p.add_argument("--iters-policy", type=_iters_policy_spec, default=None,
                   metavar="POLICY",
                   help="'fixed' (default) or 'converge:eps[:min_iters]'")
    p.add_argument("--batch", type=int, default=None)
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
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of a step "
                        "(train) or forward (val) window")
    p.add_argument("--trace-steps", type=int, default=None, metavar="N")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the CUDA device)")
    return p


def make_config(args):
    from ..config import RAFTConfig
    overrides = {}
    for flag, field in (("iters", "iters"), ("iters_policy", "iters_policy")):
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    if args.small:
        return RAFTConfig.small_model(corr_impl="pallas", **overrides)
    return RAFTConfig.full(corr_impl="pallas", gru_impl="pallas", **overrides)


def make_train_config(args):
    """The stage preset of ``--dataset`` with the flags' overrides, or
    None after printing why a flag is out of range."""
    from ..config import TrainConfig
    overrides = {"optimizer": args.optimizer}
    for flag, field in (("num_steps", "num_steps"), ("lr", "lr"),
                        ("batch", "batch_size"), ("accum", "accum_steps"),
                        ("freeze_bn", "freeze_bn"),
                        ("async_ckpt", "async_checkpointing")):
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    if args.train_size:
        overrides["image_size"] = tuple(args.train_size)
    for flag in ("ckpt_every", "log_every", "keep_checkpoints"):
        val = getattr(args, flag)
        if val is not None:
            if val < 1:
                print(f"ERROR: --{flag.replace('_', '-')} must be >= 1, "
                      f"got {val}")
                return None
            overrides[flag] = val
    if args.max_rollbacks is not None:
        if args.max_rollbacks < 0:
            print(f"ERROR: --max-rollbacks must be >= 0 (0 disables), "
                  f"got {args.max_rollbacks}")
            return None
        overrides["max_rollbacks"] = args.max_rollbacks
    return TrainConfig.for_stage(args.dataset, **overrides)


def load_state(path: str):
    """The ``--load`` weights as a model ``state_dict``."""
    from ..convert.weights import from_jax_params, load_params_npz
    try:
        if not path.endswith(".npz"):
            raise ValueError("not an .npz file")
        return from_jax_params(load_params_npz(path))
    except ValueError as e:
        raise NotImplementedError(
            f"--load {path}: only the native params npz loads into the "
            f"port ({e}); torch .pth, the reference's npz and training "
            f"checkpoints are ROADMAP item 14") from None


def _load_model(args, config):
    """The model ``-m val`` evaluates: ``--load``'s weights, else seeded
    random ones, on the device, in eval mode."""
    from ..models.raft import (RAFT, cast_encoder_weights, compute_dtype,
                               init_raft_torch, resolve_device)
    device = resolve_device("cpu" if args.cpu else None)
    if not args.load:
        return init_raft_torch(config, device=device)
    model = RAFT(config)
    model.load_state_dict(load_state(args.load), strict=True)
    return cast_encoder_weights(
        model.to(device, compute_dtype(config)).eval(), config)


def make_batches(args, tconfig, device, faults):
    """The training batches of ``--dataset``/``--data``: (PrefetchLoader,
    MPSampleLoader or None).  The caller closes both."""
    from ..data.datasets import make_training_dataset
    from ..data.pipeline import BatchBuffers, PrefetchLoader, batched
    device_aug = args.device_aug
    ds = make_training_dataset(args.dataset, args.data, tconfig.image_size,
                               device_aug=device_aug)
    print(f"[train] {args.dataset}: {len(ds)} samples, crop "
          f"{tconfig.image_size}, on {device}")
    augment_fn = None
    if device_aug:
        from ..data.augment_device import (DecodeOnlyDataset,
                                           make_batch_augment_fn,
                                           make_device_augmentor)
        ds = DecodeOnlyDataset(ds)
        augment_fn = make_batch_augment_fn(
            make_device_augmentor(args.dataset, tconfig.image_size),
            hw=ds.canonical_hw)
        print(f"[train] device-side augmentation on (src "
              f"{ds.canonical_hw} -> crop {tconfig.image_size})")
    loader = None
    if args.workers >= 1:
        from ..data.mp_loader import MPSampleLoader
        transport = "pickle" if args.shm_slots == 0 else "shm"
        loader = MPSampleLoader(
            ds, num_workers=args.workers, seed=tconfig.seed,
            start_method=args.mp_start,
            stall_timeout=args.stall_timeout or None, transport=transport,
            shm_slots=args.shm_slots or None, faults=faults,
            max_respawns=(3 if args.worker_respawns is None
                          else args.worker_respawns))
        samples = iter(loader)
        print(f"[train] {args.workers} decode"
              f"{'' if device_aug else '/augment'} worker processes "
              f"({transport} transport)")
    else:
        samples = ds.sample_iter(seed=tconfig.seed)
    depth = args.prefetch_depth
    raw = batched(samples, tconfig.batch_size,
                  collator=BatchBuffers.for_loader(tconfig.batch_size, depth))
    return (PrefetchLoader(raw, device, buffer_size=depth,
                           augment_fn=augment_fn, augment_seed=tconfig.seed),
            loader)


def main(argv=None) -> int:
    from ..models.raft import resolve_device
    from ..telemetry import events as tlm_events
    from .faults import make_train_injector
    from .loop import train
    from .resilience import PREEMPT_EXIT_CODE, TrainingPreempted

    args = build_parser().parse_args(argv)
    config = make_config(args)
    if args.mode == "val":
        from .evaluate import evaluate_cli
        return evaluate_cli(args, config, _load_model)
    tconfig = make_train_config(args)
    if tconfig is None:
        return 2
    for flag in ("workers", "prefetch_depth", "worker_respawns"):
        val = getattr(args, flag)
        if val is not None and val < (1 if flag == "prefetch_depth" else 0):
            print(f"ERROR: --{flag.replace('_', '-')} out of range: {val}")
            return 2
    device = resolve_device("cpu" if args.cpu else None)
    chaos_spec = args.chaos_train or os.environ.get("RAFT_TPU_CHAOS_TRAIN")
    faults = make_train_injector(chaos_spec, run_log=tlm_events.current())
    if faults is not None:
        print(f"[train] CHAOS ARMED: {chaos_spec}")
    # load before the loader starts, so a bad --load leaks no worker
    init_state = load_state(args.load) if args.load else None
    batch_iter, loader = make_batches(args, tconfig, device, faults)
    ckpt_dir = str(Path(args.out) / tconfig.ckpt_dir)
    try:
        train(config, tconfig, batch_iter, ckpt_dir=ckpt_dir,
              trace_dir=args.trace, trace_steps=args.trace_steps or 4,
              init_state=init_state, faults=faults, device=device)
    except TrainingPreempted as e:
        print(f"[train] PREEMPTED at step {e.step}: exit "
              f"{PREEMPT_EXIT_CODE}; rerun the same command to resume"
              + (f" from {e.ckpt_path}" if e.ckpt_path else
                 " from the last periodic checkpoint"))
        return PREEMPT_EXIT_CODE
    finally:
        # the prefetch pump first (it would keep pulling samples), then the
        # worker processes
        batch_iter.close()
        if loader is not None:
            loader.close()

    metrics_path = Path(ckpt_dir) / "metrics.jsonl"
    if metrics_path.exists():
        records = []
        for ln in metrics_path.read_text().splitlines():
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if "step" in rec and "epe" in rec:
                records.append(rec)
        if len(records) >= 2:
            first, last = records[0], records[-1]
            print(f"[train] EPE trajectory: step {first['step']} -> "
                  f"{first['epe']:.3f}  ...  step {last['step']} -> "
                  f"{last['epe']:.3f}  (curve: {metrics_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
