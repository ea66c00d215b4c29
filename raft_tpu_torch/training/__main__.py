"""``python -m raft_tpu_torch.training``: the port's training entry point.

The counterpart of the JAX package's ``python -m raft_tpu.cli -m train``,
with the train flags that apply to what the port has.  It trains on the
CUDA device unless ``--cpu`` asks for the CPU::

    python -m raft_tpu_torch.training --dataset synthetic \\
        --train-size 368 496 --batch 10 --iters 12 --num-steps 1000 \\
        --out runs/synth
    python -m raft_tpu_torch.training --cpu --small --iters 2 --batch 2 \\
        --train-size 32 48 --num-steps 4 --ckpt-every 2 --out /tmp/run

``--dataset`` names a curriculum stage (its ``TrainConfig.for_stage``
preset; explicit flags win); only ``synthetic`` has data in the port (the
procedural dataset at ``--train-size``): the other stages' readers are
ROADMAP item 8.  The model is ``RAFTConfig.full(corr_impl='pallas',
gru_impl='pallas')`` (the CUDA kernels; their plain versions on the CPU)
or, with ``--small``, raft-small.  ``--load`` takes the native params npz;
other formats raise (ROADMAP item 14).  A preempted run (SIGTERM/SIGINT)
writes an emergency checkpoint and exits 17; the same command resumes
from the newest readable checkpoint in ``<--out>/checkpoints``.
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
        description="RAFT training (PyTorch/CUDA port)")
    p.add_argument("--dataset", default="synthetic",
                   choices=["chairs", "things", "sintel", "kitti",
                            "synthetic"],
                   help="curriculum stage (its presets); only 'synthetic' "
                        "has data in the port")
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
                        "window")
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


def main(argv=None) -> int:
    from ..data.datasets import make_training_dataset
    from ..data.pipeline import BatchBuffers, PrefetchLoader, batched
    from ..models.raft import resolve_device
    from ..telemetry import events as tlm_events
    from .faults import make_train_injector
    from .loop import train
    from .resilience import PREEMPT_EXIT_CODE, TrainingPreempted

    args = build_parser().parse_args(argv)
    config = make_config(args)
    tconfig = make_train_config(args)
    if tconfig is None:
        return 2
    device = resolve_device("cpu" if args.cpu else None)
    chaos_spec = args.chaos_train or os.environ.get("RAFT_TPU_CHAOS_TRAIN")
    faults = make_train_injector(chaos_spec, run_log=tlm_events.current())
    if faults is not None:
        print(f"[train] CHAOS ARMED: {chaos_spec}")
    init_state = load_state(args.load) if args.load else None
    ds = make_training_dataset(args.dataset, None, tconfig.image_size)
    print(f"[train] {args.dataset}: {len(ds)} samples at "
          f"{tconfig.image_size}, on {device}")
    depth = 2
    raw = batched(ds.sample_iter(seed=tconfig.seed), tconfig.batch_size,
                  collator=BatchBuffers.for_loader(tconfig.batch_size, depth))
    batch_iter = PrefetchLoader(raw, device, buffer_size=depth)
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
        batch_iter.close()

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
