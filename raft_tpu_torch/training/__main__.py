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
or, with ``--small``, raft-small; ``--dtype bfloat16`` runs it under a
bfloat16 forward on float32 master weights.  On the card each step
replays a captured CUDA graph (``training/capture.py``), on the CPU it
runs eager.  The flags, the run log and ``--load``
are the CLI's (``raft_tpu_torch/cli.py``, whose ``-m train`` and ``-m
val`` run :func:`train_cli` and ``evaluate_cli``): ``--load`` takes torch
``.pth``, the reference's npz, a training checkpoint or the native npz.
``-m val`` without ``--load`` evaluates seeded random weights and says
so.  A preempted training run
(SIGTERM/SIGINT) writes an emergency checkpoint and exits 17; the same
command resumes from the newest readable checkpoint in
``<--out>/checkpoints``.

Multi-process (data-parallel) training runs this command once per rank
with ``--coordinator HOST:PORT --num-processes N --process-id I`` (or
``RAFT_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``), each rank
on its own card (``cuda:<rank>``; ``--cpu``: gloo on the CPU).
``--batch`` is the global batch: each rank keeps its slice of the same
deterministic sample stream, or with ``--shard-data`` reads its own 1/N of
the dataset (seeds offset by rank); ``--workers`` needs ``--shard-data``.
Rank 0 alone writes checkpoints and ``metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .. import cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.training",
        description="RAFT training and evaluation (PyTorch/CUDA port)")
    p.add_argument("-m", "--mode", default="train", choices=["train", "val"],
                   help="train (default) or val: EPE over a dataset")
    cli.add_train_flags(p, dataset_default="synthetic")
    cli.add_multiprocess_flags(p)
    cli.add_model_flags(p)
    cli.add_dtype_flag(p)
    cli.add_telemetry_flags(p)
    return p


def make_config(args):
    from ..config import RAFTConfig
    overrides = {"compute_dtype": args.dtype}
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


def _local_slices(batches, sl: slice):
    for b in batches:
        yield tuple(x[sl] for x in b)


def make_batches(args, tconfig, device, faults):
    """The training batches of ``--dataset``/``--data``: (PrefetchLoader,
    MPSampleLoader or None).  The caller closes both.

    Multi-process: ``tconfig.batch_size`` is the global batch.  Every rank
    builds the same deterministic stream and keeps its
    ``local_batch_slice`` (the single-process batches, cut); with
    ``--shard-data`` it reads only its 1/N of the dataset
    (``ShardedDataset``), its local batch straight from it, seeds offset
    by ``1000003 * rank``.  The device augmentation's seed is offset by
    ``999983 * rank`` (each rank augments other samples)."""
    from ..data.datasets import ShardedDataset, make_training_dataset
    from ..data.pipeline import BatchBuffers, PrefetchLoader, batched
    from ..parallel.distributed import local_batch_slice, process_info
    pid, pcount = process_info()
    if pcount > 1 and tconfig.batch_size % pcount:
        raise ValueError(
            f"global batch {tconfig.batch_size} must divide evenly across "
            f"{pcount} processes (each loads batch/processes samples)")
    shard_data = pcount > 1 and args.shard_data
    if pcount > 1 and not shard_data and args.workers >= 1:
        # worker arrival order is scheduling-dependent (data/mp_loader.py),
        # so each rank would slice a differently ordered stream: samples
        # trained twice or never, silently.  Refuse before anything starts
        raise ValueError(
            "--workers needs --shard-data under multi-host training: "
            "the worker pool reorders samples per host, breaking the "
            "identical-global-stream slicing. Pass --shard-data (each "
            "host trains on its own 1/N of the data) or drop --workers "
            "(decode runs in the prefetch thread).")
    device_aug = args.device_aug
    ds = make_training_dataset(args.dataset, args.data, tconfig.image_size,
                               device_aug=device_aug)
    print(f"[train] {args.dataset}: {len(ds)} samples, crop "
          f"{tconfig.image_size}, on {device}")
    seed, local_batch = tconfig.seed, tconfig.batch_size
    if shard_data:
        ds = ShardedDataset(ds, pid, pcount)
        seed = tconfig.seed + 1000003 * pid
        local_batch = tconfig.batch_size // pcount
        print(f"[train] data shard {pid}/{pcount}: {len(ds)} samples")
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
            ds, num_workers=args.workers, seed=seed,
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
        samples = ds.sample_iter(seed=seed)
    depth = args.prefetch_depth
    raw = batched(samples, local_batch,
                  collator=BatchBuffers.for_loader(local_batch, depth))
    if pcount > 1 and not shard_data:
        raw = _local_slices(raw, local_batch_slice(tconfig.batch_size))
    return (PrefetchLoader(raw, device, buffer_size=depth,
                           augment_fn=augment_fn,
                           augment_seed=seed + 999_983 * pid),
            loader)


def train_cli(args, config) -> int:
    """``-m train``: the stage preset with the flags' overrides, the
    batches, the loop; returns the exit code (17 when preempted)."""
    from ..telemetry import events as tlm_events
    from .faults import make_train_injector
    from ..parallel.distributed import process_info
    from ..parallel.mesh import rank_device
    from .loop import train
    from .resilience import PREEMPT_EXIT_CODE, TrainingPreempted

    tconfig = make_train_config(args)
    if tconfig is None:
        return 2
    for flag in ("workers", "prefetch_depth", "worker_respawns"):
        val = getattr(args, flag)
        if val is not None and val < (1 if flag == "prefetch_depth" else 0):
            print(f"ERROR: --{flag.replace('_', '-')} out of range: {val}")
            return 2
    device = cli.device_of(args)
    rank, world = process_info()
    if world > 1 and device.type == "cuda":
        device = rank_device(rank, world)     # this rank's own card
    chaos_spec = args.chaos_train or os.environ.get("RAFT_TPU_CHAOS_TRAIN")
    faults = make_train_injector(chaos_spec, run_log=tlm_events.current())
    if faults is not None:
        print(f"[train] CHAOS ARMED: {chaos_spec}")
    # load before the loader starts, so a bad --load leaks no worker
    init_state = (cli.load_state_dict(args.load, args.rgb) if args.load
                  else None)
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cli.device_of(args)             # no CUDA and no --cpu: raise, run nothing
    if args.watchdogs:
        os.environ["RAFT_TPU_WATCHDOGS"] = "1"
    config = make_config(args)
    cli.start_run_log(args, config)
    if args.mode == "train":
        cli.init_distributed(args)
    if args.mode == "val":
        from .evaluate import evaluate_cli
        return evaluate_cli(args, config, cli.load_model)
    return train_cli(args, config)


if __name__ == "__main__":
    sys.exit(main())
