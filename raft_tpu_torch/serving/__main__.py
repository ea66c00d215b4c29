"""``python -m raft_tpu_torch.serving``: the port's serving entry point.

The counterpart of the JAX package's ``python -m raft_tpu.cli -m serve``
(and of the port's ``python -m raft_tpu_torch.cli -m serve``), with its
serve flags and model flags, built from the CLI's flag groups, config and
loader (``raft_tpu_torch/cli.py``).  It serves on the CUDA device unless
``--cpu`` asks for the CPU (where the factories run eager: a tiny model
for trying the stack out)::

    python -m raft_tpu_torch.serving --corr-impl pallas --gru-impl pallas \\
        --iters 12 --buckets 432x1024 --max-batch 4 --max-sessions 4 \\
        --port 8000
    python -m raft_tpu_torch.serving --cpu --small --iters 2 \\
        --buckets 32x48 --max-batch 2 --max-sessions 2 --port 0

``--load`` takes every checkpoint format the CLI's loader reads (torch
``.pth``, the reference's npz, a training checkpoint, the native npz).
Without it the server uses seeded random weights and warns.  ``--dtype``
defaults to float32 (the JAX CLI picks bfloat16 only on a TPU).
``--serve-dp N`` serves each batch over ``cuda:0..N-1`` (one replica a
card; batch steps rounded up to multiples of N).  ``--engine-cache-dir``
attaches the AOT engine cache (``serving/aot_cache.py``): the kernel
objects come from it where ``build/`` lacks them, and each warm key is
checked against its probe entry (``/healthz`` ``engine_cache``).
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.serving",
        description="RAFT optical-flow inference server (PyTorch/CUDA port)")
    cli.add_model_flags(p)
    cli.add_config_flags(p)
    cli.add_telemetry_flags(p)
    cli.add_serve_flags(p)
    return p


make_config = cli.make_config
load_model = cli.load_model


def main(argv=None) -> int:
    from .server import serve_cli
    args = build_parser().parse_args(argv)
    cli.check_unported(args)
    if args.watchdogs:
        os.environ["RAFT_TPU_WATCHDOGS"] = "1"
    config = make_config(args)
    cli.start_run_log(args, config, mode="serve")
    return serve_cli(args, config, load_model)


if __name__ == "__main__":
    sys.exit(main())
