"""``python -m raft_tpu_torch.serving``: the port's serving entry point.

The counterpart of the JAX package's ``python -m raft_tpu.cli -m serve``,
with its serve flags and model flags.  It serves on the CUDA device unless
``--cpu`` asks for the CPU (where the factories run eager: a tiny model
for trying the stack out)::

    python -m raft_tpu_torch.serving --corr-impl pallas --gru-impl pallas \\
        --iters 12 --buckets 432x1024 --max-batch 4 --max-sessions 4 \\
        --port 8000
    python -m raft_tpu_torch.serving --cpu --small --iters 2 \\
        --buckets 32x48 --max-batch 2 --max-sessions 2 --port 0

``--load`` takes the native checkpoint npz that both packages read
(``'/'``-joined keys, HWIO kernels: ``load_params_npz`` +
``from_jax_params``); other checkpoint formats raise, naming ROADMAP item
14.  Without ``--load`` the server uses seeded random weights and warns.
``--dtype`` defaults to float32 (the JAX CLI picks bfloat16 only on a
TPU).  The JAX flags ``--engine-cache-dir`` (the AOT cache, ROADMAP item
9c) and ``--serve-dp`` (data-parallel serving, item 11) are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys


def _iters_policy_spec(spec: str) -> str:
    """argparse type hook: a malformed policy exits 2 with the usage line."""
    from ..config import parse_iters_policy
    parse_iters_policy(spec)
    return spec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.serving",
        description="RAFT optical-flow inference server (PyTorch/CUDA port)")
    # the model
    p.add_argument("--load", default=None,
                   help="checkpoint: the native params npz ('/'-joined "
                        "keys); default: seeded random weights")
    p.add_argument("--out", default=".",
                   help="output directory (events.jsonl, flightrec.jsonl, "
                        "metrics_ts.jsonl, profiles/)")
    p.add_argument("--small", action="store_true", help="raft-small variant")
    p.add_argument("--iters", type=int, default=None,
                   help="GRU iterations (default: 32 full / 12 small)")
    p.add_argument("--iters-policy", type=_iters_policy_spec, default=None,
                   metavar="POLICY",
                   help="'fixed' (default) or 'converge:eps[:min_iters]' "
                        "(per-sample early exit)")
    p.add_argument("--corr-impl", default="dense",
                   choices=["dense", "blockwise", "pallas"],
                   help="correlation: 'pallas' runs the CUDA lookup kernels")
    p.add_argument("--corr-lookup", default=None,
                   choices=["gather", "onehot"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"], help="compute dtype")
    p.add_argument("--ctx-hoist", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="precompute the GRU gate convs' context terms "
                        "outside the iteration loop (default on)")
    p.add_argument("--gru-impl", default=None, choices=["xla", "pallas"],
                   help="SepConvGRU: 'pallas' runs the CUDA GRU kernel, "
                        "'xla' its plain version")
    p.add_argument("--quant", default=None,
                   choices=("none", "int8", "bf16w", "int8+bf16w"),
                   help="'int8' slot-pool rows, 'bf16w' encoder weights "
                        "stored bfloat16, or both")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU (default: the CUDA device)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of device "
                        "batches 1..1+N")
    p.add_argument("--trace-steps", type=int, default=None, metavar="N",
                   help="device batches in the --trace window (default 4)")
    p.add_argument("--watchdogs", action="store_true",
                   help="graph-capture watch and device-memory gauges "
                        "(equivalent to RAFT_TPU_WATCHDOGS=1)")
    p.add_argument("--run-log", default=None, metavar="PATH",
                   help="run-event log: a directory or a .jsonl path "
                        "(default <--out>/events.jsonl; 'none' disables)")
    # the server (the JAX package's serve flags, same names and defaults)
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
    return p


def make_config(args):
    """The model configuration of the flags (the JAX CLI's
    ``_make_config``, float32 unless ``--dtype bfloat16``)."""
    from ..config import RAFTConfig
    overrides = dict(corr_impl=args.corr_impl, compute_dtype=args.dtype)
    for flag, field in (("ctx_hoist", "gru_ctx_hoist"),
                        ("gru_impl", "gru_impl"),
                        ("corr_lookup", "corr_lookup"),
                        ("iters_policy", "iters_policy"),
                        ("quant", "quant"), ("iters", "iters")):
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    if args.small:
        return RAFTConfig.small_model(**overrides)
    return RAFTConfig.full(**overrides)


def load_model(args, config):
    """The model to serve: the ``--load`` checkpoint, else seeded random
    weights (with a warning), on the CUDA device or, with ``--cpu``, the
    CPU, in the configuration's compute dtype."""
    from ..convert.weights import from_jax_params, load_params_npz
    from ..models.raft import RAFT, compute_dtype, init_raft_torch
    from ..models.raft import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    if not args.load:
        model = init_raft_torch(config, device=device)
        print("WARNING: no --load given; using RANDOM weights",
              file=sys.stderr)
        return model
    try:
        if not args.load.endswith(".npz"):
            raise ValueError("not an .npz file")
        state = from_jax_params(load_params_npz(args.load))
    except ValueError as e:
        raise NotImplementedError(
            f"--load {args.load}: only the native params npz loads into the "
            f"port ({e}); torch .pth, the reference's npz and training "
            f"checkpoints are ROADMAP item 14") from None
    model = RAFT(config)
    model.load_state_dict(state, strict=True)
    print(f"loaded checkpoint from {args.load}")
    return model.to(device, compute_dtype(config)).eval()


def main(argv=None) -> int:
    from ..telemetry import events
    from .server import serve_cli
    args = build_parser().parse_args(argv)
    if args.watchdogs:
        os.environ["RAFT_TPU_WATCHDOGS"] = "1"
    config = make_config(args)
    dest = args.run_log if args.run_log is not None else args.out
    if dest and dest != "none":
        events.set_current(events.start_run(dest, mode="serve",
                                            config=config))
    return serve_cli(args, config, load_model)


if __name__ == "__main__":
    sys.exit(main())
