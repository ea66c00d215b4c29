"""The port's multi-rank dry run: ``dryrun_multichip(n)``.

The counterpart of the JAX package's ``__graft_entry__.py::
dryrun_multichip``, step for step, on ``n`` ranks of
``parallel/launch.py`` (gloo on the CPU unless CUDA is asked for, one
card a rank):

1. the dp x sp training step (``make_pjit_train_step(spatial_axis=
   'spatial')``, sp = 2 where ``n`` is even, dp = n / sp) of
   ``RAFTConfig.full(iters=2)`` on a seeded batch of dp samples at
   (16 * sp) x 48, H rounded up to ``spatial.required_h_multiple`` (the
   port's ring pools each slab's pyramid on its own rank; JAX's
   partitioner takes any H) and the rounding printed; one step, its loss
   finite;
2. the whole model row-sharded over all ``n`` ranks
   (``make_shard_inference_fn``: halo'd convolutions, instance norms over
   the image, the ring lookup) at ``corr_levels=2``, its flow finite;
3. the same with ``corr_impl='pallas'`` (the lookup kernel per ring slab;
   its plain twin on CPU tensors), against the onehot ring at JAX's
   ``atol=2e-3, rtol=1e-3``.

Run ``python -m raft_tpu_torch.parallel.dryrun --n 4`` (the CPU) or with
``--cuda`` (``n`` cards, NCCL).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _rank(rank: int, world: int, device: str) -> dict:
    from ..config import RAFTConfig, TrainConfig
    from ..models.raft import init_raft_torch
    from ..training import Batch, TrainState, make_optimizer
    from .data_parallel import make_pjit_train_step
    from .mesh import (DATA_AXIS, SPATIAL_AXIS, make_mesh, rank_device,
                       shard_batch)
    from .spatial import (gather_rows, make_shard_inference_fn,
                          required_h_multiple, shard_rows)
    dev = torch.device("cpu") if device == "cpu" else rank_device(rank, world)
    out = {}
    sp = 2 if world % 2 == 0 else 1
    dp = world // sp
    mesh = make_mesh((DATA_AXIS, SPATIAL_AXIS), shape=(dp, sp), device=dev)
    config = RAFTConfig.full(iters=2)
    tconfig = TrainConfig(num_steps=10, lr=1e-4, schedule="constant",
                          batch_size=dp)
    tx = make_optimizer(tconfig)
    gen = torch.Generator().manual_seed(0)
    state = TrainState.create(init_raft_torch(config, gen, device=dev), tx)
    need = required_h_multiple(config, sp)
    B, H, W = dp, 16 * sp, 48
    H_run = -(-H // need) * need
    rng = np.random.RandomState(0)
    batch = Batch(rng.rand(B, H_run, W, 3).astype(np.float32),
                  rng.rand(B, H_run, W, 3).astype(np.float32),
                  rng.randn(B, H_run, W, 2).astype(np.float32),
                  np.ones((B, H_run, W), np.float32))
    step = make_pjit_train_step(config, tconfig, tx, mesh,
                                data_axis=DATA_AXIS, spatial_axis=SPATIAL_AXIS)
    state, metrics = step(state, shard_batch(mesh, batch, DATA_AXIS,
                                             SPATIAL_AXIS), 1)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"the dp x sp step: loss {loss}, step "
                             f"{state.step}")
    out.update(dp=dp, sp=sp, hw=(H, W), hw_run=(H_run, W), need=need,
               loss=loss)

    ring_cfg = RAFTConfig.full(iters=2, corr_levels=2)
    ring_mesh = make_mesh((SPATIAL_AXIS,), shape=(world,), device=dev)
    Hs = 8 * world * 2
    im1 = rng.rand(1, Hs, 32, 3).astype(np.float32)
    im2 = rng.rand(1, Hs, 32, 3).astype(np.float32)
    model = init_raft_torch(ring_cfg, torch.Generator().manual_seed(2),
                            device=dev).eval()
    a, b = shard_rows(im1, ring_mesh), shard_rows(im2, ring_mesh)

    def whole(cfg):
        return gather_rows(make_shard_inference_fn(cfg, ring_mesh)(
            model, a, b), ring_mesh).cpu().numpy()
    flow = whole(ring_cfg)
    if flow.shape != (1, Hs, 32, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"ring/shard inference: {flow.shape}, finite "
                             f"{np.isfinite(flow).all()}")
    flow_pl = whole(RAFTConfig.full(iters=2, corr_levels=2,
                                    corr_impl="pallas"))
    if flow_pl.shape != flow.shape or not np.isfinite(flow_pl).all():
        raise AssertionError(f"pallas ring inference: {flow_pl.shape}")
    np.testing.assert_allclose(flow_pl, flow, atol=2e-3, rtol=1e-3)
    out.update(hs=Hs, flow_abs_mean=float(np.abs(flow).mean()),
               pallas_max_abs_diff=float(np.abs(flow_pl - flow).max()))
    return out


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     deadline_s: float = 600.0) -> dict:
    """The dry run on ``n_devices`` ranks (the module docstring); prints
    its lines as the JAX package's does and returns rank 0's record.
    Raises when a rank fails or a check does not hold."""
    from .distributed import default_backend
    from .launch import run_ranks
    if device != "cpu" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on CUDA needs "
                           f"{n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    threads = max(1, (torch.get_num_threads() or 1) // n_devices)
    res = run_ranks(_rank, n_devices, args=(device,),
                    backend=default_backend(device), group_timeout_s=120,
                    deadline_s=deadline_s,
                    threads=threads if device == "cpu" else None)
    r = res[0]
    if any(x["loss"] != r["loss"] for x in res):
        raise AssertionError(f"the ranks' losses differ: "
                             f"{[x['loss'] for x in res]}")
    print(f"dryrun_multichip: {n_devices} ranks on {device}")
    if r["hw_run"] != r["hw"]:
        print(f"dryrun_multichip: H {r['hw'][0]} rounded up to "
              f"{r['hw_run'][0]}, a multiple of required_h_multiple "
              f"{r['need']} (the ring pools each slab's pyramid itself)")
    print(f"dryrun_multichip: mesh dp={r['dp']} x sp={r['sp']} over "
          f"{n_devices} ranks, one train step at {r['dp']}x{r['hw_run'][0]}"
          f"x{r['hw_run'][1]} OK, loss={r['loss']:.4f}")
    print(f"dryrun_multichip: ring/shard inference over {n_devices} ranks "
          f"OK, |flow| mean={r['flow_abs_mean']:.4f}")
    print(f"dryrun_multichip: pallas ring inference over {n_devices} ranks "
          f"OK, matches onehot ring (max |d|={r['pallas_max_abs_diff']:.2e})")
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=4, help="ranks")
    p.add_argument("--cuda", action="store_true",
                   help="one card a rank over NCCL (default: the CPU, gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, "cuda" if args.cuda else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
