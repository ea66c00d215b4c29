"""The rank programs of the port's parallel-layer tests
(tests/test_torch_port_spmd.py, test_torch_port_dp.py): what each spawned
gloo rank runs, and the seeded inputs the test process builds too.  Torch
and numpy only, so a rank never imports JAX (a spawned rank imports this
module by name).

Each test module starts ONE group of ranks (``parallel/launch.py``, a
``file://`` rendezvous under the test's tmp_path, a 60 s group timeout,
a deadline on the whole group) that runs every case of the module in one
rendezvous and returns the outputs; each case is then its own test.
"""

import numpy as np
import torch

THREADS = 2            # each rank's torch threads (the test workers share
#                        the host's cores)

# -- seeded inputs ------------------------------------------------------------


def rand(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _grid(B: int, H: int, W: int) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    return np.broadcast_to(np.stack([xs, ys], -1)[None], (B, H, W, 2))


def ring_inputs(which: str):
    """(f1, f2, coords, levels, radius) of the JAX package's
    ``test_ring_corr_lookup_matches_dense`` ('onehot'),
    ``test_ring_lookup_via_fused_kernel_matches_dense`` ('fused') and
    ``test_spatial_corr_lookup_matches_dense`` ('spatial'), drawn as those
    tests draw them."""
    seed, (B, H, W, C), spread = {
        "onehot": (3, (1, 32, 12, 16), 5.0),
        "fused": (5, (1, 16, 12, 16), 4.0),
        "spatial": (1, (1, 16, 12, 32), 3.0)}[which]
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    off = rng.uniform(-spread, spread, (B, H, W, 2)).astype(np.float32)
    return f1, f2, (_grid(B, H, W) + off).astype(np.float32), 2, 3


# the small row-sharded ops: name -> (inputs, options)
OP_INPUTS = {
    "halo": rand(10, 2, 16, 6, 4),
    "conv_x": rand(0, 2, 32, 16, 4),
    "conv_w": rand(1, 5, 5, 4, 8),
    "inorm": rand(11, 2, 16, 6, 8, scale=2.0) + 0.5,
    "shift": rand(12, 1, 16, 6, 2),
    "upflow": rand(13, 1, 8, 6, 2, scale=3.0),
}
CONV_CTX = ((3, 1), (3, 2), (7, 2), (1, 2))   # (kernel, stride)


def conv_ctx_weights(k: int):
    return rand(20 + k, k, k, 4, 6, scale=0.5), rand(40 + k, 6, scale=0.1)


# the whole-model cases: name -> (config overrides of RAFTConfig.full or
# .small_model, image shape, image seed)
MODEL_CASES = {
    "things_hoist": (False, {}, (1, 256, 48, 3), 5),
    "things_nohoist": (False, {"gru_ctx_hoist": False}, (1, 256, 48, 3), 5),
    "small_hoist": (True, {}, (1, 256, 48, 3), 5),
    "small_nohoist": (True, {"gru_ctx_hoist": False}, (1, 256, 48, 3), 5),
    "things_levels2": (False, {"corr_levels": 2}, (1, 64, 32, 3), 6),
}
MODEL_ITERS = 2


def model_config(name: str):
    from raft_tpu_torch import RAFTConfig
    small, kw, _, _ = MODEL_CASES[name]
    base = RAFTConfig.small_model if small else RAFTConfig.full
    return base(iters=MODEL_ITERS, **kw)


def model_images(name: str):
    _, _, shape, seed = MODEL_CASES[name]
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def biased_model(config, seed: int = 3):
    """The port's seeded random weights (float32, on the CPU) with every
    conv bias and batch-norm ``beta`` drawn from U(-0.25, 0.25), every
    ``gamma`` from U(0.75, 1.25) and the running statistics away from 0
    and 1, so the halo'd biases and the synchronized statistics are
    exercised (what tests/torch_train_parity.py's ``make_params`` draws,
    built without JAX)."""
    from raft_tpu_torch import init_raft_torch
    model = init_raft_torch(config, torch.Generator().manual_seed(seed),
                            device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(seed + 1000)
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_mean":
                v = rng.uniform(-0.05, 0.05, t.shape)
            elif leaf == "running_var":
                v = rng.uniform(0.9, 1.1, t.shape)
            elif leaf == "bias":
                v = rng.uniform(-0.25, 0.25, t.shape)
            elif leaf == "weight" and t.dim() == 1:          # BN gamma
                v = rng.uniform(0.75, 1.25, t.shape)
            else:
                continue
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def slab(x: np.ndarray, idx: int, n: int) -> np.ndarray:
    """Row slab ``idx`` of ``n`` (dim 1)."""
    h = x.shape[1] // n
    return np.ascontiguousarray(x[:, idx * h:(idx + 1) * h])


# -- the spmd module's ranks --------------------------------------------------

def spmd_rank(rank: int, world: int, model_cases) -> dict:
    """Every row-sharded case of tests/test_torch_port_spmd.py on this
    rank of 4: the 2-rank cases on the spatial pairs {0, 1} and {2, 3}, the
    4-rank ones on all four; returns {case: this rank's output slab}."""
    from raft_tpu_torch.ops import spmd
    from raft_tpu_torch.ops.conv import conv2d, to_nchw, to_nhwc
    from raft_tpu_torch.ops.norm import instance_norm
    from raft_tpu_torch.ops.upsample import _shift_stack_3x3, upflow8
    from raft_tpu_torch.parallel import (SPATIAL_AXIS, conv2d_row_sharded,
                                         halo_exchange, make_mesh,
                                         make_ring_corr_lookup,
                                         make_shard_inference_fn,
                                         make_spatial_corr_lookup,
                                         make_spatial_inference_fn)
    assert world == 4
    torch.set_num_threads(THREADS)
    meshes = {4: make_mesh((SPATIAL_AXIS,), device="cpu"),
              2: make_mesh(("data", SPATIAL_AXIS), shape=(2, 2),
                           device="cpu")}
    out = {}

    def t(x):
        return torch.from_numpy(x)

    for n, mesh in meshes.items():
        ax = mesh[SPATIAL_AXIS]
        i = ax.index

        def s(x):
            return t(slab(x, i, n))
        x = OP_INPUTS["halo"]
        for halo in (2, 16 // n + 1):
            out[f"halo{n}_{halo}"] = halo_exchange(s(x), halo, ax).numpy()
        out[f"conv{n}"] = conv2d_row_sharded(
            s(OP_INPUTS["conv_x"]), t(OP_INPUTS["conv_w"]), axis=ax).numpy()
        with spmd.spatial_sharding(ax):
            for k, stride in CONV_CTX:
                w, b = conv_ctx_weights(k)
                out[f"convctx{n}_{k}_{stride}"] = conv2d(
                    s(OP_INPUTS["conv_x"]), t(w), t(b), stride).numpy()
            out[f"inorm{n}"] = to_nhwc(instance_norm(to_nchw(
                s(OP_INPUTS["inorm"])))).numpy()
            out[f"shift{n}"] = _shift_stack_3x3(s(OP_INPUTS["shift"])).numpy()
            out[f"upflow{n}"] = upflow8(s(OP_INPUTS["upflow"])).numpy()
        for which in ("onehot", "fused"):
            f1, f2, c, levels, radius = ring_inputs(which)
            variants = ({"onehot": ("onehot", None)} if which == "onehot"
                        else {"all": ("pallas", {"p_select": "all"}),
                              "window": ("pallas", {"p_select": "window"}),
                              "pack": ("pallas", {"p_select": "window",
                                                  "pack_rows": True})})
            for name, (kernel, opts) in variants.items():
                fn = make_ring_corr_lookup(mesh, levels, radius,
                                           kernel=kernel, pallas_opts=opts)
                out[f"ring_{name}{n}"] = fn(s(f1), s(f2), s(c)).numpy()
        f1, f2, c, levels, radius = ring_inputs("spatial")
        out[f"spatial_lookup{n}"] = make_spatial_corr_lookup(
            mesh, levels, radius)(s(f1), s(f2), s(c)).numpy()
    mesh = meshes[4]
    for name in model_cases:
        cfg = model_config(name)
        model = biased_model(cfg).eval()
        im1, im2 = model_images(name)
        fn = make_shard_inference_fn(cfg, mesh, iters=MODEL_ITERS)
        out[f"model_{name}"] = fn(model, slab(im1, rank, 4),
                                  slab(im2, rank, 4)).numpy()
        if name == "small_hoist":      # whole images in, the whole flow out
            out["spatial_fn_small_hoist"] = make_spatial_inference_fn(
                cfg, mesh, iters=MODEL_ITERS)(model, im1, im2).numpy()
    out["stats"] = spmd.STATS.snapshot()
    return out


# -- the data-parallel module's ranks -----------------------------------------

def make_batch(seed: int = 0, B: int = 4, H: int = 48, W: int = 64):
    """Seeded (im1, im2, flow, valid): frames in [0, 1], flows of a few
    pixels, about 70% of the pixels valid (tests/torch_train_parity.py's
    batch)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(B, H, W, 3).astype(np.float32),
            rng.rand(B, H, W, 3).astype(np.float32),
            (3.0 * rng.randn(B, H, W, 2)).astype(np.float32),
            (rng.rand(B, H, W) > 0.3).astype(np.float32))


# name -> (small, train-config overrides)
DP_CASES = {
    "things_sgd": (False, dict(optimizer="sgd", schedule="constant",
                               lr=1e-4)),
    "things_adamw": (False, dict(optimizer="adamw")),
    "small_sgd": (True, dict(optimizer="sgd", schedule="constant", lr=1e-4)),
    "small_adamw": (True, dict(optimizer="adamw")),
    "small_sgd_accum2": (True, dict(optimizer="sgd", schedule="constant",
                                    lr=1e-4, accum_steps=2)),
}
DP_BATCH = 4


def dp_configs(name: str):
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    small, kw = DP_CASES[name]
    cfg = (RAFTConfig.small_model if small else RAFTConfig.full)(iters=2)
    tc = TrainConfig(**{**dict(num_steps=100, lr=4e-4, batch_size=DP_BATCH,
                               image_size=(48, 64), weight_decay=1e-4), **kw})
    return cfg, tc


def step_with_grads(cfg, tc, batch, mesh=None, seed: int = 0):
    """One train step from :func:`biased_model` on ``batch`` (the whole
    batch, or with ``mesh`` this rank's rows through the data-parallel
    step); returns (loss, {param name: gradient handed to the optimizer},
    {buffer name: value after}, float64 sum of the parameters after)."""
    from raft_tpu_torch.parallel import make_dp_train_step, shard_batch
    from raft_tpu_torch.training import (Batch, TrainState, make_optimizer,
                                         make_train_step)
    tx = make_optimizer(tc)
    model = biased_model(cfg)
    state = TrainState.create(model, tx)
    got = {}

    class Capture:
        """The optimizer, keeping the gradients it is given."""

        def update(self, grads, opt_state, ps):
            got["g"] = [g.detach().clone() for g in grads]
            return tx.update(grads, opt_state, ps)
    if mesh is None:
        step = make_train_step(cfg, tc, Capture())
        b = Batch(*map(torch.from_numpy, batch))
    else:
        step = make_dp_train_step(cfg, tc, Capture(), mesh)
        b = shard_batch(mesh, Batch(*batch))
    state, metrics = step(state, b, seed)
    grads = {n: g.numpy() for (n, _), g in
             zip(state.model.named_parameters(), got["g"])}
    bufs = {n: v.detach().numpy().copy()
            for n, v in state.model.named_buffers()}
    total = float(sum(p.detach().double().sum()
                      for p in state.model.parameters()))
    return float(metrics["loss"]), grads, bufs, total


def dp_rank(rank: int, world: int, names) -> dict:
    """Each case of :data:`DP_CASES` through ``make_dp_train_step`` on this
    rank's rows of the :func:`make_batch` global batch; rank 0 returns
    everything, the others their loss and parameter sum (which must equal
    rank 0's bit for bit: one update on every replica)."""
    from raft_tpu_torch.parallel import DATA_AXIS, make_mesh
    torch.set_num_threads(THREADS)
    mesh = make_mesh((DATA_AXIS,), device="cpu")
    out = {}
    for name in names:
        cfg, tc = dp_configs(name)
        loss, grads, bufs, total = step_with_grads(
            cfg, tc, make_batch(7, DP_BATCH), mesh)
        out[name] = ((loss, grads, bufs, total) if rank == 0
                     else (loss, None, None, total))
    return out


# -- the row-sharded training module's ranks -----------------------------------

# name -> (small, config overrides, train-config overrides, global batch);
# every case at corr_levels=2 and H x W = 32 x 48 (the dryrun's ring shape
# rule: H = 16 * sp, a multiple of required_h_multiple at sp = 2)
# The raft-things cases run the converge policy at an eps between the two
# samples' whole-image update norms after the first iteration (6.98 and
# 8.58) and above one of sample 1's slab norms (7.84): sample 0 freezes,
# sample 1 runs every iteration (the fixed policy's path), and a
# slab-local norm would freeze sample 1 on one rank only
CONVERGE = "converge:8.2:1"
SP_CASES = {
    "small_sgd_accum2": (True, {}, dict(optimizer="sgd", schedule="constant",
                                        lr=1e-4, accum_steps=2), 4),
    "things_adamw": (False, dict(iters_policy=CONVERGE),
                     dict(optimizer="adamw"), 2),
    "things_pallas": (False, dict(iters_policy=CONVERGE, corr_impl="pallas",
                                  gru_impl="pallas"),
                      dict(optimizer="adamw"), 2),
}
# the case whose JAX step is each case's reference: the kernels' twins
# compute the plain path's function, so the pallas case is held to it
SP_REFERENCE = {"things_pallas": "things_adamw"}
SP_MESH = (2, 2)                 # dp x sp over the 4 ranks
SP_HW = (32, 48)
SP_BATCH_SEED = 3


def sp_configs(name: str):
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    small, kw, tkw, B = SP_CASES[name]
    cfg = (RAFTConfig.small_model if small else RAFTConfig.full)(
        iters=2, corr_levels=2, **kw)
    tc = TrainConfig(**{**dict(num_steps=100, lr=4e-4, batch_size=B,
                               image_size=SP_HW, weight_decay=1e-4), **tkw})
    return cfg, tc


def sp_batch(name: str):
    return make_batch(SP_BATCH_SEED, SP_CASES[name][3], *SP_HW)


def _digest(state) -> str:
    """A hash of every tensor of a train state (bitwise equality)."""
    import hashlib
    from raft_tpu_torch.convert.weights import to_jax_train_state
    h = hashlib.sha1()
    for k, v in sorted(to_jax_train_state(state).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def sp_step(cfg, tc, batch, mesh=None):
    """One row-sharded step (``make_pjit_train_step(spatial_axis=
    'spatial')`` on this rank's share of ``batch``; without ``mesh`` the
    single-process step on the whole batch) from :func:`biased_model`;
    returns (loss, metrics, gradients by JAX path, the JAX-named state
    after, its digest)."""
    from raft_tpu_torch.convert.weights import _jax_leaves, to_jax_train_state
    from raft_tpu_torch.parallel import make_pjit_train_step, shard_batch
    from raft_tpu_torch.training import (Batch, TrainState, make_optimizer,
                                         make_train_step)
    tx = make_optimizer(tc)
    state = TrainState.create(biased_model(cfg), tx)
    got = {}

    class Capture:
        """The optimizer, keeping the gradients it is given."""

        def update(self, grads, opt_state, ps):
            got["g"] = [g.detach().clone() for g in grads]
            return tx.update(grads, opt_state, ps)
    if mesh is None:
        step = make_train_step(cfg, tc, Capture())
        b = Batch(*map(torch.from_numpy, batch))
    else:
        step = make_pjit_train_step(cfg, tc, Capture(), mesh,
                                    spatial_axis="spatial")
        b = shard_batch(mesh, Batch(*batch), spatial_axis="spatial")
    state, metrics = step(state, b, 0)
    layout = _jax_leaves(state.model.state_dict().keys())
    grads = {}
    for (n, _), g in zip(state.model.named_parameters(), got["g"]):
        path, kernel = layout[n]
        g = g.numpy().astype(np.float64)
        grads[path] = g.transpose(2, 3, 1, 0) if kernel else g
    return (float(metrics["loss"]), {k: float(v) for k, v in metrics.items()},
            grads, to_jax_train_state(state), _digest(state))


def thread_backward_case(mesh):
    """The gradients of one row-sharded training forward (raft-things,
    ``gru_impl='pallas'`` on the CPU twin, ``remat_iters``: the three
    backwards that recompute under the context) computed on the calling
    thread and on a fresh ``threading.Thread`` that never entered the
    context, as the autograd engine's device thread runs a CUDA backward;
    returns the largest difference between the two and the norm."""
    import threading
    from raft_tpu_torch import RAFTConfig, raft_forward
    from raft_tpu_torch.ops import spmd
    from raft_tpu_torch.parallel import shard_batch
    from raft_tpu_torch.training.loss import sequence_loss
    from raft_tpu_torch.training.step import Batch
    cfg = RAFTConfig.full(iters=2, corr_levels=2, gru_impl="pallas",
                          remat_iters=True)
    model = biased_model(cfg)
    params = [p for p in model.parameters()]
    b = shard_batch(mesh, Batch(*make_batch(SP_BATCH_SEED, 2, *SP_HW)),
                    spatial_axis="spatial")
    ax = mesh["spatial"]

    def loss():
        with spmd.spatial_sharding(ax):
            out = raft_forward(model, b.image1, b.image2, cfg, train=True,
                               sync_axis=(mesh["data"],))
            return sequence_loss(out.flow_iters, b.flow, b.valid,
                                 axes=[mesh["data"], ax])[0]
    here = torch.autograd.grad(loss(), params)
    box = {}
    graph_loss = loss()

    def run():
        try:
            box["g"] = torch.autograd.grad(graph_loss, params)
        except BaseException as e:          # noqa: BLE001 — re-raised below
            box["e"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "e" in box:
        raise box["e"]
    diff = max(float((a - c).abs().max()) for a, c in zip(here, box["g"]))
    norm = max(float(a.abs().max()) for a in here)
    return diff, norm


def sp_rank(rank: int, world: int, names) -> dict:
    """Each case of :data:`SP_CASES` through the row-sharded step on this
    rank of the dp x sp mesh, and :func:`thread_backward_case`; rank 0
    returns everything, the others their loss and state digest."""
    from raft_tpu_torch.parallel import (DATA_AXIS, SPATIAL_AXIS, make_mesh,
                                         shard_batch)
    torch.set_num_threads(THREADS)
    mesh = make_mesh((DATA_AXIS, SPATIAL_AXIS), shape=SP_MESH, device="cpu")
    out = {}
    for name in names:
        cfg, tc = sp_configs(name)
        loss, metrics, grads, named, digest = sp_step(cfg, tc,
                                                      sp_batch(name), mesh)
        out[name] = ((loss, metrics, grads, named, digest) if rank == 0
                     else (loss, None, None, None, digest))
    out["thread"] = thread_backward_case(mesh)
    out["masks"] = sp_masks(mesh)
    from raft_tpu_torch.training import epe_metrics
    pred, gt, valid = epe_inputs()
    axes = [mesh[DATA_AXIS], mesh[SPATIAL_AXIS]]
    b = shard_batch(mesh, (pred, gt, valid), spatial_axis=SPATIAL_AXIS)
    out["epe"] = {r: {k: float(v) for k, v in
                      epe_metrics(*b, reduce=r, axes=axes).items()}
                  for r in ("mean", "sum")}
    return out


def epe_inputs():
    """A seeded prediction, ground truth and valid mask [2, 32, 48]."""
    rng = np.random.RandomState(23)
    gt = (3.0 * rng.randn(2, *SP_HW, 2)).astype(np.float32)
    pred = (gt + 4.0 * rng.randn(2, *SP_HW, 2)).astype(np.float32)
    return pred, gt, (rng.rand(2, *SP_HW) > 0.3).astype(np.float32)


# -- the collectives' transposes ----------------------------------------------

GRAD_X = rand(30, 1, 8, 3, 4)            # the global input, 2 rows a rank
# name -> (the op on this rank's slab, the global output's rows)
GRAD_OPS = ("psum", "pmean", "all_gather", "ring", "shift", "halo1",
            "halo3")


def grad_op(name: str, x, axis):
    """Collective ``name`` of the port on ``x`` (this rank's slab)."""
    from raft_tpu_torch.ops import spmd
    n = axis.size
    if name == "psum":
        return spmd.psum(x, axis)
    if name == "pmean":
        return spmd.pmean(x, axis)
    if name == "all_gather":
        return spmd.all_gather(x, axis, dim=1)
    if name == "ring":
        return spmd.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])
    if name == "shift":
        return spmd.ppermute(x, axis, [(i, i + 1) for i in range(n - 1)])
    return spmd.halo_exchange(x, int(name[4:]), axis, dim=1)


def grad_cotangent(name: str, rows: int) -> np.ndarray:
    """The seeded cotangent of op ``name``'s global output of ``rows``
    rows (every rank's output concatenated along H)."""
    return rand(40 + GRAD_OPS.index(name), 1, rows, 3, 4)


def grad_rank(rank: int, world: int) -> dict:
    """Each collective of :data:`GRAD_OPS` on this rank's slab of
    :data:`GRAD_X` over a 4-rank axis, and its vjp with this rank's slab
    of the seeded cotangent; returns {name: (output, input's gradient)}
    and the collective counts of the forwards and the backwards apart."""
    from raft_tpu_torch.ops import spmd
    from raft_tpu_torch.parallel import SPATIAL_AXIS, make_mesh
    torch.set_num_threads(THREADS)
    ax = make_mesh((SPATIAL_AXIS,), device="cpu")[SPATIAL_AXIS]
    out = {}
    spmd.reset_stats()
    for name in GRAD_OPS:
        x = torch.from_numpy(slab(GRAD_X, rank, world)).requires_grad_()
        y = grad_op(name, x, ax)
        rows = y.shape[1]
        ct = torch.from_numpy(slab(grad_cotangent(name, rows * world), rank,
                                   world))
        (g,) = torch.autograd.grad(y, x, ct)
        out[name] = (y.detach().numpy(), g.numpy())
    out["stats"] = spmd.STATS.snapshot()
    return out


MASK_CFG = dict(iters=2, corr_levels=2, dropout=0.25)
MASK_GLOBAL_B, MASK_ACCUM, MASK_SEED = 4, 2, 5


def sp_masks(mesh) -> list:
    """This rank's dropout masks of a row-sharded step (global batch
    :data:`MASK_GLOBAL_B` over the data axis, :data:`MASK_ACCUM`
    micro-batches), per micro-batch (fnet's, cnet's) as arrays."""
    from raft_tpu_torch import RAFTConfig
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.training import make_optimizer, make_train_step
    tc = TrainConfig(accum_steps=MASK_ACCUM)
    step = make_train_step(RAFTConfig.full(**MASK_CFG), tc, make_optimizer(tc),
                           axis=mesh["data"], spatial=mesh["spatial"])
    local = MASK_GLOBAL_B // mesh["data"].size
    return [tuple(t.numpy() for t in m)
            for m in step.masks(local, MASK_SEED)]
