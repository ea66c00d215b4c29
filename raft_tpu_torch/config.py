"""Model and training configuration of the PyTorch/CUDA port.

The port keeps its own copies of the JAX package's ``RAFTConfig`` and
``TrainConfig`` (same knob names, same defaults, same validation, the same
``TrainConfig.for_stage`` curriculum presets), so one configuration value
means the same thing in both packages.  The training knobs of
``RAFTConfig`` act as in JAX: ``dropout`` (channel dropout on the encoders'
outputs) and ``remat_iters`` (each iteration recomputed in the backward)
change the training forward only; ``scan_unroll`` is validated and changes
nothing (the port's loop is a Python loop).

:func:`check_port_support` validates a configuration as the JAX package
does; every value of every field runs in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def parse_iters_policy(spec: str):
    """Parse an iteration policy spec into ``(kind, eps, min_iters)``.

    ``"fixed"``                    -> ``("fixed", None, None)``
    ``"converge:EPS"``             -> ``("converge", EPS, 1)``
    ``"converge:EPS:MIN_ITERS"``   -> ``("converge", EPS, MIN_ITERS)``

    A malformed spec raises ValueError.
    """
    if spec == "fixed":
        return ("fixed", None, None)
    parts = spec.split(":")
    if parts[0] != "converge" or len(parts) not in (2, 3):
        raise ValueError(
            f"iters_policy must be 'fixed' or 'converge:eps[:min_iters]', "
            f"got {spec!r}")
    try:
        eps = float(parts[1])
    except ValueError:
        raise ValueError(f"iters_policy {spec!r}: eps {parts[1]!r} is not "
                         f"a number")
    if not eps >= 0.0:          # also rejects NaN
        raise ValueError(f"iters_policy {spec!r}: eps must be >= 0")
    min_iters = 1
    if len(parts) == 3:
        try:
            min_iters = int(parts[2])
        except ValueError:
            raise ValueError(f"iters_policy {spec!r}: min_iters "
                             f"{parts[2]!r} is not an integer")
        if min_iters < 1:
            raise ValueError(f"iters_policy {spec!r}: min_iters must "
                             f"be >= 1")
    return ("converge", eps, min_iters)


def adaptive_iters(spec: str) -> bool:
    """True when ``spec`` enables the per-sample early exit (validates as a
    side effect)."""
    return parse_iters_policy(spec)[0] == "converge"


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Static hyperparameters of the RAFT model (the JAX package's fields).

    ``corr_impl='pallas'`` / ``gru_impl='pallas'`` select this port's CUDA
    kernels (the names stay those of the JAX configuration they replace);
    ``corr_impl='blockwise', corr_lookup='onehot'`` and ``gru_impl='xla'``
    select their plain PyTorch versions; ``corr_impl='dense'`` (the
    default) materialises the correlation volume of every level (one
    matrix product each, as JAX leaves it to XLA) and samples it with
    ``corr_lookup`` ('onehot' or 'gather').  ``small=True`` is raft-small
    (``small_model()``): its 3x3 ConvGRU is stock PyTorch, as in JAX, so
    it takes ``gru_impl='xla'`` only.  The TPU tiling knobs
    ``pallas_q_blk``, ``pallas_p_blk``, ``pallas_lookup_style`` and
    ``gru_block_rows`` are accepted and validated as in JAX but change no
    value: the CUDA kernels have their own fixed tiling.
    ``pallas_pack=True`` runs the lookup through its own entry (the packed
    entry of ``csrc/corr_lookup.cu``: the first lookup's kernel, the narrow
    pyramid levels ``W_l <= 64`` that the TPU packs row by row on the same
    tile as the others); the values are those of the unpacked lookup.

    ``compute_dtype='bfloat16'`` is the JAX package's bf16 policy: the
    weights (batch-norm statistics included) and the activations of the
    encoders and the update block are bfloat16 — the model is cast once,
    by :func:`~raft_tpu_torch.models.raft.init_raft_torch` or by the
    caller's ``model.to(torch.bfloat16)``, not per request — while the
    correlation is computed from float32 feature maps, the GRU computes in
    float32 with bfloat16 I/O, coordinates stay float32 and the upsampling
    runs in float32.

    ``iters_policy='converge:eps[:min_iters]'`` freezes a sample once the
    mean L2 norm of its flow update drops below ``eps`` (from iteration
    ``min_iters`` on) and ends the loop when every sample has frozen;
    ``quant`` selects the streaming storage formats: ``'int8'`` slot rows
    (``quant_slots``), ``'bf16w'`` bfloat16 encoder weights computed in the
    compute dtype (``quant_weights``; ``models/raft.py::
    cast_encoder_weights``).  ``gru_ctx_hoist=False`` runs the plain GRU
    on ``[h, context, motion]`` each iteration instead of hoisting the
    context terms (``gru_impl='pallas'`` hoists whatever it says, as in
    JAX).  Under ``compute_dtype='float32'`` the inference
    functions (``make_inference_fn`` and the ragged ones) turn TF32 off
    for cuDNN's convolutions and cuBLAS's matmuls for the duration of each
    call and restore the caller's settings after it, since PyTorch's
    default lets cuDNN run float32 convolutions in TF32 while the JAX
    package computes them in float32; there is no knob for TF32 (the JAX
    configuration has none for its convolutions).

    ``corr_precision='default'`` means what one default-precision pass of
    the TPU's matrix unit does with the lookup's float32 operands: the dot
    products take fmap1 and each fmap2 pyramid level rounded to bfloat16
    (the pyramid pooled in float32 first, each level rounded after) and
    accumulate in float32.  The port stores those operands as bfloat16,
    which halves the lookup's feature bytes.  ``'highest'`` keeps them
    float32.  (On the JAX package's CPU backend 'default' computes in
    float32, so there the two values agree.)
    """

    small: bool = False
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 32
    dropout: float = 0.0
    corr_impl: str = "dense"
    corr_lookup: str = "onehot"
    corr_precision: str = "highest"
    pallas_q_blk: int = 128
    pallas_p_blk: int = 4096
    pallas_lookup_style: str = "matmul"
    pallas_p_select: str = "all"
    pallas_pack: bool = False
    compute_dtype: str = "float32"
    iters_policy: str = "fixed"
    remat_iters: bool = True
    scan_unroll: int = 1
    gru_ctx_hoist: bool = True
    gru_impl: str = "xla"
    gru_block_rows: int = 8
    quant: str = "none"

    def __post_init__(self):
        allowed = ("none", "int8", "bf16w", "int8+bf16w")
        if self.quant not in allowed:
            raise ValueError(f"quant must be one of {allowed}, "
                             f"got {self.quant!r}")

    @property
    def quant_slots(self) -> bool:
        """True when a slot pool stores int8 fmap/cnet rows."""
        return "int8" in self.quant

    @property
    def quant_weights(self) -> bool:
        """True when the fnet/cnet encoder weights are stored bfloat16."""
        return "bf16w" in self.quant

    @property
    def fnet_dim(self) -> int:
        return 128 if self.small else 256

    @property
    def cnet_dim(self) -> int:
        return self.hidden_dim + self.context_dim

    @property
    def corr_feature_dim(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @staticmethod
    def full(**overrides) -> "RAFTConfig":
        """raft-things variant."""
        return RAFTConfig(**{**dict(small=False), **overrides})

    @staticmethod
    def small_model(**overrides) -> "RAFTConfig":
        """raft-small variant."""
        defaults = dict(small=True, hidden_dim=96, context_dim=64,
                        corr_radius=3, iters=12)
        return RAFTConfig(**{**defaults, **overrides})


def check_port_support(config: RAFTConfig) -> None:
    """Validate ``config`` as the JAX package does: a ValueError for a
    malformed knob value.  Every configuration value the JAX package's
    inference accepts runs in the port."""
    parse_iters_policy(config.iters_policy)
    if config.gru_impl not in ("xla", "pallas"):
        raise ValueError(f"gru_impl must be 'xla' or 'pallas', "
                         f"got {config.gru_impl!r}")
    if config.gru_impl == "pallas" and config.small:
        raise ValueError(
            "gru_impl='pallas' covers the full model's SepConvGRU; the "
            "small variant's 3x3 ConvGRU has no hand kernel — use "
            "gru_impl='xla'.")
    if config.corr_impl not in ("dense", "blockwise", "pallas"):
        raise ValueError(config.corr_impl)
    if config.corr_lookup not in ("gather", "onehot"):
        raise ValueError(f"corr_lookup must be 'gather' or 'onehot', "
                         f"got {config.corr_lookup!r}")
    if config.corr_precision not in ("highest", "default"):
        raise ValueError(f"corr_precision must be 'highest' or 'default', "
                         f"got {config.corr_precision!r}")
    if config.scan_unroll < 1:
        raise ValueError(f"scan_unroll must be >= 1, got {config.scan_unroll}")
    if config.pallas_lookup_style not in ("matmul", "vpu"):
        raise ValueError(f"lookup_style must be 'matmul' or 'vpu', "
                         f"got {config.pallas_lookup_style!r}")
    if config.pallas_p_select not in ("all", "window"):
        raise ValueError(f"p_select must be 'all' or 'window', "
                         f"got {config.pallas_p_select!r}")
    if config.gru_block_rows < 4:
        raise ValueError(f"block_rows must be >= 4 (the pass-1 recompute "
                         f"halo), got {config.gru_block_rows}")
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {config.compute_dtype!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training recipe: the JAX package's ``TrainConfig``, field for
    field (``optimizer``: adam | adamw | sgd | sgd_cyclic | sgd_1cycle;
    ``schedule``: one_cycle | constant | cyclic; ``loss_normalization``:
    'total' | 'valid'; see ``training/``)."""

    num_steps: int = 100_000
    batch_size: int = 6
    accum_steps: int = 1
    image_size: Tuple[int, int] = (368, 496)
    lr: float = 4e-4
    weight_decay: float = 1e-5
    adamw_eps: float = 1e-8
    clip_norm: float = 1.0
    gamma: float = 0.8
    loss_normalization: str = "total"
    optimizer: str = "adamw"
    schedule: str = "one_cycle"
    pct_start: float = 0.05
    max_flow: float = 400.0
    freeze_bn: bool = False
    skip_nonfinite_updates: bool = True
    halt_on_nonfinite: bool = True
    seed: int = 0
    log_every: int = 100
    ckpt_every: int = 5000
    ckpt_dir: str = "checkpoints"
    keep_checkpoints: Optional[int] = None
    async_checkpointing: bool = True
    max_rollbacks: int = 3

    @staticmethod
    def for_stage(stage: str, **overrides) -> "TrainConfig":
        """The official RAFT curriculum presets (chairs -> things ->
        sintel/kitti) and the synthetic smoke stage, as in the JAX
        package; explicit overrides win."""
        presets = {
            "chairs":    dict(num_steps=100_000, lr=4e-4, batch_size=10,
                              image_size=(368, 496), weight_decay=1e-4),
            "things":    dict(num_steps=100_000, lr=1.25e-4, batch_size=6,
                              image_size=(400, 720), weight_decay=1e-4,
                              freeze_bn=True),
            "sintel":    dict(num_steps=100_000, lr=1.25e-4, batch_size=6,
                              image_size=(368, 768), weight_decay=1e-5,
                              gamma=0.85, freeze_bn=True),
            "kitti":     dict(num_steps=50_000, lr=1e-4, batch_size=6,
                              image_size=(288, 960), weight_decay=1e-5,
                              gamma=0.85, freeze_bn=True),
            "synthetic": dict(image_size=(96, 128), batch_size=4,
                              log_every=10, ckpt_every=100),
        }
        if stage not in presets:
            raise ValueError(f"unknown stage {stage!r}; "
                             f"options: {sorted(presets)}")
        return TrainConfig(**{**presets[stage], **overrides})
