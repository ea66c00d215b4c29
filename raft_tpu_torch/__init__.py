"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for an NVIDIA H100.

It imports torch and numpy only — never jax, never raft_tpu.  It runs
eval-mode inference of ``raft-things`` and ``raft-small``, pairwise and on
ragged mixed-resolution batches, in float32 or under the bf16 compute
policy, with the dense correlation volume or hand-written CUDA kernels for
the correlation lookups (``ops/corr_cuda.py``) and the SepConvGRU
iteration (``ops/gru_cuda.py``).  On CUDA the inference functions replay
captured CUDA graphs (``models/capture.py``).

    model = init_raft_torch(RAFTConfig.full(), device="cuda")
    cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    flow = make_inference_fn(cfg, iters=12)(model, image1, image2)  # [B, H, W, 2]
    # items of other sizes, each embed_to_shape'd into one max box:
    flow = make_ragged_inference_fn(cfg, iters=12)(model, im1, im2, sizes)
"""

from .config import RAFTConfig, check_port_support, parse_iters_policy
from .convert.weights import from_jax_params, load_params_npz
from .data.pipeline import embed_to_shape
from .models.raft import (RAFT, RAFTOutput, init_raft_torch,
                          make_inference_fn, make_ragged_counted_inference_fn,
                          make_ragged_inference_fn, raft_forward,
                          resolve_device)

__all__ = ["RAFTConfig", "check_port_support", "parse_iters_policy",
           "from_jax_params", "load_params_npz", "embed_to_shape", "RAFT",
           "RAFTOutput", "init_raft_torch", "make_inference_fn",
           "make_ragged_inference_fn", "make_ragged_counted_inference_fn",
           "raft_forward", "resolve_device"]
