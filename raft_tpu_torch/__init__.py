"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for an NVIDIA H100.

It imports torch and numpy only (and scipy for the warm start) — never
jax, never raft_tpu.  It runs every entry point of the JAX package's model
module in eval mode for ``raft-things`` and ``raft-small``: pairwise and on
ragged mixed-resolution batches, counted and under the converge policy,
and the streaming steps (one encoder pass per frame, slot pools of float
or int8 rows); in float32 or under the bf16 compute policy, with the dense
correlation volume, the plain lookups or hand-written CUDA kernels for the
correlation lookups (``ops/corr_cuda.py``) and the SepConvGRU iteration
(``ops/gru_cuda.py``).  On CUDA the factories' functions replay captured
CUDA graphs (``models/capture.py``).

    model = init_raft_torch(RAFTConfig.full(), device="cuda")
    cfg = RAFTConfig.full(corr_impl="pallas", gru_impl="pallas")
    flow = make_inference_fn(cfg, iters=12)(model, image1, image2)  # [B, H, W, 2]
    # items of other sizes, each embed_to_shape'd into one max box:
    flow = make_ragged_inference_fn(cfg, iters=12)(model, im1, im2, sizes)
    # a video: one encoder pass per frame, the last step's maps cached
    step = make_stream_step_fn(cfg, iters=12)
    fmap, cnet = encode_frame(model, frame0, cfg)
    flow, flow_lr, fmap, cnet = step(model, frame1, fmap, cnet, flow_init)
"""

from .config import (RAFTConfig, adaptive_iters, check_port_support,
                     parse_iters_policy)
from .convert.weights import from_jax_params, load_params_npz
from .data.pipeline import embed_to_shape
from .models.raft import (RAFT, RAFTOutput, cast_encoder_weights,
                          dequantize_rows, encode_frame, forward_from_features,
                          init_raft_torch, make_counted_inference_fn,
                          make_encode_fn, make_inference_fn,
                          make_ragged_counted_inference_fn,
                          make_ragged_inference_fn,
                          make_ragged_stream_batch_step_fn,
                          make_ragged_stream_step_fn,
                          make_stream_batch_step_fn, make_stream_step_fn,
                          quantize_rows, raft_forward, resolve_device)
from .ops.warmstart import warm_start_seed

__all__ = ["RAFTConfig", "adaptive_iters", "check_port_support",
           "parse_iters_policy", "from_jax_params", "load_params_npz",
           "embed_to_shape", "RAFT", "RAFTOutput", "cast_encoder_weights",
           "dequantize_rows", "encode_frame", "forward_from_features",
           "init_raft_torch", "make_counted_inference_fn", "make_encode_fn",
           "make_inference_fn", "make_ragged_counted_inference_fn",
           "make_ragged_inference_fn", "make_ragged_stream_batch_step_fn",
           "make_ragged_stream_step_fn", "make_stream_batch_step_fn",
           "make_stream_step_fn", "quantize_rows", "raft_forward",
           "resolve_device", "warm_start_seed"]
