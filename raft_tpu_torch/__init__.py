"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for an NVIDIA H100.

It imports torch and numpy only — never jax, never raft_tpu.  This slice
ports pairwise eval-mode inference of the full ``raft-things`` model, with
hand-written CUDA kernels for the correlation lookup
(``ops/corr_cuda.py``) and the SepConvGRU iteration (``ops/gru_cuda.py``).

    model = init_raft_torch(RAFTConfig.full(), device="cuda")
    infer = make_inference_fn(RAFTConfig.full(corr_impl="pallas", gru_impl="pallas"), iters=12)
    flow = infer(model, image1, image2)        # [B, H, W, 2]
"""

from .config import RAFTConfig, check_port_support, parse_iters_policy
from .convert.weights import from_jax_params, load_params_npz
from .models.raft import (RAFT, RAFTOutput, init_raft_torch,
                          make_inference_fn, raft_forward, resolve_device)

__all__ = ["RAFTConfig", "check_port_support", "parse_iters_policy",
           "from_jax_params", "load_params_npz", "RAFT", "RAFTOutput",
           "init_raft_torch", "make_inference_fn", "raft_forward",
           "resolve_device"]
