"""The parallel layer: data-parallel training and serving, and row-sharded
(sequence-parallel) inference with the ring correlation lookup, over
``torch.distributed`` (the JAX package's ``raft_tpu/parallel``)."""

from .data_parallel import (make_dp_eval_fn, make_dp_train_step,
                            make_pjit_train_step, replicate)
from .mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, make_mesh, shard_batch
from .spatial import (conv2d_row_sharded, gather_rows, halo_exchange,
                      make_ring_corr_lookup, make_ring_lookup_local,
                      make_shard_inference_fn, make_spatial_corr_lookup,
                      make_spatial_inference_fn, required_h_multiple,
                      shard_rows)

__all__ = ["make_dp_eval_fn", "make_dp_train_step", "make_pjit_train_step",
           "replicate", "DATA_AXIS", "SPATIAL_AXIS", "Mesh", "make_mesh",
           "shard_batch", "conv2d_row_sharded", "gather_rows",
           "halo_exchange", "make_ring_corr_lookup", "make_ring_lookup_local",
           "make_shard_inference_fn", "make_spatial_corr_lookup",
           "make_spatial_inference_fn", "required_h_multiple", "shard_rows"]
