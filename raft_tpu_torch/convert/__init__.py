"""Checkpoint formats: the JAX package's parameter trees, the official
torch ``state_dict``, the reference's tensorpack npz and training
checkpoints, to and from the port's ``RAFT`` ``state_dict``."""

from .weights import (assert_tree_shapes_match, detect_format,  # noqa: F401
                      from_jax_params, from_reference_npz,
                      from_torch_state_dict, from_train_checkpoint,
                      load_checkpoint_auto, load_params_npz,
                      save_params_npz, swap_rgb_bgr, to_jax_params,
                      to_reference_npz, to_state_dict)
