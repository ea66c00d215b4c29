"""Building ragged mixed-resolution batches on the host (numpy).

The port's copy of ``embed_to_shape`` from the JAX package's
``data/pipeline.py``: callers corner-anchor each frame of a ragged batch
into the shared max box with it, stack the frames and pass the live sizes
to :func:`raft_tpu_torch.make_ragged_inference_fn`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def embed_to_shape(arr: np.ndarray,
                   target_hw: Tuple[int, int]) -> np.ndarray:
    """Corner-anchor [..., H, W, C] into an exact (H, W) max box by
    ZERO-padding bottom/right only — the ragged-batch embed.  The content is
    neither centred nor replicated: the ragged model path needs the live
    crop at (0, 0) (it re-masks the dead region itself, so the zeros are a
    contract, not a numerics requirement).  Invert by slicing
    ``out[..., :h, :w, :]``.  Raises when the image exceeds the target."""
    h, w = arr.shape[-3], arr.shape[-2]
    th, tw = target_hw
    if h > th or w > tw:
        raise ValueError(f"image ({h}, {w}) exceeds embed target ({th}, {tw})")
    width = [(0, 0)] * (arr.ndim - 3) + [(0, th - h), (0, tw - w), (0, 0)]
    return np.pad(arr, width)
