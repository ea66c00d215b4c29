"""Padding and embedding frames on the host (numpy).

The port's copies of ``pad_to_shape``, ``embed_to_shape`` and ``unpad``
from the JAX package's ``data/pipeline.py``.  The serving stack pads each
request to its resolution bucket with :func:`pad_to_shape` (replicate
padding, split between both sides), and under ragged serving embeds the
padded frame corner-anchored into the shared max box with
:func:`embed_to_shape`; :func:`unpad` recovers the request's own
resolution from the flow.  Callers of ``make_ragged_inference_fn`` build
their batches with :func:`embed_to_shape` too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _apply_pads(image: np.ndarray, ph: int, pw: int,
                mode: str) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    if mode == "sintel":
        pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    else:
        pads = (ph, 0, 0, pw)
    t, b, l, r = pads
    width = [(0, 0)] * (image.ndim - 3) + [(t, b), (l, r), (0, 0)]
    return np.pad(image, width, mode="edge"), pads


def pad_to_shape(image: np.ndarray, target_hw: Tuple[int, int],
                 mode: str = "sintel"
                 ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Replicate-pad [..., H, W, C] up to an exact (H, W): mode 'sintel'
    splits the padding between both sides, 'kitti' pads top/right only.
    Returns (padded, (top, bottom, left, right)), which :func:`unpad`
    inverts.  Raises when the image exceeds the target."""
    h, w = image.shape[-3], image.shape[-2]
    th, tw = target_hw
    if h > th or w > tw:
        raise ValueError(f"image ({h}, {w}) exceeds pad target ({th}, {tw})")
    return _apply_pads(image, th - h, tw - w, mode)


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


def unpad(arr: np.ndarray, pads: Tuple[int, int, int, int]) -> np.ndarray:
    """Crop [..., H, W, C] by ``pads`` = (top, bottom, left, right), the
    inverse of :func:`pad_to_shape`."""
    t, b, l, r = pads
    h, w = arr.shape[-3], arr.shape[-2]
    return arr[..., t:h - b if b else h, l:w - r if r else w, :]
