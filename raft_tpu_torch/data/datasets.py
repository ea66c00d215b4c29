"""Training datasets: the JAX package's ``FlowDataset`` base and
``make_training_dataset``.

Only the procedural ``'synthetic'`` stage is ported (``data/synthetic.py``,
no OpenCV): the file readers of FlyingChairs, FlyingThings3D, MPI-Sintel
and KITTI, the augmentors and the multi-process loader are ROADMAP item 8,
and asking for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_ITEM_8 = "ROADMAP item 8"


class FlowDataset:
    """Base: serves (im1, im2, flow, valid) samples, im1/im2 float32 in
    [0, 1], flow float32 [H, W, 2], valid float32 [H, W] (where the
    dataset gives none, pixels with both flow components below 1000).
    A subclass produces raw samples in ``_load``."""

    def __init__(self, augmentor=None):
        if augmentor is not None:
            raise NotImplementedError(f"the augmentors are not ported yet: "
                                      f"{_ITEM_8}")
        self.augmentor = None

    def __len__(self) -> int:
        raise NotImplementedError

    def _load(self, idx) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]:
        """Raw (im1 uint8, im2 uint8, flow, valid-or-None)."""
        raise NotImplementedError(f"the file-list dataset readers are not "
                                  f"ported yet: {_ITEM_8}")

    def __getitem__(self, idx):
        im1, im2, flow, valid = self._load(idx)
        im1 = im1.astype(np.float32) / 255.0
        im2 = im2.astype(np.float32) / 255.0
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return im1, im2, flow.astype(np.float32), valid

    def sample_iter(self, shuffle: bool = True, seed: int = 0,
                    epochs: Optional[int] = None):
        """Samples in a seeded shuffled order, epoch after epoch (forever
        when ``epochs`` is None)."""
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for i in order:
                yield self[int(i)]
            epoch += 1


def make_training_dataset(stage: str, root: Optional[str],
                          crop_size: Tuple[int, int]) -> FlowDataset:
    """The training dataset of a curriculum stage.  ``'synthetic'`` needs
    no root (procedural samples at ``crop_size``); every other stage
    reads files and raises until item 8 ports its reader."""
    if stage == "synthetic":
        from .synthetic import SyntheticFlowDataset
        return SyntheticFlowDataset(size=crop_size)
    raise NotImplementedError(f"the {stage!r} dataset reader and its "
                              f"augmentor are not ported yet: {_ITEM_8}")
