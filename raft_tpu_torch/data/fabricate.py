"""Dataset trees in the release layouts, made from a seed: what the
readers of ``data/datasets.py`` scan, at any frame size, written with the
port's own writers (``imageio.py``, ``utils/flow_io.py``).

For tests, ``chip_smoke.py`` and benchmarks where no real dataset is at
hand.  Frames are uniform noise (uint8), flows Gaussian (a few pixels);
KITTI's ground truth is sparse (about 40% of the pixels valid).  Each
function returns the root it filled.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from ..imageio import write_image
from ..utils.flow_io import write_flo, write_kitti_flow, write_pfm


def _frame(rng, h: int, w: int) -> np.ndarray:
    return rng.randint(0, 256, (h, w, 3), np.uint8)


def _flow(rng, h: int, w: int, scale: float = 2.0) -> np.ndarray:
    return (rng.randn(h, w, 2) * scale).astype(np.float32)


def chairs_tree(root, n_pairs: int = 4, size: Tuple[int, int] = (384, 512),
                split: Sequence[int] = None, seed: int = 0) -> Path:
    """``root/data/NNNNN_img1.ppm``, ``_img2.ppm``, ``_flow.flo`` (and
    ``chairs_split.txt`` when ``split`` gives each pair's tag: 1 train,
    2 validation)."""
    root = Path(root)
    d = root / "data"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = size
    for i in range(1, n_pairs + 1):
        write_image(d / f"{i:05d}_img1.ppm", _frame(rng, h, w))
        write_image(d / f"{i:05d}_img2.ppm", _frame(rng, h, w))
        write_flo(_flow(rng, h, w), d / f"{i:05d}_flow.flo")
    if split is not None:
        (root / "chairs_split.txt").write_text(
            "".join(f"{int(t)}\n" for t in split))
    return root


def sintel_tree(root, split: str = "training", dstype: str = "clean",
                scenes: Sequence[str] = ("alley_1",), n_frames: int = 3,
                size: Tuple[int, int] = (436, 1024), seed: int = 0) -> Path:
    """``root/<split>/<dstype>/<scene>/frame_XXXX.png`` (1-based) and, for
    the training split, ``root/training/flow/<scene>/frame_XXXX.flo``."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    h, w = size
    for scene in scenes:
        d = root / split / dstype / scene
        d.mkdir(parents=True, exist_ok=True)
        for i in range(1, n_frames + 1):
            write_image(d / f"frame_{i:04d}.png", _frame(rng, h, w))
        if split == "training":
            f = root / split / "flow" / scene
            f.mkdir(parents=True, exist_ok=True)
            for i in range(1, n_frames):
                write_flo(_flow(rng, h, w), f / f"frame_{i:04d}.flo")
    return root


def things_tree(root, sequences: Sequence[Tuple[str, str]] = (("A", "0000"),),
                n_frames: int = 3, size: Tuple[int, int] = (540, 960),
                first: int = 6, seed: int = 0) -> Path:
    """FlyingThings3D's nesting: ``frames_cleanpass/TRAIN/<letter>/<seq>/
    {left,right}/NNNN.png`` and ``optical_flow/TRAIN/<letter>/<seq>/
    into_{future,past}/{left,right}/OpticalFlowInto{Future,Past}_NNNN_
    {L,R}.pfm`` (3-channel), frames numbered from ``first``."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    h, w = size
    for letter, seq in sequences:
        for cam, side in (("left", "L"), ("right", "R")):
            idir = root / "frames_cleanpass" / "TRAIN" / letter / seq / cam
            idir.mkdir(parents=True, exist_ok=True)
            for i in range(first, first + n_frames):
                write_image(idir / f"{i:04d}.png", _frame(rng, h, w))
            for direction, tag in (("into_future", "IntoFuture"),
                                   ("into_past", "IntoPast")):
                fdir = (root / "optical_flow" / "TRAIN" / letter / seq
                        / direction / cam)
                fdir.mkdir(parents=True, exist_ok=True)
                for i in range(first, first + n_frames):
                    fl = np.zeros((h, w, 3), np.float32)
                    fl[..., :2] = _flow(rng, h, w)
                    write_pfm(fl, fdir / f"OpticalFlow{tag}_{i:04d}_{side}.pfm")
    return root


def kitti_tree(root, sizes: Sequence[Tuple[int, int]] = ((375, 1242),),
               split: str = "training", seed: int = 0) -> Path:
    """``root/<split>/image_2/NNNNNN_1{0,1}.png``, one pair per entry of
    ``sizes`` and, for the training split, ``root/training/flow_occ/
    NNNNNN_10.png`` (16-bit flow PNGs, about 40% of the pixels valid)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    img = root / split / "image_2"
    img.mkdir(parents=True, exist_ok=True)
    if split == "training":
        (root / split / "flow_occ").mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        write_image(img / f"{i:06d}_10.png", _frame(rng, h, w))
        write_image(img / f"{i:06d}_11.png", _frame(rng, h, w))
        if split == "training":
            valid = rng.rand(h, w) < 0.4
            write_kitti_flow(_flow(rng, h, w, 4.0),
                             root / split / "flow_occ" / f"{i:06d}_10.png",
                             valid)
    return root
