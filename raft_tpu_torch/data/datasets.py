"""Dataset readers: FlyingChairs, FlyingThings3D, MPI-Sintel, KITTI, the
reference's bare image-pair list (reference dataflow/test_dataflow.py:101-131),
and ``make_training_dataset``.

The port's copy of the JAX package's ``data/datasets.py``, with the same
directory layouts, pairings and errors.  Each dataset scans its tree
once, then serves (im1, im2, flow, valid) samples through an optional
augmentor.  Frames decode through the port's own codec
(``raft_tpu_torch/imageio.py``: PNG in C++ on zlib, JPEG in C++ with
libjpeg-turbo's arithmetic, PPM in numpy; no OpenCV), as BGR uint8, as the JAX package's readers return them; flows
through ``utils/flow_io.py``.
"""

from __future__ import annotations

import os.path as osp
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..imageio import read_image
from ..utils.flow_io import read_flo, read_kitti_flow, read_pfm
from .augment import STAGE_SCALES, FlowAugmentor, PairAugmentor


class FlowDataset:
    """Base: index lists of (im1, im2, flow[, valid]) paths.  Serves
    (im1, im2, flow, valid): without an augmentor im1/im2 float32 in
    [0, 1], flow float32 [H, W, 2], valid float32 [H, W] (the sparse mask,
    else the pixels with both flow components below 1000); with one, what
    the augmentor returns.  A subclass may produce raw samples in
    ``_load`` instead of reading files (``synthetic.py``)."""

    def __init__(self, augmentor=None, sparse: bool = False):
        self.augmentor = augmentor
        self.sparse = sparse
        self.image_list: List[Tuple[str, str]] = []
        self.flow_list: List[str] = []

    def __len__(self) -> int:
        return len(self.image_list)

    @property
    def has_gt(self) -> bool:
        """False for ground-truth-less splits (KITTI 'testing'):
        ``__getitem__`` then serves zero flow with an all-zero valid mask,
        and the eval harness switches to prediction export."""
        return bool(self.flow_list)

    def _read_flow(self, idx) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        path = self.flow_list[idx]
        if self.sparse:
            flow, valid = read_kitti_flow(path)
            return flow, valid.astype(np.float32)
        if str(path).endswith(".pfm"):
            return read_pfm(path)[:, :, :2], None
        return read_flo(path), None

    def _load(self, idx) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]:
        """Raw (im1 uint8, im2 uint8, flow, valid-or-None)."""
        im1 = read_image(self.image_list[idx][0])
        im2 = read_image(self.image_list[idx][1])
        if not self.flow_list:   # gt-less split (KITTI testing): all-invalid
            h, w = im1.shape[:2]
            return (im1, im2, np.zeros((h, w, 2), np.float32),
                    np.zeros((h, w), np.float32))
        flow, valid = self._read_flow(idx)
        return im1, im2, flow, valid

    def __getitem__(self, idx):
        im1, im2, flow, valid = self._load(idx)
        if self.augmentor is not None:
            if valid is not None:
                if not getattr(self.augmentor, "accepts_valid", False):
                    raise ValueError("sparse ground truth needs a "
                                     "SparseFlowAugmentor (got dense "
                                     "FlowAugmentor)")
                im1, im2, flow, valid = self.augmentor(im1, im2, flow, valid)
            else:
                im1, im2, flow, valid = self.augmentor(im1, im2, flow)
        else:
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


class ShardedDataset:
    """Disjoint per-process view of a dataset: samples ``pid, pid + pcount,
    ...``, for a process that decodes only its own shard."""

    def __init__(self, ds, pid: int, pcount: int):
        if not 0 <= pid < pcount:
            raise ValueError(f"shard {pid} of {pcount} does not exist")
        if len(ds) <= pid:
            # an empty shard would make sample_iter spin forever yielding
            # nothing: fail instead
            raise ValueError(
                f"dataset of {len(ds)} samples cannot shard across "
                f"{pcount} processes: shard {pid} would be empty")
        self.ds, self.pid, self.pcount = ds, pid, pcount
        self.augmentor = getattr(ds, "augmentor", None)

    def __len__(self) -> int:
        return (len(self.ds) - self.pid + self.pcount - 1) // self.pcount

    def __getitem__(self, idx):
        return self.ds[idx * self.pcount + self.pid]

    sample_iter = FlowDataset.sample_iter


class MpiSintel(FlowDataset):
    """root/{training,test}/{clean,final}/<scene>/frame_XXXX.png +
    root/training/flow/<scene>/frame_XXXX.flo"""

    def __init__(self, root, split: str = "training", dstype: str = "clean",
                 augmentor=None):
        super().__init__(augmentor)
        self.dstype = dstype
        self.scene_list: List[str] = []   # per-pair scene, for warm-start
        self.pair_in_scene: List[int] = []  # 0-based pair index within scene
        image_root = osp.join(root, split, dstype)
        flow_root = osp.join(root, split, "flow")
        for scene in sorted(glob(osp.join(image_root, "*"))):
            frames = sorted(glob(osp.join(scene, "*.png")))
            for k, (a, b) in enumerate(zip(frames[:-1], frames[1:])):
                self.image_list.append((a, b))
                self.scene_list.append(osp.basename(scene))
                self.pair_in_scene.append(k)
            if split == "training":
                self.flow_list += sorted(glob(
                    osp.join(flow_root, osp.basename(scene), "*.flo")))
        if split == "training" and len(self.flow_list) != len(self.image_list):
            raise ValueError(f"{root}: {len(self.flow_list)} flows for "
                             f"{len(self.image_list)} Sintel pairs")

    def is_scene_start(self, idx) -> bool:
        """True when pair ``idx`` opens a new scene: the warm-start reset
        points of the official Sintel evaluation."""
        return idx == 0 or self.scene_list[idx] != self.scene_list[idx - 1]

    def dump_name(self, idx) -> str:
        """Relative prediction path for submission export,
        ``<dstype>/<scene>/frame%04d.png`` (the harness swaps the extension
        to .flo): the official create_sintel_submission naming,
        ``'frame%04d.flo' % (frame + 1)`` with no underscore, numbered by
        the 0-based pair index within the scene."""
        return osp.join(self.dstype, self.scene_list[idx],
                        "frame%04d.png" % (self.pair_in_scene[idx] + 1))


class FlyingChairs(FlowDataset):
    """root/data/xxxxx_img{1,2}.ppm + xxxxx_flow.flo; optional
    chairs_split.txt (1=train, 2=val)."""

    def __init__(self, root, split: str = "training", augmentor=None):
        super().__init__(augmentor)
        images = sorted(glob(osp.join(root, "data", "*.ppm")))
        flows = sorted(glob(osp.join(root, "data", "*.flo")))
        if len(images) // 2 != len(flows):
            raise ValueError(f"{root}: {len(images)} FlyingChairs images "
                             f"for {len(flows)} flows")
        split_file = osp.join(root, "chairs_split.txt")
        tags = (np.loadtxt(split_file, dtype=np.int32)
                if osp.exists(split_file) else np.ones(len(flows), np.int32))
        want = 1 if split == "training" else 2
        for i, flow in enumerate(flows):
            if tags[i] == want:
                self.image_list.append((images[2 * i], images[2 * i + 1]))
                self.flow_list.append(flow)


class FlyingThings3D(FlowDataset):
    """root/frames_cleanpass/TRAIN/*/*/{left,right} +
    root/optical_flow/TRAIN/*/*/into_{future,past}/{left,right}/*.pfm"""

    def __init__(self, root, dstype: str = "frames_cleanpass",
                 augmentor=None):
        super().__init__(augmentor)
        idirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
        fdirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
        for cam in ("left",):
            for direction in ("into_future", "into_past"):
                for idir, fdir in zip(idirs, fdirs):
                    images = sorted(glob(osp.join(idir, cam, "*.png")))
                    flows = sorted(glob(osp.join(fdir, direction, cam, "*.pfm")))
                    if direction == "into_future":
                        pairs = zip(images[:-1], images[1:], flows[:-1])
                    else:
                        pairs = zip(images[1:], images[:-1], flows[1:])
                    for a, b, f in pairs:
                        self.image_list.append((a, b))
                        self.flow_list.append(f)


class Kitti(FlowDataset):
    """root/{training,testing}/image_2 pairs + flow_occ 16-bit PNGs."""

    def __init__(self, root, split: str = "training", augmentor=None):
        super().__init__(augmentor, sparse=True)
        images1 = sorted(glob(osp.join(root, split, "image_2", "*_10.png")))
        images2 = sorted(glob(osp.join(root, split, "image_2", "*_11.png")))
        self.image_list = list(zip(images1, images2))
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, split, "flow_occ",
                                                  "*_10.png")))

    def dump_name(self, idx) -> str:
        """Prediction filename for submission export: the first frame's
        basename, the devkit's ``<frame>_10.png`` scheme."""
        return osp.basename(self.image_list[idx][0])


class PairList:
    """The reference's Testset: a plain list of image pairs, no flow
    (reference dataflow/test_dataflow.py:101-131)."""

    def __init__(self, filelist: Sequence[Tuple[str, str]],
                 input_size: Tuple[int, int],
                 augmentor: Optional[PairAugmentor] = None):
        self.filelist = list(filelist)
        self.processor = augmentor or PairAugmentor(input_size, test_mode=True)

    def __len__(self):
        return len(self.filelist)

    def __iter__(self):
        for a, b in self.filelist:
            yield self.processor(read_image(a), read_image(b))


def make_training_dataset(stage: str, root: Optional[str],
                          crop_size: Tuple[int, int],
                          device_aug: bool = False) -> FlowDataset:
    """The training dataset of a curriculum stage (chairs -> things ->
    sintel/kitti); ``'synthetic'`` needs no root (procedural samples at
    ``crop_size``).

    ``device_aug=True`` attaches no host augmentor: the caller wraps the
    dataset in ``augment_device.DecodeOnlyDataset`` and runs the same
    recipe on the device (``augment_device.make_device_augmentor`` shares
    :data:`~raft_tpu_torch.data.augment.STAGE_SCALES`)."""
    if stage == "synthetic":
        from .synthetic import SyntheticFlowDataset
        return SyntheticFlowDataset(size=crop_size)
    if root is None:
        raise ValueError(f"the {stage!r} stage reads files: pass its "
                         f"dataset root (--data)")
    if stage == "kitti":
        if device_aug:
            raise ValueError("device-side augmentation does not support "
                             "sparse ground truth (kitti) — its valid-aware "
                             "scatter resample is host-only; drop --device-aug")
        from .augment import SparseFlowAugmentor
        return Kitti(root, "training", augmentor=SparseFlowAugmentor(crop_size))
    if stage not in STAGE_SCALES:
        raise ValueError(stage)
    lo, hi = STAGE_SCALES[stage]
    aug = None if device_aug else FlowAugmentor(crop_size, min_scale=lo,
                                                max_scale=hi)
    if stage == "chairs":
        return FlyingChairs(root, "training", aug)
    if stage == "things":
        return FlyingThings3D(root, augmentor=aug)
    return MpiSintel(root, "training", "clean", aug)
