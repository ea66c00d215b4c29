"""Flow-field file I/O: Middlebury .flo, PFM (FlyingThings3D), KITTI 16-bit
PNG, and flow resizing.  The port's copy of the JAX package's
``utils/flow_io.py``, without OpenCV: KITTI's PNGs go through the port's
codec (``raft_tpu_torch/imageio.py``) in 16 bits, with no depth
conversion, and :func:`resize_flow` resamples with
``data/synthetic.py::resize_linear`` (what ``cv2.resize`` computes with
``INTER_LINEAR`` on float32).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..imageio import decode_png, encode_png

_FLO_MAGIC = 202021.25  # 'PIEH' interpreted as float


def read_flo(path) -> np.ndarray:
    """Read a Middlebury .flo file -> [H, W, 2] float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, h * w * 2)
    if data.size != h * w * 2:
        raise ValueError(f"{path}: truncated .flo ({data.size} of "
                         f"{h * w * 2} values)")
    return data.reshape(h, w, 2)


def write_flo(flow: np.ndarray, path) -> None:
    """Write [H, W, 2] flow as .flo."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f".flo holds [H, W, 2] flow, got {flow.shape}")
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path) -> np.ndarray:
    """Read a PFM file (FlyingThings3D disparity/flow) -> float32 array,
    rows top-down."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    if data.size != int(np.prod(shape)):
        raise ValueError(f"{path}: truncated PFM")
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(arr: np.ndarray, path) -> None:
    """Write a PFM file (color 'PF' for [H, W, 3], grayscale 'Pf' for
    [H, W]); rows bottom-up, little-endian (scale header -1.0): the
    inverse of :func:`read_pfm`."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3 and arr.shape[2] == 3:
        header = b"PF"
    elif arr.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"PFM holds [H,W] or [H,W,3], got {arr.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")                     # negative = little-endian
        np.flipud(arr).astype("<f4").tofile(f)


def read_kitti_flow(path) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG flow -> ([H, W, 2] flow, [H, W] valid mask)."""
    raw = decode_png(Path(path).read_bytes(), anydepth=True, name=str(path))
    raw = raw[:, :, ::-1].astype(np.float32)   # BGR -> RGB = (u, v, valid)
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    valid = raw[:, :, 2] > 0.5
    return flow, valid


def write_kitti_flow(flow: np.ndarray, path,
                     valid: np.ndarray | None = None) -> None:
    """[H, W, 2] flow (and a [H, W] valid mask, else all valid) -> KITTI's
    16-bit PNG: (u * 64 + 2^15, v * 64 + 2^15, valid), clipped to 16 bits."""
    h, w = flow.shape[:2]
    out = np.ones((h, w, 3), np.uint16)
    if valid is not None:
        out[:, :, 2] = valid.astype(np.uint16)
    out[:, :, :2] = np.clip(flow * 64.0 + 2 ** 15, 0,
                            2 ** 16 - 1).astype(np.uint16)
    Path(path).write_bytes(encode_png(out[:, :, ::-1]))


def read_flow_any(path) -> np.ndarray:
    """Dispatch by extension (.flo / .pfm / .png)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".flo":
        return read_flo(path)
    if suffix == ".pfm":
        return read_pfm(path)[:, :, :2]
    if suffix == ".png":
        return read_kitti_flow(path)[0]
    raise ValueError(f"unknown flow format: {path}")


def resize_flow(flow: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Resize [H, W, 2] flow, rescaling u, v by the size ratio
    (reference flow_utils.py:277-284)."""
    from ..data.synthetic import resize_linear
    h, w = flow.shape[:2]
    out = resize_linear(np.ascontiguousarray(flow, np.float32),
                        (new_w, new_h))
    u = out[:, :, 0] * (new_w / float(w))
    v = out[:, :, 1] * (new_h / float(h))
    return np.dstack((u, v))
