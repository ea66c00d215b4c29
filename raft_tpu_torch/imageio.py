"""Image files without OpenCV: PNG through the port's own codec
(``csrc/imageio.cpp``, zlib and the PNG specification, bound with ctypes),
JPEG through another (``csrc/jpeg.cpp``, the JPEG specification and
libjpeg-turbo's default arithmetic, no libjpeg), PPM/PGM in numpy.

Frames come back as the JAX package's readers return them, which is what
``cv2.imdecode(..., IMREAD_COLOR)`` gives: [H, W, 3] uint8 in BGR order
(gray replicated, a palette expanded, alpha dropped, a 16-bit sample's high
byte).  :func:`decode_png` with ``anydepth=True`` keeps 16 bits, as
``IMREAD_ANYDEPTH | IMREAD_COLOR`` does (KITTI's flow PNGs).  The writers
take BGR, as ``cv2.imwrite`` does.

A JPEG decodes bitwise as ``cv2.imdecode(..., IMREAD_COLOR)`` decodes it
(baseline, extended and progressive Huffman files, 8-bit, gray or 3
components, any integral sampling, the EXIF orientation applied), and
:func:`encode_jpeg` writes the bytes of ``cv2.imencode(".jpg", ...)`` at
the same quality.  Arithmetic coding, 12-bit samples, lossless files and
CMYK/YCCK raise ValueError naming the feature.  A corrupt or unknown file
raises ValueError naming its path; nothing falls back.

The codecs' libraries are built by ``_build.py`` with the host C++
compiler at their first use (no ``nvcc``, no GPU), so this module works
on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
_ERRLEN = 256
JPEG_QUALITY = 95          # cv2.imwrite's default

_lib: Optional[ctypes.CDLL] = None
_jpeg_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _codec() -> ctypes.CDLL:
    """The codec's library, built and loaded at the first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from . import _build
            lib = _build.load("imageio.cpp")
            u8p, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
            lib.rt_png_header.argtypes = [u8p, ctypes.c_size_t, i32p,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.rt_png_header.restype = ctypes.c_int
            lib.rt_png_decode.argtypes = [u8p, ctypes.c_size_t,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.rt_png_decode.restype = ctypes.c_int
            lib.rt_png_encode_bound.argtypes = [ctypes.c_int32] * 4
            lib.rt_png_encode_bound.restype = ctypes.c_size_t
            lib.rt_png_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
            lib.rt_png_encode.restype = ctypes.c_int64
            _lib = lib
        return _lib


def _jpeg_codec() -> ctypes.CDLL:
    """The JPEG codec's library, built and loaded at the first call."""
    global _jpeg_lib
    with _lib_lock:
        if _jpeg_lib is None:
            from . import _build
            lib = _build.load("jpeg.cpp")
            u8p, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
            lib.rt_jpeg_header.argtypes = [u8p, ctypes.c_size_t, i32p,
                                           ctypes.c_char_p, ctypes.c_int]
            lib.rt_jpeg_header.restype = ctypes.c_int
            lib.rt_jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                           ctypes.c_char_p, ctypes.c_int]
            lib.rt_jpeg_decode.restype = ctypes.c_int
            lib.rt_jpeg_encode_bound.argtypes = [ctypes.c_int32] * 2
            lib.rt_jpeg_encode_bound.restype = ctypes.c_size_t
            lib.rt_jpeg_encode.argtypes = [
                u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, u8p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int]
            lib.rt_jpeg_encode.restype = ctypes.c_int64
            _jpeg_lib = lib
        return _jpeg_lib


def _err(buf) -> str:
    return buf.value.decode(errors="replace")


def decode_png(data: bytes, anydepth: bool = False,
               name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W, 3] BGR: uint8 (a 16-bit file's high byte), or
    with ``anydepth`` the file's own depth (uint8 or uint16).  Raises
    ValueError naming ``name`` for a corrupt or unsupported file."""
    lib = _codec()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    hwdc = (ctypes.c_int32 * 4)()
    if lib.rt_png_header(buf.ctypes.data, buf.size, hwdc, err, _ERRLEN):
        raise ValueError(f"{name}: {_err(err)}")
    h, w, depth = hwdc[0], hwdc[1], hwdc[2]
    out16 = anydepth and depth == 16
    out = np.empty((h, w, 3), np.uint16 if out16 else np.uint8)
    if lib.rt_png_decode(buf.ctypes.data, buf.size, out.ctypes.data,
                         int(out16), err, _ERRLEN):
        raise ValueError(f"{name}: {_err(err)}")
    return out


def encode_png(image: np.ndarray) -> bytes:
    """[H, W] gray or [H, W, 3] BGR, uint8 or uint16 -> PNG bytes (one
    IDAT, zlib's fastest level, as OpenCV's default)."""
    img = np.ascontiguousarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG encode takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        channels = 1
    elif img.ndim == 3 and img.shape[2] in (1, 3):
        channels = img.shape[2]
    else:
        raise ValueError(f"PNG encode takes [H, W] or [H, W, 3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    lib = _codec()
    cap = lib.rt_png_encode_bound(h, w, channels, depth)
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.rt_png_encode(img.ctypes.data, h, w, channels, depth,
                          out.ctypes.data, cap, err, _ERRLEN)
    if n < 0:
        raise ValueError(_err(err))
    return out[:n].tobytes()


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 BGR, bitwise what
    ``cv2.imdecode(..., IMREAD_COLOR)`` returns (gray replicated, the EXIF
    orientation applied).  Raises ValueError naming ``name`` for a corrupt
    file or an unsupported feature (arithmetic coding, 12-bit, lossless,
    CMYK)."""
    lib = _jpeg_codec()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    hw = (ctypes.c_int32 * 2)()
    if lib.rt_jpeg_header(buf.ctypes.data, buf.size, hw, err, _ERRLEN):
        raise ValueError(f"{name}: {_err(err)}")
    out = np.empty((hw[0], hw[1], 3), np.uint8)
    if lib.rt_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, err,
                          _ERRLEN):
        raise ValueError(f"{name}: {_err(err)}")
    return out


def encode_jpeg(image: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """[H, W] gray or [H, W, 3] BGR uint8 -> the bytes of
    ``cv2.imencode(".jpg", image, [IMWRITE_JPEG_QUALITY, quality])``
    (baseline, 4:2:0 for colour, the standard Huffman tables)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG encode takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[:, :, 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG encode takes [H, W] or [H, W, 3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    lib = _jpeg_codec()
    cap = lib.rt_jpeg_encode_bound(h, w)
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.rt_jpeg_encode(img.ctypes.data, h, w, channels, int(quality),
                           out.ctypes.data, cap, err, _ERRLEN)
    if n < 0:
        raise ValueError(_err(err))
    return out[:n].tobytes()


def _ppm_tokens(data: bytes, count: int):
    """The first ``count`` header tokens of a netpbm file (comments
    skipped) and the offset of the raster after the one whitespace byte
    that ends the header."""
    tokens, pos = [], 0
    while len(tokens) < count:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated netpbm header")
        tokens.append(data[start:pos])
    return tokens, pos + 1


def decode_ppm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Binary PPM (P6) or PGM (P5), maxval up to 255 -> [H, W, 3] uint8
    BGR (gray replicated)."""
    try:
        (magic, w, h, maxval), off = _ppm_tokens(data, 4)
        w, h, maxval = int(w), int(h), int(maxval)
    except ValueError as e:
        raise ValueError(f"{name}: malformed netpbm header ({e})") from None
    if magic not in (b"P6", b"P5") or not 0 < maxval < 256:
        raise ValueError(f"{name}: only 8-bit binary P6/P5 is supported "
                         f"(got {magic!r}, maxval {maxval})")
    c = 3 if magic == b"P6" else 1
    raster = np.frombuffer(data, np.uint8, count=-1, offset=off)
    if raster.size < h * w * c:
        raise ValueError(f"{name}: truncated netpbm raster")
    img = raster[:h * w * c].reshape(h, w, c)
    return (img[:, :, ::-1] if c == 3 else np.repeat(img, 3, axis=2)).copy()


def encode_ppm(image: np.ndarray) -> bytes:
    """[H, W, 3] uint8 BGR -> binary PPM (P6) bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PPM encode takes [H, W, 3] uint8, got "
                         f"{img.dtype}{list(img.shape)}")
    h, w = img.shape[:2]
    return (f"P6\n{w} {h}\n255\n".encode()
            + np.ascontiguousarray(img[:, :, ::-1]).tobytes())


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> [H, W, 3] uint8 BGR, by the file's magic: PNG, JPEG,
    PPM or PGM; anything else raises ValueError."""
    if data.startswith(_PNG_MAGIC):
        return decode_png(data, name=name)
    if data[:2] in (b"P6", b"P5"):
        return decode_ppm(data, name=name)
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data, name=name)
    raise ValueError(f"{name}: not a PNG, JPEG, PPM or PGM file")


def read_image(path) -> np.ndarray:
    """The image file at ``path`` as [H, W, 3] uint8 BGR
    (:func:`decode_image`)."""
    return decode_image(Path(path).read_bytes(), name=str(path))


def write_image(path, image: np.ndarray) -> None:
    """Write ``image`` (BGR) by ``path``'s extension: ``.png`` (uint8 or
    uint16, gray or 3 channels), ``.jpg``/``.jpeg`` (uint8, gray or 3
    channels, at cv2.imwrite's default quality of 95) or ``.ppm`` (uint8,
    3 channels)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        data = encode_png(image)
    elif suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(image)
    elif suffix == ".ppm":
        data = encode_ppm(image)
    else:
        raise ValueError(f"{path}: only .png, .jpg, .jpeg and .ppm are "
                         f"written")
    Path(path).write_bytes(data)
