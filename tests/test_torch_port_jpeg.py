"""The port's JPEG codec (``raft_tpu_torch/csrc/jpeg.cpp`` through
``raft_tpu_torch/imageio.py``) against OpenCV on the CPU.

* Decoding is bitwise ``cv2.imdecode(..., IMREAD_COLOR)`` on files cv2
  writes at every sampling factor, with restart intervals, progressive and
  optimised, in grey and at odd sizes; and on files Pillow writes:
  progressive, RGB (Adobe transform 0) and each EXIF orientation, in both
  byte orders.
* Encoding is byte for byte ``cv2.imencode(".jpg", ...)`` at every quality
  from 70 to 99 (95 is cv2's default), in colour and in grey.
* ``chip_smoke.py``'s phase 15 constants are cv2's digests of its seeded
  frame, and the port's codec gives them too.
* Arithmetic coding, 12-bit samples, lossless files and CMYK raise
  ValueError naming the feature; ``read_image`` equals the JAX package's
  ``_read_image`` on JPEG files.
"""

import hashlib
import io
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from raft_tpu.data import datasets as JD

from raft_tpu_torch import imageio

torch.set_num_threads(2)   # several test workers share the host's cores

SIZES = [(13, 21), (97, 131), (1, 1), (2, 3), (16, 16), (33, 65)]
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
OPTIONS = {
    "baseline": [],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "progressive-restart": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
}


def _frames(h, w, seed):
    """A noise frame and a smooth one (JPEG's two regimes), [h, w, 3]."""
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (h, w, 3), np.uint8)
    smooth = chip_smoke.host_texture_pair(h, w, seed=seed)[0]
    return noise, smooth


def _cv_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _same_decode(data: bytes, what):
    want = _cv_decode(data)
    got = imageio.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    assert np.array_equal(got, want), (what, int(np.abs(
        got.astype(int) - want).max()))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decoder_is_cv2_on_cv2_files(size, sampling):
    for img in _frames(*size, seed=size[0] * 7 + size[1]):
        for opt, extra in OPTIONS.items():
            ok, enc = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]] + extra)
            assert ok
            _same_decode(enc.tobytes(), (size, sampling, opt))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decoder_is_cv2_on_grey_files(size):
    for img in _frames(*size, seed=3):
        grey = np.ascontiguousarray(img[:, :, 1])
        for opt, extra in OPTIONS.items():
            ok, enc = cv2.imencode(".jpg", grey,
                                   [cv2.IMWRITE_JPEG_QUALITY, 80] + extra)
            _same_decode(enc.tobytes(), (size, "grey", opt))


def _pillow(img_bgr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1])).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


PILLOW = {
    "progressive": dict(progressive=True),
    "progressive-optimize": dict(progressive=True, optimize=True),
    "rgb": dict(keep_rgb=True),
    "rgb-progressive": dict(keep_rgb=True, progressive=True),
    "422": dict(subsampling=1),
    "444-q100": dict(subsampling=0, quality=100),
}


@pytest.mark.parametrize("size", [(13, 21), (97, 131), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(PILLOW))
def test_decoder_is_cv2_on_pillow_files(size, kind):
    for img in _frames(*size, seed=11):
        data = _pillow(img, **PILLOW[kind])
        if kind.startswith("rgb"):   # an Adobe APP14 with transform 0
            assert b"Adobe" in data
        _same_decode(data, (size, kind))


def _exif_big_endian(orientation: int) -> bytes:
    """A minimal big-endian ("MM") TIFF block holding one Orientation tag."""
    ifd = struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1,
                                             orientation, 0) + b"\0\0\0\0"
    return b"Exif\0\0" + b"MM\0\x2a" + struct.pack(">I", 8) + ifd


def _with_app1(jpeg: bytes, payload: bytes) -> bytes:
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpeg[2:])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_decoder_applies_exif_orientation_as_cv2(orientation):
    for h, w in ((16, 32), (13, 21)):
        img = _frames(h, w, seed=orientation)[1]
        exif = Image.Exif()
        exif[0x0112] = orientation
        little = _pillow(img, exif=exif.tobytes())
        big = _with_app1(_pillow(img), _exif_big_endian(orientation))
        for data in (little, big):
            _same_decode(data, (h, w, orientation))
            out = imageio.decode_image(data)
            assert out.shape[:2] == ((w, h) if orientation >= 5 else (h, w))


QUALITIES = list(range(70, 100))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_is_cv2_byte_for_byte(size):
    for img in _frames(*size, seed=size[1]):
        grey = np.ascontiguousarray(img[:, :, 0])
        for q in QUALITIES:
            for x in (img, grey):
                ok, want = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, q])
                assert imageio.encode_jpeg(x, q) == want.tobytes(), (size, q, x.ndim)
        for x in (img, grey):   # cv2's default quality is 95
            ok, want = cv2.imencode(".jpg", x)
            assert imageio.encode_jpeg(x) == want.tobytes()


def test_encoder_layout_is_baseline_420():
    img = _frames(40, 56, seed=2)[1]
    data = imageio.encode_jpeg(img, 85)
    markers, p = [], 2
    while data[p + 1] != 0xDA:
        markers.append((data[p + 1], struct.unpack(">H", data[p + 2:p + 4])[0]))
        p += 2 + markers[-1][1]
    assert [m for m, _ in markers] == [0xE0, 0xDB, 0xDB, 0xC0,
                                       0xC4, 0xC4, 0xC4, 0xC4]
    assert [n for m, n in markers if m == 0xC4] == [31, 181, 31, 181]
    sof = data.index(b"\xff\xc0")
    assert data[sof + 10:sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert data.endswith(b"\xff\xd9")


def test_write_and_read_image_jpeg(tmp_path):
    img = _frames(37, 50, seed=4)[1]
    for ext in (".jpg", ".jpeg", ".JPG"):
        path = tmp_path / f"f{ext}"
        imageio.write_image(path, img)
        assert path.read_bytes() == cv2.imencode(".jpg", img)[1].tobytes()
        np.testing.assert_array_equal(imageio.read_image(path),
                                      JD._read_image(str(path)))
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    (tmp_path / "p.jpg").write_bytes(enc.tobytes())
    np.testing.assert_array_equal(imageio.read_image(tmp_path / "p.jpg"),
                                  JD._read_image(str(tmp_path / "p.jpg")))


def test_chip_phase_constants_are_cv2s():
    """chip_smoke.py's phase 15 gates the card host's digests against
    these constants: they are cv2's, and the port's codec gives them."""
    texture = chip_smoke.host_texture_pair(*chip_smoke.HOST_HW, seed=0)[0]
    frame = chip_smoke.host_jpeg_frame(texture)
    assert frame.shape == chip_smoke.HOST_HW + (3,)
    for q in chip_smoke.JPEG_QUALITIES:
        ok, enc = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, q])
        enc = enc.tobytes()
        dec = _cv_decode(enc)
        want = (hashlib.sha256(enc).hexdigest(),
                hashlib.sha256(dec.tobytes()).hexdigest())
        assert want == chip_smoke.JPEG_SHA256[q], q
        mine = imageio.encode_jpeg(frame, q)
        assert mine == enc
        np.testing.assert_array_equal(imageio.decode_jpeg(mine), dec)


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (16, 8), (10, 200, 30, 40)).save(buf, "JPEG")
    return buf.getvalue()


def _patched_sof(marker: int, precision: int = 8) -> bytes:
    data = bytearray(cv2.imencode(".jpg", _frames(8, 8, seed=0)[1])[1].tobytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    data[sof + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("data,feature", [
    (_patched_sof(0xC9), "arithmetic"),
    (_patched_sof(0xCA), "arithmetic"),
    (_patched_sof(0xC3), "lossless"),
    (_patched_sof(0xC1, precision=12), "12-bit"),
    (_cmyk(), "CMYK"),
    (b"\xff\xd8\xff\xd9", "no scan"),
], ids=["sof9", "sof10", "sof3", "12bit", "cmyk", "empty"])
def test_unsupported_files_raise_naming_the_feature(data, feature, tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=feature) as e:
        imageio.read_image(path)
    assert "x.jpg" in str(e.value)
