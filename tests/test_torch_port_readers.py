"""The port's readers against the JAX package's, on the same fabricated
trees: the image codec (``raft_tpu_torch/imageio.py``, PNG in C++ on zlib,
JPEG in C++, PPM in numpy) against OpenCV, the flow formats, and the datasets of
FlyingChairs, MPI-Sintel, FlyingThings3D and KITTI, whose arrays must be
bitwise equal to the JAX readers' (8- and 16-bit PNG, PPM, .flo, .pfm,
KITTI's 16-bit flow PNGs), with the same pairing, ``scene_list``,
``is_scene_start`` and ``dump_name``.  Trees are written with seeded numpy
by the port's own writers (``data/fabricate.py``) and, for the codec,
also by OpenCV.  Also the host tools of ``utils/`` against the JAX
package's (``aug_img`` within one level of 255: OpenCV's uint8 blur runs
in fixed point; ``calc_flow``'s DIS part bitwise)."""

import cv2
import numpy as np
import pytest
import torch

from raft_tpu.data import datasets as JD
from raft_tpu.utils import flow_io as JIO
from raft_tpu.utils import flow_viz as JVIZ
from raft_tpu.utils import frame_utils as JFU

from raft_tpu_torch import imageio
from raft_tpu_torch.data import datasets as PD
from raft_tpu_torch.data import fabricate
from raft_tpu_torch.utils import flow_io as PIO
from raft_tpu_torch.utils import flow_viz as PVIZ
from raft_tpu_torch.utils import frame_utils as PFU

torch.set_num_threads(2)   # several test workers share the host's cores


def _same_samples(pds, jds, indices=None):
    assert len(pds) == len(jds) > 0
    for i in (range(len(jds)) if indices is None else indices):
        for a, b in zip(pds[i], jds[i]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- codec

@pytest.mark.parametrize("kind", ["rgb8", "gray8", "rgba8", "rgb16",
                                  "gray16", "smooth8"])
def test_png_decode_equals_opencv(kind):
    rng = np.random.RandomState(1)
    h, w = 29, 43
    if kind == "smooth8":       # long runs: libpng picks every filter type
        ys, xs = np.mgrid[0:h, 0:w]
        img = np.stack([xs * 5 % 256, ys * 3 % 256, (xs + ys) % 256],
                       -1).astype(np.uint8)
    else:
        dt = np.uint16 if kind.endswith("16") else np.uint8
        c = {"rgb": 3, "gray": 1, "rgba": 4}[kind[:-2] if kind[-2:] == "16"
                                           else kind[:-1]]
        img = rng.randint(0, np.iinfo(dt).max + 1, (h, w, c)).astype(dt)
        if c == 1:
            img = img[..., 0]
    ok, enc = cv2.imencode(".png", img)
    assert ok
    data = bytes(enc)
    np.testing.assert_array_equal(imageio.decode_png(data),
                                  cv2.imdecode(enc, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(
        imageio.decode_png(data, anydepth=True),
        cv2.imdecode(enc, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR))


def test_png_encode_is_read_back_by_opencv():
    rng = np.random.RandomState(2)
    for img in (rng.randint(0, 256, (17, 31, 3)).astype(np.uint8),
                rng.randint(0, 65536, (17, 31, 3)).astype(np.uint16),
                rng.randint(0, 256, (17, 31)).astype(np.uint8)):
        got = cv2.imdecode(np.frombuffer(imageio.encode_png(img), np.uint8),
                           cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, img)


def test_kitti_flow_round_trip_against_opencv(tmp_path):
    """write_kitti_flow -> read_kitti_flow, each package's writer read by
    the other's reader, bitwise."""
    rng = np.random.RandomState(3)
    flow = (rng.randn(37, 90, 2) * 30).astype(np.float32)
    flow[0, :4] = [[600, -600], [-513, 512.02], [0.01, -0.01], [1e4, -1e4]]
    valid = rng.rand(37, 90) > 0.4
    PIO.write_kitti_flow(flow, tmp_path / "p.png", valid)
    JIO.write_kitti_flow(flow, tmp_path / "j.png", valid)
    for name in ("p.png", "j.png"):
        pf, pv = PIO.read_kitti_flow(tmp_path / name)
        jf, jv = JIO.read_kitti_flow(tmp_path / name)
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    got, ok = PIO.read_kitti_flow(tmp_path / "p.png")
    assert np.abs(got - np.clip(flow, -512, 511.99))[valid].max() <= 1 / 64


@pytest.mark.parametrize("damage", ["crc", "truncated", "zlib", "magic"])
def test_a_corrupt_png_raises_naming_the_file(tmp_path, damage):
    data = bytearray(imageio.encode_png(
        np.random.RandomState(4).randint(0, 256, (20, 30, 3), np.uint8)))
    if damage == "crc":
        data[60] ^= 0xFF                      # inside IDAT: its CRC fails
    elif damage == "truncated":
        data = data[:len(data) // 2]
    elif damage == "zlib":                    # a valid CRC over bad data
        import zlib
        start = data.index(b"IDAT")
        n = int.from_bytes(data[start - 4:start], "big")
        data[start + 4:start + 4 + n] = b"\x00" * n
        crc = zlib.crc32(bytes(data[start:start + 4 + n]))
        data[start + 4 + n:start + 8 + n] = crc.to_bytes(4, "big")
    else:
        data[1:4] = b"JPG"
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad.png"):
        imageio.read_image(path)


def test_ppm_and_jpeg():
    img = np.random.RandomState(5).randint(0, 256, (13, 21, 3), np.uint8)
    ok, enc = cv2.imencode(".ppm", img)
    np.testing.assert_array_equal(imageio.decode_image(bytes(enc)), img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(imageio.encode_ppm(img), np.uint8),
                     cv2.IMREAD_COLOR), img)
    ok, jpg = cv2.imencode(".jpg", img)
    np.testing.assert_array_equal(imageio.decode_image(bytes(jpg)),
                                  cv2.imdecode(jpg, cv2.IMREAD_COLOR))


# ----------------------------------------------------------- flow files

def test_flo_and_pfm_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    flow = rng.randn(11, 17, 2).astype(np.float32)
    PIO.write_flo(flow, tmp_path / "a.flo")
    assert (tmp_path / "a.flo").read_bytes() == _jax_bytes(
        JIO.write_flo, flow, tmp_path / "b.flo")
    np.testing.assert_array_equal(PIO.read_flo(tmp_path / "a.flo"), flow)
    for arr in (rng.randn(9, 13, 3).astype(np.float32),
                rng.randn(9, 13).astype(np.float32)):
        PIO.write_pfm(arr, tmp_path / "a.pfm")
        assert (tmp_path / "a.pfm").read_bytes() == _jax_bytes(
            JIO.write_pfm, arr, tmp_path / "b.pfm")
        np.testing.assert_array_equal(PIO.read_pfm(tmp_path / "a.pfm"),
                                      JIO.read_pfm(tmp_path / "a.pfm"))
    for suffix in (".flo", ".pfm"):
        p = tmp_path / ("c" + suffix)
        (PIO.write_flo if suffix == ".flo" else PIO.write_pfm)(
            flow if suffix == ".flo" else np.dstack([flow, flow[..., :1]]), p)
        np.testing.assert_array_equal(PIO.read_flow_any(p),
                                      JIO.read_flow_any(p))
    want = JIO.resize_flow(flow, 29, 7)
    np.testing.assert_allclose(PIO.resize_flow(flow, 29, 7), want,
                               rtol=1e-5, atol=1e-5)


def _jax_bytes(write, arr, path):
    write(arr, path)
    return path.read_bytes()


# ------------------------------------------------------------- datasets

def test_chairs_matches_jax_with_split(tmp_path):
    root = fabricate.chairs_tree(tmp_path, n_pairs=5, size=(24, 32),
                                 split=[1, 2, 1, 1, 2], seed=7)
    for split in ("training", "validation"):
        pds, jds = PD.FlyingChairs(root, split), JD.FlyingChairs(root, split)
        assert pds.image_list == jds.image_list
        assert pds.flow_list == jds.flow_list
        _same_samples(pds, jds)
    assert len(PD.FlyingChairs(root, "validation")) == 2


def test_sintel_matches_jax_with_scenes(tmp_path):
    root = fabricate.sintel_tree(tmp_path, scenes=("alley_1", "bamboo_2"),
                                 n_frames=4, size=(20, 28), seed=8)
    fabricate.sintel_tree(tmp_path, split="test", dstype="final",
                          scenes=("ambush_1",), n_frames=3, size=(20, 28))
    pds, jds = PD.MpiSintel(root), JD.MpiSintel(root)
    _same_samples(pds, jds)
    assert pds.scene_list == jds.scene_list
    assert [pds.is_scene_start(i) for i in range(len(pds))] == \
        [jds.is_scene_start(i) for i in range(len(jds))] == \
        [True, False, False, True, False, False]
    assert [pds.dump_name(i) for i in range(len(pds))] == \
        [jds.dump_name(i) for i in range(len(jds))]
    pt, jt = PD.MpiSintel(root, "test", "final"), JD.MpiSintel(root, "test",
                                                              "final")
    assert not pt.has_gt and not jt.has_gt
    _same_samples(pt, jt)
    assert pt.dump_name(1) == jt.dump_name(1) == "final/ambush_1/frame0002.png"


def test_things_matches_jax_on_the_release_nesting(tmp_path):
    root = fabricate.things_tree(tmp_path, sequences=(("A", "0000"),
                                                      ("B", "0001")),
                                 n_frames=3, size=(16, 24), seed=9)
    pds, jds = PD.FlyingThings3D(root), JD.FlyingThings3D(root)
    assert pds.image_list == jds.image_list and len(pds) == 8
    assert pds.flow_list == jds.flow_list
    _same_samples(pds, jds, indices=(0, 3, 5, 7))


def test_kitti_matches_jax_16bit_flow_and_testing_split(tmp_path):
    root = fabricate.kitti_tree(tmp_path, sizes=((20, 44), (18, 40)),
                                seed=10)
    fabricate.kitti_tree(tmp_path, sizes=((20, 44),), split="testing")
    # a 16-bit frame too: both readers take its high byte
    deep = np.random.RandomState(11).randint(0, 65536, (20, 44, 3))
    (tmp_path / "training" / "image_2" / "000000_11.png").write_bytes(
        imageio.encode_png(deep.astype(np.uint16)))
    pds, jds = PD.Kitti(root), JD.Kitti(root)
    assert pds.sparse and jds.sparse
    _same_samples(pds, jds)
    assert [pds.dump_name(i) for i in range(2)] == \
        [jds.dump_name(i) for i in range(2)] == ["000000_10.png",
                                                 "000001_10.png"]
    pt, jt = PD.Kitti(root, "testing"), JD.Kitti(root, "testing")
    assert not pt.has_gt and not jt.has_gt
    _same_samples(pt, jt)


def test_pair_list_and_sharding_match_jax(tmp_path):
    root = fabricate.sintel_tree(tmp_path, n_frames=3, size=(20, 28), seed=12)
    pairs = PD.MpiSintel(root).image_list
    for a, b in zip(PD.PairList(pairs, (16, 24)), JD.PairList(pairs, (16, 24))):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-6)
    ds = PD.MpiSintel(root)
    shard = PD.ShardedDataset(ds, 1, 2)
    assert len(shard) == len(JD.ShardedDataset(JD.MpiSintel(root), 1, 2)) == 1
    np.testing.assert_array_equal(shard[0][0], ds[1][0])
    with pytest.raises(ValueError, match="empty"):
        PD.ShardedDataset(ds, 2, 3)


# ---------------------------------------------------------- host tools

def test_frame_tools_match_jax():
    rng = np.random.RandomState(13)
    im = rng.randint(0, 256, (31, 45, 3)).astype(np.float64)
    assert np.abs(PFU.aug_img(im).astype(int)
                  - JFU.aug_img(im).astype(int)).max() <= 1
    for r in (3, 4, 5):
        m = (rng.rand(23, 37) > 0.2).astype(np.uint8)
        np.testing.assert_array_equal(PFU.erode_mask(m, r),
                                      JFU.erode_mask(m, r))
    flow = (rng.randn(20, 30, 2) * 3).astype(np.float32)
    bg = rng.randint(0, 256, (20, 30, 3))
    im0 = bg.copy()
    im0[:6] += 40
    for got, want in zip(PFU.reverse_flow(flow, bg, im0),
                         JFU.reverse_flow(flow, bg, im0)):
        np.testing.assert_array_equal(got, want)
    assert not np.any(PFU.set_static_flow(flow, im0, bg)
                      - JFU.set_static_flow(flow, im0, bg))
    np.testing.assert_array_equal(PVIZ.flow_to_color(flow),
                                  JVIZ.flow_to_color(flow))
    # calc_flow runs; its DIS part is the JAX function's output (raw DIS:
    # this OpenCV has no ximgproc), bitwise
    f0 = np.clip(im0, 0, 255).astype(np.uint8)
    f1 = np.roll(f0, (1, 2), axis=(0, 1))
    flow = PFU.calc_flow(f0, f1)
    assert flow.dtype == np.float32 and flow.shape == (20, 30, 2)
    assert np.isfinite(flow).all()
    np.testing.assert_array_equal(
        PFU._dis_flow(PFU._gray(f0), PFU._gray(f1)), JFU.calc_flow(f0, f1))
