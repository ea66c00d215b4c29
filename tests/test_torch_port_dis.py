"""The port's classical flow (``raft_tpu_torch/utils/frame_utils.py``:
``calc_flow`` = DIS at OpenCV's PRESET_MEDIUM in ``csrc/dis_flow.cpp`` + a
guided filter in numpy) against OpenCV and the JAX package on the CPU.

* Each DIS stage against cv2 with the same knobs set through cv2's setters
  (no variational refinement, no spatial propagation, one gradient-descent
  iteration, finest scale 0, no mean normalisation, the full preset); the
  variational refinement alone against ``cv2.VariationalRefinement``;
  all bitwise.
* ``calc_flow``'s DIS part against ``raft_tpu.utils.frame_utils.calc_flow``
  on four pairs: (a) a seeded texture translated by (2.3, -1.7) px at
  120x160, (b) the same texture under a 2 degree rotation and a 3% zoom at
  97x131, (c) a pair of ``data/synthetic.py`` at 128x192, (d) pair (a) at
  436x1024.  The OpenCV here has no ``ximgproc``, so the JAX function
  returns the raw DIS flow (``raft_tpu/utils/frame_utils.py:41-44``): the
  bar is a mean endpoint distance <= 0.01 px and a 99th percentile
  <= 0.1 px (the port is in fact bitwise).  Against the known motion of
  (a), (b) and (d), the port's EPE within 5% of cv2's plus 0.01 px; at
  436x1024 the port's DIS within 5x cv2's time.
* The grey conversions bitwise ``cv2.cvtColor`` over all 2^24 colours.
* The guided filter against a per-window float64 evaluation of He et al.'s
  formulas within 1e-4 px; a constant guide, and a large eps, leave the
  box mean (a = 0, b the window's mean of the input).
"""

import time

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu.utils import frame_utils as JFU

from raft_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_tpu_torch.utils import frame_utils as PFU

torch.set_num_threads(2)   # several test workers share the host's cores

KNOBS = {   # DIS setter name -> the port's knob name
    "setFinestScale": "finest_scale",
    "setGradientDescentIterations": "grad_descent_iter",
    "setVariationalRefinementIterations": "var_iter",
    "setUseMeanNormalization": "mean_normalization",
    "setUseSpatialPropagation": "spatial_propagation",
    "setPatchStride": "patch_stride",
}


def _cv_dis(g0, g1, **knobs):
    dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    for setter, name in KNOBS.items():
        if name in knobs:
            getattr(dis, setter)(knobs[name])
    return dis.calc(g0, g1, None)


def _pair(name):
    """The acceptance pairs: (im0, im1 [H, W, 3] uint8 BGR, true flow or
    None)."""
    if name == "a":
        return chip_smoke.host_texture_pair(120, 160, seed=0, shift=(2.3, -1.7))
    if name == "b":
        return chip_smoke.host_texture_pair(97, 131, seed=0, angle_deg=2.0,
                                            zoom=1.03)
    if name == "c":
        im1, im2, flow, _ = SyntheticFlowDataset(size=(128, 192), seed=3)[0]
        return (np.ascontiguousarray(im1, np.uint8),
                np.ascontiguousarray(im2, np.uint8), None)
    return chip_smoke.host_texture_pair(436, 1024, seed=0, shift=(2.3, -1.7))


def _dist(a, b):
    return np.sqrt(((a.astype(np.float64) - b) ** 2).sum(-1))


STAGES = {
    "search-only-finest0": dict(var_iter=0, spatial_propagation=False,
                                grad_descent_iter=1, finest_scale=0),
    "search-only": dict(var_iter=0, spatial_propagation=False,
                        grad_descent_iter=1),
    "descent": dict(var_iter=0, spatial_propagation=False),
    "propagation": dict(var_iter=0),
    "no-mean-norm": dict(var_iter=0, mean_normalization=False),
    "stride-4": dict(patch_stride=4),
    "preset": dict(),
}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("pair", ["a", "b", "c"])
def test_dis_stages_are_cv2_bitwise(stage, pair):
    im0, im1, _ = _pair(pair)
    g0, g1 = PFU._gray(im0), PFU._gray(im1)
    got = PFU._dis_flow(g0, g1, **STAGES[stage])
    want = _cv_dis(g0, g1, **STAGES[stage])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want), float(_dist(got, want).max())


@pytest.mark.parametrize("size", [(24, 32), (37, 53), (60, 80)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_variational_refinement_is_cv2_bitwise(size):
    h, w = size
    im0, im1, _ = chip_smoke.host_texture_pair(h, w, seed=1, shift=(1.7, 0.6))
    g0, g1 = PFU._gray(im0), PFU._gray(im1)
    rng = np.random.RandomState(h)
    u = (rng.randn(h, w) * 0.5 + 1.5).astype(np.float32)
    v = (rng.randn(h, w) * 0.5).astype(np.float32)
    for fixed, sor in ((1, 1), (1, 5), (5, 5), (3, 0)):
        vr = cv2.VariationalRefinement_create()
        vr.setFixedPointIterations(fixed)
        vr.setSorIterations(sor)
        want_u, want_v = vr.calcUV(g0, g1, u.copy(), v.copy())
        got_u, got_v = PFU._variational_refinement(
            g0, g1, u, v, fixed_point_iters=fixed, sor_iters=sor)
        assert np.array_equal(got_u, want_u) and np.array_equal(got_v, want_v)


@pytest.mark.parametrize("size", [(12, 12), (32, 32), (64, 300), (250, 40)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dis_scales_follow_cv2_at_small_and_odd_sizes(size):
    """The coarsest scale from the frame size, and the small-frame
    selection of patch and scales, as OpenCV derives them."""
    im0, im1, _ = chip_smoke.host_texture_pair(*size, seed=2, shift=(1.3, 0.7))
    g0, g1 = PFU._gray(im0), PFU._gray(im1)
    assert np.array_equal(PFU._dis_flow(g0, g1), _cv_dis(g0, g1))


def test_dis_refuses_frames_smaller_than_a_patch():
    g = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError, match="12 or more"):
        PFU._dis_flow(g, g)
    with pytest.raises(TypeError, match="unknown DIS knobs"):
        PFU._dis_flow(g, g, iterations=3)


def test_opencv_here_lacks_ximgproc():
    """Why the JAX calc_flow is raw DIS on this host: its guided filter is
    ``cv2.ximgproc.guidedFilter``, and the AttributeError makes it return
    the DIS flow (raft_tpu/utils/frame_utils.py:41-44)."""
    assert not hasattr(cv2, "ximgproc")


@pytest.mark.parametrize("pair", ["a", "b", "c", "d"])
def test_calc_flow_dis_part_matches_jax(pair):
    im0, im1, truth = _pair(pair)
    for use_yuv in (False, True):
        want = JFU.calc_flow(im0, im1, use_yuv=use_yuv)       # raw DIS here
        got = PFU._dis_flow(PFU._gray(im0, use_yuv), PFU._gray(im1, use_yuv))
        d = _dist(got, want)
        assert d.mean() <= 0.01 and np.percentile(d, 99) <= 0.1, (
            pair, use_yuv, d.mean(), np.percentile(d, 99))
    if truth is not None:
        ours = chip_smoke.interior_epe(got, truth)
        theirs = chip_smoke.interior_epe(want, truth)
        assert ours <= 1.05 * theirs + 0.01, (ours, theirs)
    flow = PFU.calc_flow(im0, im1)
    assert flow.dtype == np.float32 and flow.shape == im0.shape[:2] + (2,)
    assert np.isfinite(flow).all()


def test_dis_time_within_5x_cv2_at_436x1024():
    im0, im1, _ = _pair("d")
    g0, g1 = PFU._gray(im0), PFU._gray(im1)
    ours, theirs = [], []
    for _ in range(3):          # interleaved, the best of three each
        t0 = time.perf_counter()
        PFU._dis_flow(g0, g1)
        t1 = time.perf_counter()
        _cv_dis(g0, g1)
        theirs.append(time.perf_counter() - t1)
        ours.append(t1 - t0)
    assert min(ours) <= 5 * min(theirs), (min(ours), min(theirs))


def test_chip_phase_flow_bound_holds_here():
    """Phase 15's pair: calc_flow's interior EPE is what chip_smoke.py
    records as measured here, inside its gate, and its flows' digests are
    the ones it prints beside the card host's."""
    import hashlib
    im0, im1, truth = chip_smoke.host_texture_pair(
        *chip_smoke.HOST_HW, seed=0, shift=chip_smoke.HOST_SHIFT)
    flow = PFU.calc_flow(im0, im1)
    dis = PFU._dis_flow(PFU._gray(im0), PFU._gray(im1))
    epe = chip_smoke.interior_epe(flow, truth)
    assert abs(epe - chip_smoke.DIS_EPE_MEASURED) <= 1e-6
    assert epe <= chip_smoke.DIS_EPE_BOUND
    assert (hashlib.sha256(dis.tobytes()).hexdigest()
            == chip_smoke.FLOW_SHA256_CPU_HOST["dis"])
    assert (hashlib.sha256(flow.tobytes()).hexdigest()
            == chip_smoke.FLOW_SHA256_CPU_HOST["calc_flow"])


def test_grey_conversions_are_cvtcolor_bitwise():
    levels = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                     -1).reshape(4096, 4096, 3)
    assert np.array_equal(PFU._gray(every),
                          cv2.cvtColor(every, cv2.COLOR_BGR2GRAY))
    assert np.array_equal(PFU._gray(every, use_yuv=True),
                          cv2.cvtColor(every, cv2.COLOR_BGR2YUV)[:, :, 0])
    with pytest.raises(ValueError, match="uint8"):
        PFU._gray(every.astype(np.float32))


def _reflect(i, n):
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * n - 2 - i
    return i


def _guided_per_window(I, p, r, eps):
    """He et al.'s eq. 19-21, window by window in float64 (reflect-101)."""
    h, w = I.shape[:2]
    win = [[(np.array([_reflect(y + d, h) for d in range(-r, r + 1)]),
             np.array([_reflect(x + d, w) for d in range(-r, r + 1)]))
            for x in range(w)] for y in range(h)]
    a = np.zeros((h, w, 3))
    b = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            ys, xs = win[y][x]
            Iw = I[np.ix_(ys, xs)].reshape(-1, 3)
            pw = p[np.ix_(ys, xs)].reshape(-1)
            mu = Iw.mean(0)
            cov = (Iw[:, :, None] * Iw[:, None, :]).mean(0) - np.outer(mu, mu)
            a[y, x] = np.linalg.solve(cov + eps * np.eye(3),
                                      (Iw * pw[:, None]).mean(0) - mu * pw.mean())
            b[y, x] = pw.mean() - a[y, x] @ mu
    q = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            ys, xs = win[y][x]
            q[y, x] = (a[np.ix_(ys, xs)].reshape(-1, 3).mean(0) @ I[y, x]
                       + b[np.ix_(ys, xs)].mean())
    return q


def test_guided_filter_is_he_et_al():
    rng = np.random.RandomState(0)
    I = rng.randint(0, 256, (14, 17, 3)).astype(np.uint8)
    flow = (rng.randn(14, 17, 2) * 3).astype(np.float32)
    got = PFU._guided_filter(I, flow, radius=3, eps=2.0)
    assert got.dtype == np.float32 and got.shape == flow.shape
    for c in range(2):
        want = _guided_per_window(I.astype(np.float64), flow[:, :, c].astype(
            np.float64), 3, 2.0)
        assert np.abs(got[:, :, c] - want).max() <= 1e-4


def _box_mean_per_window(p, r):
    h, w = p.shape
    out = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            ys = [_reflect(y + d, h) for d in range(-r, r + 1)]
            xs = [_reflect(x + d, w) for d in range(-r, r + 1)]
            out[y, x] = p[np.ix_(ys, xs)].mean()
    return out


def test_guided_filter_invariants():
    """A constant guide (no structure to follow) and a huge eps both make
    every window's a = 0 and b its box mean of the input, so the output is
    the box mean (over each pixel's windows) of those box means."""
    rng = np.random.RandomState(1)
    p = rng.randn(20, 23).astype(np.float32)
    want = _box_mean_per_window(_box_mean_per_window(p.astype(np.float64), 9), 9)
    flat = np.full((20, 23, 3), 117, np.uint8)
    np.testing.assert_allclose(PFU._guided_filter(flat, p), want, atol=1e-5)
    guide = rng.randint(0, 256, (20, 23, 3)).astype(np.uint8)
    np.testing.assert_allclose(PFU._guided_filter(guide, p, eps=1e12), want,
                               atol=1e-5)
