"""The port's augmentors against the JAX package's.

* ``FlowAugmentor.sample_params``: one seed gives identical parameters in
  both packages (the same ``RandomState`` draws in the same order),
  compared exactly.
* ``FlowAugmentor.apply_params``, ``SparseFlowAugmentor`` and
  ``PairAugmentor``: within ``HOST_ATOL`` of the JAX package's on [0, 1]
  frames and flows of a few pixels (the port resizes with
  ``resize_linear``, what ``cv2.resize`` computes, in another float32
  summation order); ``resample_sparse_flow`` bitwise.  ``PairAugmentor``
  with ``rgb_augmentation`` (its JPEG round trip through the port's codec)
  bitwise on seeds that draw no blur, within a measured bound otherwise.
* The device augmentor: the same ``params_from_host`` parameters through
  the port's ``DeviceFlowAugmentor.apply_params`` and the JAX package's,
  within ``DEVICE_ATOL`` (the JAX package's own bound between its device
  and host augmentors), one sample at a time and as one batch.
* The training stages: ``make_training_dataset`` serves the same
  augmented samples as the JAX package's for the same per-index seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.data import augment as JA
from raft_tpu.data import datasets as JD
from raft_tpu.data.augment_device import DeviceFlowAugmentor as JaxDevice
from raft_tpu.data.augment_device import params_from_host as jax_params

from raft_tpu_torch.data import augment as PA
from raft_tpu_torch.data import datasets as PD
from raft_tpu_torch.data import fabricate
from raft_tpu_torch.data.augment_device import (DecodeOnlyDataset,
                                                DeviceFlowAugmentor,
                                                make_batch_augment_fn,
                                                make_device_augmentor,
                                                params_from_host)
from raft_tpu_torch.data.pipeline import PrefetchLoader

torch.set_num_threads(2)   # several test workers share the host's cores

HOST_ATOL = 2e-5       # [0, 1] frames and pixel flows, port vs JAX host
DEVICE_ATOL = 1e-5     # port device vs JAX device on shared params
H, W, CROP = 96, 128, (64, 96)


def _inputs(seed=0, h=H, w=W):
    rng = np.random.RandomState(seed)
    im1 = rng.randint(0, 255, (h, w, 3), np.uint8)
    im2 = rng.randint(0, 255, (h, w, 3), np.uint8)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([0.03 * xs + 2.0 + 3 * np.sin(ys / 17),
                     -0.02 * ys + 1.0 + 2 * np.cos(xs / 23)],
                    -1).astype(np.float32)
    return im1, im2, flow


def _close(got, want, atol, what):
    for name, a, b in zip(("im1", "im2", "flow", "valid"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("stage", ["chairs", "things", "sintel",
                                   "synthetic"])
def test_sample_params_are_jax_draws(stage):
    lo, hi = PA.STAGE_SCALES[stage]
    assert JA.STAGE_SCALES[stage] == (lo, hi)
    for seed in range(40):
        p = PA.FlowAugmentor(CROP, min_scale=lo, max_scale=hi,
                             rng=np.random.RandomState(seed))
        j = JA.FlowAugmentor(CROP, min_scale=lo, max_scale=hi,
                             rng=np.random.RandomState(seed))
        for _ in range(3):   # the stream continues in step too
            assert p.sample_params(H, W) == j.sample_params(H, W)


def test_apply_params_matches_jax():
    im1, im2, flow = _inputs()
    seen = set()
    for seed in range(25):
        p = JA.FlowAugmentor(CROP, rng=np.random.RandomState(seed)
                             ).sample_params(H, W)
        seen |= {(p["nh"], p["nw"]) != (H, W), p["hflip"], p["vflip"],
                 bool(p["erase_rects"])} - {False}
        _close(PA.FlowAugmentor(CROP).apply_params(im1, im2, flow, p),
               JA.FlowAugmentor(CROP).apply_params(im1, im2, flow, p),
               HOST_ATOL, f"seed {seed}")
    assert seen == {True}


def test_sparse_and_pair_augmentors_match_jax():
    im1, im2, flow = _inputs(1)
    valid = (np.random.RandomState(2).rand(H, W) > 0.5).astype(np.float32)
    for seed in range(20):
        _close(PA.SparseFlowAugmentor(CROP, rng=np.random.RandomState(seed))(
                   im1, im2, flow, valid),
               JA.SparseFlowAugmentor(CROP, rng=np.random.RandomState(seed))(
                   im1, im2, flow, valid), HOST_ATOL, f"sparse seed {seed}")
    for sx, sy in ((1.3, 1.3), (0.7, 0.9), (2.0, 2.0)):
        for a, b in zip(PA.resample_sparse_flow(flow, valid, sx, sy),
                        JA.resample_sparse_flow(flow, valid, sx, sy)):
            np.testing.assert_array_equal(a, b)
    for kw in (dict(test_mode=True), dict(general_augmentation=True,
                                          random_crop=True)):
        for seed in range(4):
            got = PA.PairAugmentor((40, 50), rng=np.random.RandomState(seed),
                                   **kw)(im1, im2)
            want = JA.PairAugmentor((40, 50), rng=np.random.RandomState(seed),
                                    **kw)(im1, im2)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=HOST_ATOL)
    # rgb_augmentation: contrast, gamma, blur, then the JPEG round trip
    # through the port's codec (byte for byte cv2's).  Bitwise where the
    # seed draws no blur; with a blur, the port's float64 Gaussian and
    # cv2's float32 one can differ by rounding, astype(np.uint8) then
    # truncates one pixel to the next level, and the JPEG spreads that
    # through its 8x8 block.  Over seeds 0-199, both settings, on these
    # frames: 1 of 400 draws not bitwise, by at most 2/255 (mean 0.028/255);
    # on _inputs(0): 2 of 400, by at most 14/255 (mean 0.31/255).  The
    # bound is 16/255 with a mean difference under 1/255
    for kw in (dict(rgb_augmentation=True),
               dict(rgb_augmentation=True, general_augmentation=True,
                    random_crop=True)):
        for seed in range(12):
            got = PA.PairAugmentor((40, 50), rng=np.random.RandomState(seed),
                                   **kw)(im1, im2)
            want = JA.PairAugmentor((40, 50), rng=np.random.RandomState(seed),
                                    **kw)(im1, im2)
            draws = np.random.RandomState(seed)
            if kw.get("general_augmentation"):
                draws.choice([0, 1])
            draws.uniform(0.8, 1.2)
            draws.uniform(-0.3, 0.3)
            blur = draws.randint(0, 3)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                if blur == 0:
                    np.testing.assert_array_equal(a, b)
                else:
                    assert np.abs(a - b).max() <= 16 / 255 + 1e-6
                    assert np.abs(a - b).mean() <= 1 / 255


def test_device_augmentor_matches_jax_on_shared_params():
    im1, im2, flow = _inputs(3)
    jdev, pdev = JaxDevice(CROP), DeviceFlowAugmentor(CROP)
    params, want = [], []
    for seed in range(25):
        p = JA.FlowAugmentor(CROP, rng=np.random.RandomState(seed)
                             ).sample_params(H, W)
        params.append(p)
        want.append(jdev.apply_params(jax_params(p), jnp.asarray(im1),
                                      jnp.asarray(im2), jnp.asarray(flow)))
        got = pdev.apply_params(params_from_host(p),
                                *(torch.from_numpy(x)[None]
                                  for x in (im1, im2, flow)))
        _close([g[0] for g in got], want[-1], DEVICE_ATOL, f"seed {seed}")
    batch = pdev.apply_params(params_from_host(params),
                              *(torch.from_numpy(x)[None].expand(
                                  len(params), *x.shape)
                                for x in (im1, im2, flow)))
    for k, w in enumerate(want):
        _close([g[k] for g in batch], w, DEVICE_ATOL, f"batch row {k}")


def test_device_augmentor_sampling_and_the_prefetch_hook():
    """Draws from a torch.Generator: the same seed, the same batch; params
    within the recipe's ranges; PrefetchLoader applies it after staging."""
    im1, im2, flow = _inputs(4)
    aug = make_device_augmentor("chairs", CROP)
    hw = torch.tensor([[H, W]]).expand(6, 2)
    p1 = aug.sample_params(torch.Generator().manual_seed(5), hw)
    p2 = aug.sample_params(torch.Generator().manual_seed(5), hw)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    assert bool(((p1.contrast >= 0.8) & (p1.contrast <= 1.2)).all())
    assert bool(((p1.y0 >= 0) & (p1.y0 <= p1.nh - CROP[0])).all())
    assert bool(((p1.x0 >= 0) & (p1.x0 <= p1.nw - CROP[1])).all())
    fn = make_batch_augment_fn(aug, hw=(H, W))
    batch = tuple(np.stack([x] * 3) for x in (im1, im2, flow))
    with PrefetchLoader(iter([batch, batch]), "cpu", augment_fn=fn,
                        augment_seed=9) as pf:
        out = list(pf)
    assert len(out) == 2 and tuple(out[0][0].shape) == (3, *CROP, 3)
    assert tuple(out[0][3].shape) == (3, *CROP)
    want = fn(tuple(torch.from_numpy(x) for x in batch),
              torch.Generator().manual_seed(9 * 1_000_003))
    for a, b in zip(out[0], want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no preset"):
        make_device_augmentor("kitti", CROP)


def test_training_stages_match_jax(tmp_path):
    """make_training_dataset per stage: the port's samples (host
    augmentor, reseeded per index as the workers reseed it) equal the
    JAX package's within HOST_ATOL; device_aug serves decode-only
    samples; kitti under device_aug raises as in JAX."""
    crop = (24, 32)
    roots = {
        "chairs": fabricate.chairs_tree(tmp_path / "c", 2, (40, 56), seed=1),
        "things": fabricate.things_tree(tmp_path / "t", n_frames=2,
                                        size=(40, 56), seed=2),
        "sintel": fabricate.sintel_tree(tmp_path / "s", n_frames=3,
                                        size=(40, 56), seed=3),
        "kitti": fabricate.kitti_tree(tmp_path / "k", ((40, 56), (40, 56)),
                                      seed=4),
    }
    for stage, root in roots.items():
        pds = PD.make_training_dataset(stage, str(root), crop)
        jds = JD.make_training_dataset(stage, str(root), crop)
        assert len(pds) == len(jds) == 2, stage
        for idx in range(2):
            for ds in (pds, jds):
                ds.augmentor.rng = np.random.RandomState(100 + idx)
            _close(pds[idx], jds[idx], HOST_ATOL, f"{stage} {idx}")
    dec = DecodeOnlyDataset(PD.make_training_dataset(
        "chairs", str(roots["chairs"]), crop, device_aug=True))
    im1, im2, flow = dec[0]
    assert im1.dtype == np.uint8 and dec.canonical_hw == (40, 56)
    assert flow.dtype == np.float32 and flow.shape == (40, 56, 2)
    with pytest.raises(ValueError, match="sparse"):
        PD.make_training_dataset("kitti", str(roots["kitti"]), crop,
                                 device_aug=True)
    with pytest.raises(ValueError, match="--data"):
        PD.make_training_dataset("chairs", None, crop)
