"""The port's data path for training: the OpenCV-free synthetic dataset
against the JAX package's (which resamples with OpenCV), its resizes
against ``cv2.resize``, determinism per (seed, index), and the batching
and prefetch pipeline on the CPU.

Frame 1 of a sample differs from JAX's by the 1/32-px quantization of
``cv2.remap``'s sampling position (the port samples exactly): at most
``(max |dI/dx| + max |dI/dy|) / 64 + 1`` levels of 255 per pixel, the
derivatives over neighbouring pixels of the canvas, plus a level for a
canvas pixel that truncates the other way; frame 2 (a crop of the canvas)
within one level, the flow within 1e-5 px."""

import numpy as np
import pytest

from raft_tpu_torch.data import synthetic
from raft_tpu_torch.data.datasets import make_training_dataset
from raft_tpu_torch.data.pipeline import (BatchBuffers, PrefetchLoader,
                                          batch_samples, batched,
                                          synthetic_batches)

import torch

torch.set_num_threads(2)   # several test workers share the host's cores

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("shape,size", [((6, 8, 3), (33, 17)),
                                        ((12, 16, 3), (100, 75)),
                                        ((30, 40, 2), (20, 15))])
def test_resizes_match_opencv(shape, size):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    for mine, flag in ((synthetic.resize_linear, cv2.INTER_LINEAR),
                       (synthetic.resize_cubic, cv2.INTER_CUBIC)):
        want = cv2.resize(img, size, interpolation=flag)
        got = mine(img, size)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("index", [0, 7])
def test_synthetic_sample_matches_jax_within_the_remap_bound(index):
    from raft_tpu.data.synthetic import SyntheticFlowDataset as JaxSynthetic
    size = (96, 128)
    mine = synthetic.SyntheticFlowDataset(size=size, seed=3)
    theirs = JaxSynthetic(size=size, seed=3)
    im1, im2, flow, valid = mine[index]
    j1, j2, jflow, jvalid = theirs[index]
    np.testing.assert_allclose(flow, jflow, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(valid, jvalid)
    assert np.abs(im2 - j2).max() <= 1.0 / 255 + 1e-7
    # the remap bound, from the canvas the sample was cut from
    rng = np.random.RandomState((3 * 1_000_003 + index) % (2 ** 31))
    margin = int(np.ceil(mine.max_flow)) + 2
    canvas = synthetic._noise_texture(rng, size[0] + 2 * margin,
                                      size[1] + 2 * margin).astype(np.float32)
    dx = np.abs(np.diff(canvas, axis=1)).max()
    dy = np.abs(np.diff(canvas, axis=0)).max()
    bound = ((dx + dy) / 64.0 + 2.0) / 255.0
    assert np.abs(im1 - j1).max() <= bound + 1e-7, (np.abs(im1 - j1).max(),
                                                     bound)
    assert np.abs(im1 - j1).mean() < 0.5 / 255


def test_synthetic_is_deterministic_and_unported_stages_raise():
    ds = make_training_dataset("synthetic", None, (32, 48))
    a, b = ds[5], ds[5]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(ds[5][0], ds[6][0])
    assert a[0].shape == (32, 48, 3) and a[0].dtype == np.float32
    assert 0.0 <= a[0].min() and a[0].max() <= 1.0
    for stage in ("chairs", "things", "sintel", "kitti"):
        with pytest.raises(ValueError, match="--data"):
            make_training_dataset(stage, None, (32, 48))


def test_batching_and_prefetch_on_cpu():
    ds = make_training_dataset("synthetic", None, (16, 24))
    samples = [ds[i] for i in range(4)]
    stacked = batch_samples(samples)
    assert stacked[0].shape == (4, 16, 24, 3)
    coll = BatchBuffers.for_loader(2, 2)
    got = list(batched(iter(samples + samples[:1]), 2, collator=coll,
                       drop_remainder=False))
    assert [b[0].shape[0] for b in got] == [2, 2, 1]
    loader = PrefetchLoader(batched(ds.sample_iter(seed=1), 2), "cpu",
                            buffer_size=2)
    try:
        first = next(loader)
        again = next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    assert first[0].shape == (2, 16, 24, 3) and first[3].shape == (2, 16, 24)
    assert not np.array_equal(first[0].numpy(), again[0].numpy())
    im1, im2, flow, valid = next(synthetic_batches(3, (8, 16)))
    assert im1.shape == (3, 8, 16, 3) and valid.min() == 1.0
