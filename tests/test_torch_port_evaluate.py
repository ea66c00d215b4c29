"""The port's evaluation harness (``training/evaluate.py``) against the JAX
package's on the same converted weights and fabricated trees, raft-small
at 2 iterations: a Sintel tree of two scenes under the warm-start protocol
(scene resets), and a KITTI tree of two frame sizes under bucket 64,
pixel weighting and batches of 2.  The dumped predictions (.flo) agree
within the model's bound of tests/test_torch_golden.py, ``1e-3 + 1e-3 *
max|flow|`` per value, and KITTI's 16-bit PNGs within one 1/64 px step on
top; so the EPE, at most the mean of those differences, within
``EPE_RTOL`` of JAX's (random weights predict flows of about the EPE's
size), and the pixel rates within ``RATE_ATOL``.  The JAX side runs its
plain lookup (dense), the port its kernel configuration's plain versions
on the CPU.

The warm start seeds each frame by projecting the last 1/8 flow along
itself to the rounded target pixel, a step function of the flow: random
weights predict flows of about 100 px on a 5x7 grid, where a rounding
difference between the packages moves whole seed values.  So the Sintel
comparison runs with the flow head's last convolution scaled by 1e-3
(flows well under half a pixel on that grid: every pixel projects onto
itself, and no pixel needs the fill, whose nearest-hit rule differs by
design between the packages; ROADMAP, deviations).  The warm frames must
then differ from cold ones, and each scene's first frame equal a cold
evaluation (the scene reset).  This comparison therefore does not hold
the projection and the fill against JAX: the seed is a pure function of
the given flow, and ``tests/test_torch_port_stream.py::
test_warm_start_seed_matches_jax`` holds it at realistic flows (a shift, a
rotation and a 4 px random field: the splat bitwise, the fill a value of
an exact nearest hit, equal wherever the nearest hit is unique).

Also ``-m val`` in process (the CLI's flag checks, the gt-less export)."""

import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.data import datasets as JD
from raft_tpu.training.evaluate import evaluate_dataset as jax_evaluate
from raft_tpu.utils import flow_io as JIO

import raft_tpu_torch as rt
from raft_tpu_torch.convert.weights import to_jax_params
from raft_tpu_torch.data import datasets as PD
from raft_tpu_torch.data import fabricate
from raft_tpu_torch.training.__main__ import main
from raft_tpu_torch.training.evaluate import evaluate_dataset
from raft_tpu_torch.utils import flow_io as PIO

torch.set_num_threads(2)   # several test workers share the host's cores

ITERS = 2
EPE_RTOL = 1e-3
RATE_ATOL = 2e-3
JCFG = JaxConfig.small_model(iters=ITERS)
PCFG = rt.RAFTConfig.small_model(corr_impl="pallas", iters=ITERS)


@pytest.fixture(scope="module")
def weights():
    model = rt.init_raft_torch(PCFG, torch.Generator().manual_seed(3),
                               device="cpu")
    return model, to_jax_params(model.state_dict())


@pytest.fixture(scope="module")
def small_flow_weights(weights):
    """``weights`` with the flow head's output scaled by 1e-3."""
    model = rt.RAFT(PCFG).eval()
    model.load_state_dict(weights[0].state_dict())
    with torch.no_grad():
        for name in ("weight", "bias"):
            getattr(model.update_block.flow_head.conv2, name).mul_(1e-3)
    return model, to_jax_params(model.state_dict())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    sintel = fabricate.sintel_tree(root / "sintel",
                                   scenes=("alley_1", "bamboo_2"),
                                   n_frames=3, size=(36, 50), seed=1)
    kitti = fabricate.kitti_tree(root / "kitti",
                                 sizes=((37, 90), (40, 100), (37, 90),
                                        (40, 100)), seed=2)
    return sintel, kitti


def _held(got, want):
    assert got["samples"] == want["samples"]
    for k in ("epe", "1px", "3px", "5px", "fl_all"):
        if k == "epe":
            np.testing.assert_allclose(got[k], want[k], rtol=EPE_RTOL)
        else:
            assert abs(got[k] - want[k]) <= RATE_ATOL, (k, got[k], want[k])


def test_sintel_warm_start_matches_jax(small_flow_weights, trees, tmp_path):
    model, params = small_flow_weights
    sintel = trees[0]
    kw = dict(warm_start=True, bucket=8, pad_mode="sintel", verbose=False)
    got = evaluate_dataset(model, PCFG, PD.MpiSintel(sintel),
                           dump_dir=str(tmp_path / "p"), **kw)
    want = jax_evaluate(params, JCFG, JD.MpiSintel(sintel),
                        dump_dir=str(tmp_path / "j"), **kw)
    _held(got, want)
    assert got["samples"] == 4 and got["shapes"] == 1
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.flo"))
    assert [str(f) for f in files] == [
        "clean/alley_1/frame0001.flo", "clean/alley_1/frame0002.flo",
        "clean/bamboo_2/frame0001.flo", "clean/bamboo_2/frame0002.flo"]
    for f in files:
        want_flow = JIO.read_flo(tmp_path / "j" / f)
        np.testing.assert_allclose(
            PIO.read_flo(tmp_path / "p" / f), want_flow, rtol=0,
            atol=1e-3 + 1e-3 * np.abs(want_flow).max())
    # the scene reset: each scene's first frame starts cold; the second
    # frames start from the projected flow
    evaluate_dataset(model, PCFG, PD.MpiSintel(sintel),
                     dump_dir=str(tmp_path / "c"), verbose=False)
    for f in files:
        warm, cold = (PIO.read_flo(tmp_path / d / f) for d in ("p", "c"))
        assert np.array_equal(warm, cold) == f.name.endswith("0001.flo"), f


def test_kitti_bucket64_pixel_weighting_matches_jax(weights, trees,
                                                    tmp_path):
    model, params = weights
    kitti = trees[1]
    kw = dict(bucket=64, pad_mode="kitti", weighting="pixel", batch_size=2,
              verbose=False)
    got = evaluate_dataset(model, PCFG, PD.Kitti(kitti),
                           dump_dir=str(tmp_path / "p"), **kw)
    want = jax_evaluate(params, JCFG, JD.Kitti(kitti),
                        dump_dir=str(tmp_path / "j"), **kw)
    _held(got, want)
    assert got["samples"] == 4 and got["shapes"] == 1   # 2 x [2, 64, 128]
    for i in range(4):
        name = f"{i:06d}_10.png"
        pf, pv = PIO.read_kitti_flow(tmp_path / "p" / name)
        jf, jv = JIO.read_kitti_flow(tmp_path / "j" / name)
        assert pf.shape == jf.shape == ((37, 90, 2) if i % 2 == 0
                                        else (40, 100, 2))
        assert pv.all() and jv.all()
        # both quantize to 1/64 px: one step on top of the model's bound
        bound = 1e-3 + 1e-3 * np.abs(jf).max() + 1 / 64
        assert np.abs(pf - jf).max() <= bound


def test_val_cli_flags_and_gt_less_export(trees, tmp_path, capsys):
    sintel, kitti = trees
    base = ["-m", "val", "--cpu", "--small", "--iters", "1"]
    assert main([*base, "--dataset", "sintel", "--data", str(sintel),
                 "--warm-start", "--max-samples", "2"]) == 0
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and "samples=2.0000" in out
    assert main([*base, "--dataset", "kitti", "--data", str(kitti),
                 "--warm-start"]) == 2
    assert main([*base, "--dataset", "sintel", "--data", str(sintel),
                 "--bucket", "12"]) == 2
    assert main([*base, "--dataset", "chairs"]) == 2        # no --data
    assert main([*base, "--dataset", "kitti", "--data", str(tmp_path)]) == 2
    fabricate.kitti_tree(tmp_path / "k", sizes=((37, 90),), split="testing")
    assert main([*base, "--dataset", "kitti", "--data", str(tmp_path / "k"),
                 "--split", "testing"]) == 2                # no --dump-flow
    assert main([*base, "--dataset", "kitti", "--data", str(tmp_path / "k"),
                 "--split", "testing", "--dump-flow",
                 str(tmp_path / "sub")]) == 0
    assert (tmp_path / "sub" / "000000_10.png").exists()
    with pytest.raises(ValueError, match="multiple of 8"):
        evaluate_dataset(None, PCFG, [], bucket=12)
