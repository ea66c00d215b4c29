"""``python -m raft_tpu_torch.cli`` on the CPU, held against the JAX
package's ``python -m raft_tpu.cli``: the frame pair it reads (bitwise,
OpenCV's uint8 resize without OpenCV; JPEG frames too, whose flow is that
of the same pixels as PNG), ``-m test`` flows from the same
checkpoint (within the per-iteration tolerance ``1e-3 + 1e-3*max|flow|``,
PNG pixels within 2 levels), the modes ``-m val`` and ``-m train``
dispatch, the flags the port does not have raise naming their ROADMAP
item, and the serving and training entries load a torch ``.pth``."""

import argparse
import sys

import numpy as np
import pytest
import torch

import jax

from raft_tpu import cli as jcli
from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.convert import save_params_npz as jax_save_npz
from raft_tpu.models import init_raft

from raft_tpu_torch import cli
from raft_tpu_torch import convert as pconv
from raft_tpu_torch.imageio import read_image
from raft_tpu_torch.utils.flow_io import read_flo

torch.set_num_threads(2)   # several test workers share the host's cores


@pytest.mark.parametrize("size", [(432, 1024), (48, 64)], ids=["432x1024", "48x64"])
@pytest.mark.parametrize("rgb", [False, True], ids=["bgr", "rgb"])
def test_read_pair_is_bitwise_jax(size, rgb):
    args = argparse.Namespace(im1="assets/frame_0016.png",
                              im2="assets/frame_0017.png", size=size, rgb=rgb)
    for got, want in zip(cli.read_pair(args), jcli._read_pair(args)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_mode_test_reads_jpeg_frames(tmp_path):
    """``-m test --im1 a.jpg --im2 b.jpg``: the pair is what the JAX CLI's
    ``cv2.imread`` gives (bitwise), and the flow is the flow of the same
    pixels stored as PNG."""
    import cv2
    paths = {}
    for name, src in (("a", "assets/frame_0016.png"),
                      ("b", "assets/frame_0017.png")):
        img = read_image(src)
        jpg = tmp_path / f"{name}.jpg"
        jpg.write_bytes(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1])
        png = tmp_path / f"{name}.png"
        cv2.imwrite(str(png), cv2.imread(str(jpg)))
        paths[name] = (jpg, png)
    args = argparse.Namespace(im1=str(paths["a"][0]), im2=str(paths["b"][0]),
                              size=(48, 64), rgb=False)
    for got, want in zip(cli.read_pair(args), jcli._read_pair(args)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    flows = []
    for k, ext in ((0, "jpg"), (1, "png")):
        out = tmp_path / ext
        assert cli.main(["-m", "test", "--cpu", "--small", "--iters", "2",
                         "--size", "48", "64", "--im1", str(paths["a"][k]),
                         "--im2", str(paths["b"][k]), "--save-flo",
                         "--out", str(out)]) == 0
        flows.append(read_flo(out / "raft_flow_raft-small.flo"))
    assert flows[0].shape == (48, 64, 2)
    np.testing.assert_array_equal(flows[0], flows[1])


CASES = {
    "small-dense": (dict(small=True, corr_impl="dense"), ["--small"]),
    "full-kernels": (dict(small=False, corr_impl="pallas", gru_impl="pallas"),
                     ["--corr-impl", "pallas", "--gru-impl", "pallas"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_test_matches_jax(case, tmp_path, capsys):
    kw, flags = CASES[case]
    small = kw.pop("small")
    jcfg = (JaxConfig.small_model if small else JaxConfig.full)(iters=2, **kw)
    ckpt = tmp_path / "w.npz"
    jax_save_npz(jax.tree.map(np.asarray,
                              init_raft(jax.random.PRNGKey(5), jcfg)), ckpt)
    common = ["-m", "test", "--cpu", "--iters", "2", "--size", "48", "64",
              "--load", str(ckpt), "--save-flo", *flags]
    assert jcli.main(common + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {ckpt}" in out and "steady" in out
    name = f"raft_flow_{'raft-small' if small else 'raft-things'}"
    want = read_flo(tmp_path / "jax" / f"{name}.flo")
    got = read_flo(tmp_path / "port" / f"{name}.flo")
    assert got.shape == want.shape == (48, 64, 2)
    err = np.abs(got - want).max()
    assert err <= 1e-3 + 1e-3 * np.abs(want).max(), err
    import cv2
    png_j = cv2.imread(str(tmp_path / "jax" / f"{name}.png")).astype(np.int16)
    png_p = read_image(tmp_path / "port" / f"{name}.png").astype(np.int16)
    assert png_p.shape == png_j.shape == (48, 64, 3)
    assert np.abs(png_p - png_j).max() <= 2


@pytest.mark.parametrize("argv,item", [
    (["--spatial", "2"], "item 11"),
    (["--coordinator", "h:1234"], "item 11"),
    (["--num-processes", "2"], "item 11"),
    (["--process-id", "0"], "item 11"),
    (["--shard-data"], "item 11"),
    (["--serve-dp", "2"], "item 11"),
    (["--show"], "OpenCV"),
], ids=lambda v: v if isinstance(v, str) else v[-1] if len(v) < 2 else v[0])
def test_unported_flags_raise_naming_their_item(argv, item):
    """What the port lacks raises naming its ROADMAP item; the flags of
    item 11 (the parallel layer) are ported now, and the check lets them
    through."""
    if item == "item 11":
        cli.check_unported(cli.build_parser().parse_args(["--cpu", *argv]))
        return
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--cpu", *argv])


def test_val_and_train_dispatch(tmp_path, capsys):
    assert cli.main(["-m", "val", "--cpu", "--small", "--iters", "2",
                     "--dataset", "synthetic", "--train-size", "32", "48",
                     "--max-samples", "2", "--out", str(tmp_path)]) == 0
    assert "[val] synthetic" in capsys.readouterr().out
    assert cli.main(["--demo-train", "--cpu", "--num-steps", "1", "--iters",
                     "2", "--batch", "2", "--train-size", "32", "48",
                     "--out", str(tmp_path / "train")]) == 0
    assert (tmp_path / "train" / "checkpoints" / "ckpt_1.npz").exists()


def test_entries_load_a_pth(tmp_path, capsys):
    """Both ``__main__`` entries read a torch checkpoint through the CLI's
    loader: its stem convs turned to BGR unless ``--rgb``."""
    from raft_tpu_torch.serving import __main__ as serving_main
    from raft_tpu_torch.training import __main__ as training_main
    import raft_tpu_torch as rt
    cfg = rt.RAFTConfig.small_model(iters=2)
    src = rt.init_raft_torch(cfg, device="cpu")
    tree = pconv.to_jax_params(src.state_dict())
    pth = tmp_path / "w.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          pconv.to_state_dict(tree).items()}}, pth)
    parser = serving_main.build_parser()
    for rgb in (False, True):
        args = parser.parse_args(["--cpu", "--small", "--iters", "2",
                                  "--load", str(pth)] + (["--rgb"] if rgb else []))
        model = serving_main.load_model(args, serving_main.make_config(args))
        want = pconv.from_jax_params(tree)
        if not rgb:
            for enc in ("fnet", "cnet"):
                w = want[f"{enc}.conv1.weight"]
                want[f"{enc}.conv1.weight"] = w.flip(1)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
    assert "swapped stem convs RGB->BGR" in capsys.readouterr().out
    rc = training_main.main(["--cpu", "--small", "--iters", "2", "--batch", "2",
                             "--train-size", "32", "48", "--num-steps", "1",
                             "--load", str(pth), "--out", str(tmp_path / "t")])
    assert rc == 0 and f"loaded checkpoint from {pth}" in capsys.readouterr().out


def test_parsers_share_the_flag_groups():
    """The serving and training entries take the CLI's flags, defaults
    included: no second copy of a flag."""
    from raft_tpu_torch.serving import __main__ as serving_main
    from raft_tpu_torch.training import __main__ as training_main

    def actions(p):
        return {a.dest: (a.option_strings, a.default) for a in p._actions
                if a.dest != "help"}
    full = actions(cli.build_parser())
    for entry in (serving_main.build_parser(), training_main.build_parser()):
        for dest, (opts, default) in actions(entry).items():
            if dest in ("mode", "dataset"):
                continue
            assert full[dest] == (opts, default), dest
    assert sys.modules["raft_tpu_torch.cli"] is cli
