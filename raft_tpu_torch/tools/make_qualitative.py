"""The qualitative flow panel from a checkpoint:
``python -m raft_tpu_torch.tools.make_qualitative``.

The port of the JAX package's ``tools/make_qualitative.py``: frame 1 |
ground-truth flow | predicted flow | |error| heat, one row per held-out
synthetic sample (the split ``-m val --dataset synthetic`` scores: seed
9001).  The flows share one color-wheel normalization
(``utils/flow_viz.py``); the error is mapped through an inferno ramp on
the ground truth's largest magnitude.  The PNG is written with the port's
own codec (``imageio.py``) and decoded back, which must give the panel bit
for bit.  The port has no OpenCV, so the column titles the JAX tool draws
into the tiles go into the JSON line instead, with each sample's EPE.

The checkpoint is ``--ckpt`` (any format the CLI's ``--load`` reads), or
``--demo-steps N`` trains raft-small for N steps on the synthetic stage
first (the port's seeded demo train, ``training/loop.py``) and uses the
checkpoint it writes.  On the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from ._common import card, default_out, resolve_device

#: The inferno colormap at 9 evenly spaced stops (RGB), linearly
#: interpolated: the error heat's ramp.
_INFERNO = np.array([
    [0, 0, 4], [31, 12, 72], [85, 15, 109], [136, 34, 106],
    [186, 54, 85], [227, 89, 51], [249, 140, 10], [249, 201, 50],
    [252, 255, 164]], np.float64)

TITLES = ("frame 1", "ground truth", "prediction", "|error|")


def inferno_bgr(x: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> [H, W, 3] uint8 BGR on the inferno ramp."""
    t = x.astype(np.float64) / 255.0 * (len(_INFERNO) - 1)
    i = np.minimum(t.astype(np.int64), len(_INFERNO) - 2)
    f = (t - i)[..., None]
    rgb = _INFERNO[i] * (1 - f) + _INFERNO[i + 1] * f
    return np.round(rgb[..., ::-1]).astype(np.uint8)


def model_config(full: bool, iters: int):
    from ..config import RAFTConfig
    if full:
        return RAFTConfig.full(iters=iters, corr_impl="pallas",
                               gru_impl="pallas")
    return RAFTConfig.small_model(iters=iters, corr_impl="pallas",
                                  gru_impl="xla")


def load_model(path, config, device):
    """The model holding checkpoint ``path``'s weights, on ``device``."""
    from ..cli import load_state_dict
    from ..models.raft import RAFT, compute_dtype
    model = RAFT(config)
    model.load_state_dict(load_state_dict(path, False), strict=True)
    return model.to(device, compute_dtype(config)).eval()


def panel_flows(model, config, size, samples: int, device):
    """[(im1, flow_gt, prediction)] for the first ``samples`` held-out
    synthetic samples (seed 9001) at ``size``, each predicted alone."""
    from ..data.synthetic import SyntheticFlowDataset
    from ..models.raft import make_inference_fn
    ds = SyntheticFlowDataset(size=tuple(size), length=64, seed=9001)
    fn = make_inference_fn(config, device=device)
    out = []
    for idx in range(samples):
        im1, im2, flow_gt, _valid = ds[idx]
        pred = fn(model, im1[None], im2[None])[0].float().cpu().numpy()
        out.append((im1, flow_gt, pred))
    return out


def render_panel(rows):
    """The panel (uint8 BGR) and each row's EPE from ``panel_flows``."""
    from ..utils.flow_viz import flow_to_color
    tiles, epes = [], []
    for im1, flow_gt, pred in rows:
        err = np.linalg.norm(pred - flow_gt, axis=-1)
        epes.append(float(err.mean()))
        clip = float(np.linalg.norm(flow_gt, axis=-1).max())
        both = flow_to_color(np.concatenate([flow_gt, pred], axis=0),
                             convert_to_bgr=True)
        gt_c, pr_c = both[:flow_gt.shape[0]], both[flow_gt.shape[0]:]
        err_c = inferno_bgr(np.clip(err / max(clip, 1e-6) * 255, 0, 255)
                            .astype(np.uint8))
        frame = (im1 * 255).astype(np.uint8)[:, :, ::-1]
        tiles.append(np.concatenate([frame, gt_c, pr_c, err_c], axis=1))
    sep = np.full((4, tiles[0].shape[1], 3), 32, np.uint8)
    panel = tiles[0]
    for r in tiles[1:]:
        panel = np.concatenate([panel, sep, r], axis=0)
    return np.ascontiguousarray(panel), epes


def demo_checkpoint(out_dir: Path, steps: int, size, iters: int, device):
    """Train raft-small ``steps`` steps on the synthetic stage (seeded, the
    port's training loop) and return the checkpoint it writes."""
    from ..config import TrainConfig
    from ..data.synthetic import SyntheticFlowDataset
    from ..training.checkpoint import latest_checkpoint
    from ..training.loop import train

    config = model_config(False, iters)
    tconf = TrainConfig.for_stage("synthetic", num_steps=steps,
                                  image_size=tuple(size), ckpt_every=steps,
                                  log_every=max(1, steps // 4))
    ds = SyntheticFlowDataset(size=tuple(size), length=512, seed=0)

    def batches():
        rng = np.random.RandomState(0)
        while True:
            s = [ds[j] for j in rng.randint(0, len(ds), tconf.batch_size)]
            yield tuple(np.stack([x[k] for x in s]) for k in range(4))

    shutil.rmtree(out_dir, ignore_errors=True)    # never resume a stale run
    train(config, tconf, batches(), ckpt_dir=str(out_dir),
          log_fn=lambda m: None, device=device)
    path = latest_checkpoint(out_dir)
    if path is None:
        raise RuntimeError(f"the demo train wrote no checkpoint in {out_dir}")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.make_qualitative",
        description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="checkpoint to render")
    src.add_argument("--demo-steps", type=int, metavar="N",
                     help="train raft-small N steps first and render its "
                          "checkpoint")
    ap.add_argument("--out", default=default_out("qualitative.png"))
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="a raft-things checkpoint (default: raft-small)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--train-size", type=int, nargs=2, default=None,
                    help="the demo train's crop (default: --size)")
    ap.add_argument("--demo-dir", default=None,
                    help="the demo train's checkpoint directory (default: a "
                         "new temporary directory)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.size[0] % 8 or args.size[1] % 8:
        print(f"ERROR: --size must be multiples of 8, got "
              f"{tuple(args.size)}")
        return 2
    if args.demo_steps is not None and args.full:
        print("ERROR: the demo train trains raft-small (drop --full)")
        return 2
    dev = resolve_device(args.cpu)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ckpt = args.ckpt
    if ckpt is None:
        demo_dir = Path(args.demo_dir or tempfile.mkdtemp(
            prefix="raft_demo_train_"))
        ckpt = demo_checkpoint(demo_dir, args.demo_steps,
                               args.train_size or args.size, args.iters, dev)
    config = model_config(args.full, args.iters)
    try:
        model = load_model(ckpt, config, dev)
    except (RuntimeError, ValueError) as e:
        hint = "drop --full" if args.full else "pass --full"
        print(f"ERROR: checkpoint does not fit the model ({e}); {hint}?")
        return 2
    rows = panel_flows(model, config, args.size, args.samples, dev)
    panel, epes = render_panel(rows)
    from ..imageio import decode_png, encode_png
    data = encode_png(panel)
    out.write_bytes(data)
    back = decode_png(out.read_bytes(), name=str(out))
    roundtrip = bool(np.array_equal(back, panel))
    rec = {"png": str(out), "ckpt": str(ckpt), "device": str(dev),
           "card": card(dev), "size": list(panel.shape[:2]),
           "columns": list(TITLES), "epe": epes,
           "panel_sha256": hashlib.sha256(panel.tobytes()).hexdigest(),
           "png_roundtrip_bitwise": roundtrip}
    print(json.dumps(rec))
    if not roundtrip:
        print("ERROR: the PNG does not decode back to the panel",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
