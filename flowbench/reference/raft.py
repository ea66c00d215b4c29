"""Plain float32 RAFT, written from the published architecture.

Teed and Deng, "RAFT: Recurrent All-Pairs Field Transforms for Optical
Flow" (ECCV 2020), and the official ``core/`` of princeton-vl/RAFT:
``extractor.py`` (BasicEncoder, SmallEncoder), ``update.py``
(BasicUpdateBlock, SmallUpdateBlock), ``corr.py`` (CorrBlock) and
``raft.py`` (the iterations and the upsampling).  The variant is chosen
by the configuration's ``small`` key, as ``args.small`` chooses it there.

Everything is a function of a state dict (name -> tensor) with the
official module names, NCHW throughout, one ``F.conv2d`` per published
convolution.  No hoisting, no fusion, no kernel: the GRU convolves the
whole ``[h, context, motion]`` input in every iteration, the correlation
volume is the all-pairs product pooled level by level, and each lookup
samples the volume bilinearly with zeros outside it.  This module imports
torch alone; the TF32 switches are the caller's (``run.precision``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5              # the norms' epsilon (nn.InstanceNorm2d, nn.BatchNorm2d)
MASK_SCALE = 0.25       # BasicUpdateBlock: 0.25 * mask, "scale mask to balance gradients"

State = Dict[str, torch.Tensor]


# -- the architecture's parameter list ---------------------------------------

def dims(cfg: dict) -> dict:
    """The published sizes of a configuration (``core/raft.py``)."""
    small = bool(cfg["small"])
    return {
        "small": small,
        "hidden": cfg["hidden_dim"], "context": cfg["context_dim"],
        "levels": cfg["corr_levels"], "radius": cfg["corr_radius"],
        "fnet": 128 if small else 256,
        "stem": 32 if small else 64,
        "stages": (32, 64, 96) if small else (64, 96, 128),
    }


def _conv_shapes(prefix: str, k, c_in: int, c_out: int):
    kh, kw = (k, k) if isinstance(k, int) else k
    return [(f"{prefix}.weight", (c_out, c_in, kh, kw)),
            (f"{prefix}.bias", (c_out,))]


def _norm_shapes(prefix: str, kind: str, c: int):
    if kind != "batch":
        return []
    return [(f"{prefix}.{n}", (c,)) for n in
            ("weight", "bias", "running_mean", "running_var")]


def _encoder_shapes(name: str, d: dict, out: int, norm: str):
    shapes = _conv_shapes(f"{name}.conv1", 7, 3, d["stem"])
    shapes += _norm_shapes(f"{name}.norm1", norm, d["stem"])
    c_in = d["stem"]
    for li, (c, stride) in enumerate(zip(d["stages"], (1, 2, 2)), start=1):
        for bi in range(2):
            p = f"{name}.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            cin = c_in if bi == 0 else c
            if d["small"]:
                mid = c // 4
                shapes += _conv_shapes(f"{p}.conv1", 1, cin, mid)
                shapes += _conv_shapes(f"{p}.conv2", 3, mid, mid)
                shapes += _conv_shapes(f"{p}.conv3", 1, mid, c)
                for n, cc in (("norm1", mid), ("norm2", mid), ("norm3", c)):
                    shapes += _norm_shapes(f"{p}.{n}", norm, cc)
            else:
                shapes += _conv_shapes(f"{p}.conv1", 3, cin, c)
                shapes += _conv_shapes(f"{p}.conv2", 3, c, c)
                for n in ("norm1", "norm2"):
                    shapes += _norm_shapes(f"{p}.{n}", norm, c)
            if s != 1:
                shapes += _conv_shapes(f"{p}.downsample.0", 1, cin, c)
                shapes += _norm_shapes(f"{p}.downsample.1", norm, c)
        c_in = c
    return shapes + _conv_shapes(f"{name}.conv2", 1, c_in, out)


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every tensor of the model, (name, shape), in a fixed order: the
    official module names (fnet, cnet, update_block)."""
    d = dims(cfg)
    hid, ctx = d["hidden"], d["context"]
    corr = d["levels"] * (2 * d["radius"] + 1) ** 2
    u = "update_block"
    shapes = _encoder_shapes("fnet", d, d["fnet"], "instance")
    shapes += _encoder_shapes("cnet", d, hid + ctx,
                              "none" if d["small"] else "batch")
    if d["small"]:
        shapes += _conv_shapes(f"{u}.encoder.convc1", 1, corr, 96)
        shapes += _conv_shapes(f"{u}.encoder.convf1", 7, 2, 64)
        shapes += _conv_shapes(f"{u}.encoder.convf2", 3, 64, 32)
        shapes += _conv_shapes(f"{u}.encoder.conv", 3, 128, 80)
        hx = hid + ctx + 82
        for g in ("convz", "convr", "convq"):
            shapes += _conv_shapes(f"{u}.gru.{g}", 3, hx, hid)
        shapes += _conv_shapes(f"{u}.flow_head.conv1", 3, hid, 128)
        shapes += _conv_shapes(f"{u}.flow_head.conv2", 3, 128, 2)
        return shapes
    shapes += _conv_shapes(f"{u}.encoder.convc1", 1, corr, 256)
    shapes += _conv_shapes(f"{u}.encoder.convc2", 3, 256, 192)
    shapes += _conv_shapes(f"{u}.encoder.convf1", 7, 2, 128)
    shapes += _conv_shapes(f"{u}.encoder.convf2", 3, 128, 64)
    shapes += _conv_shapes(f"{u}.encoder.conv", 3, 256, 126)
    hx = hid + ctx + 128
    for s, k in (("1", (1, 5)), ("2", (5, 1))):
        for g in ("convz", "convr", "convq"):
            shapes += _conv_shapes(f"{u}.gru.{g}{s}", k, hx, hid)
    shapes += _conv_shapes(f"{u}.flow_head.conv1", 3, hid, 256)
    shapes += _conv_shapes(f"{u}.flow_head.conv2", 3, 256, 2)
    shapes += _conv_shapes(f"{u}.mask.0", 3, hid, 256)
    shapes += _conv_shapes(f"{u}.mask.2", 1, 256, 64 * 9)
    return shapes


# -- layers --------------------------------------------------------------------

def conv(sd: State, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = sd[name + ".weight"]
    return F.conv2d(x, w, sd[name + ".bias"], stride=stride,
                    padding=(w.shape[2] // 2, w.shape[3] // 2))


def norm(sd: State, name: str, kind: str, x: torch.Tensor,
         train: bool) -> torch.Tensor:
    if kind == "instance":
        return F.instance_norm(x, eps=EPS)
    if kind == "none":
        return x
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    if train:          # the batch's statistics; running ones are not read
        return F.batch_norm(x, None, None, w, b, training=True, eps=EPS)
    return F.batch_norm(x, sd[name + ".running_mean"],
                        sd[name + ".running_var"], w, b, training=False,
                        eps=EPS)


def encoder(sd: State, name: str, d: dict, kind: str, x: torch.Tensor,
            train: bool) -> torch.Tensor:
    """BasicEncoder (residual blocks) or SmallEncoder (bottleneck blocks):
    [N, 3, H, W] -> [N, out, H/8, W/8]."""
    y = F.relu(norm(sd, f"{name}.norm1", kind, conv(sd, f"{name}.conv1", x, 2),
                    train))
    for li, stride in enumerate((1, 2, 2), start=1):
        for bi in range(2):
            p = f"{name}.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            if d["small"]:
                z = F.relu(norm(sd, f"{p}.norm1", kind, conv(sd, f"{p}.conv1", y),
                                train))
                z = F.relu(norm(sd, f"{p}.norm2", kind,
                                conv(sd, f"{p}.conv2", z, s), train))
                z = F.relu(norm(sd, f"{p}.norm3", kind, conv(sd, f"{p}.conv3", z),
                                train))
            else:
                z = F.relu(norm(sd, f"{p}.norm1", kind,
                                conv(sd, f"{p}.conv1", y, s), train))
                z = F.relu(norm(sd, f"{p}.norm2", kind, conv(sd, f"{p}.conv2", z),
                                train))
            if s != 1:
                y = norm(sd, f"{p}.downsample.1", kind,
                         conv(sd, f"{p}.downsample.0", y, s), train)
            y = F.relu(y + z)
    return conv(sd, f"{name}.conv2", y)


# -- correlation ----------------------------------------------------------------

def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 levels: int) -> List[torch.Tensor]:
    """CorrBlock: the all-pairs volume <f1(q), f2(p)> / sqrt(C) as
    [B, Q, h, w], then 2x2 average pooling per level (floor on odd sizes)."""
    B, C, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(B, C, h * w).transpose(1, 2),
                        fmap2.reshape(B, C, h * w)) / math.sqrt(C)
    pyramid = [corr.reshape(B, h * w, h, w)]
    for _ in range(levels - 1):
        top = pyramid[-1]
        if min(top.shape[2:]) < 2:          # pooled away: an empty level
            pyramid.append(top[:, :, :top.shape[2] // 2, :top.shape[3] // 2])
        else:
            pyramid.append(F.avg_pool2d(top, 2, stride=2))
    return pyramid


def _sample(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of vol [B, Q, H, W] at (x, y) [B, Q, K] in pixels,
    zeros outside (``grid_sample(align_corners=True)``, zeros padding)."""
    B, Q, H, W = vol.shape
    if H == 0 or W == 0:
        return x.new_zeros(x.shape)
    flat = vol.reshape(B, Q, H * W)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = (x0 + dx).long(), (y0 + dy).long()
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        val = torch.gather(flat, 2, idx)
        out = out + wgt * torch.where(inside, val, torch.zeros_like(val))
    return out


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """The (2r+1)^2 window of every level at coords [B, 2, h, w] (x, y),
    centred at coords / 2^l: [B, L (2r+1)^2, h, w], each level's window
    x-offset-major (CorrBlock's ``meshgrid(dy, dx)`` added to (x, y))."""
    B, _, h, w = coords.shape
    n = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    dx = d[:, None].expand(n, n).reshape(1, 1, n * n)     # x-offset-major
    dy = d[None, :].expand(n, n).reshape(1, 1, n * n)
    c = coords.permute(0, 2, 3, 1).reshape(B, h * w, 1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        cl = c / 2 ** lvl
        x = cl[..., 0] + dx
        y = cl[..., 1] + dy
        out.append(_sample(vol, x, y))
    return torch.cat(out, dim=2).permute(0, 2, 1).reshape(B, -1, h, w)


# -- the update block -------------------------------------------------------------

def _gru_pass(sd: State, p: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One ConvGRU gate pass; ``p`` names the gates' convs with '#' for
    convz, convr and convq."""
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv(sd, p.replace("#", "convz"), hx))
    r = torch.sigmoid(conv(sd, p.replace("#", "convr"), hx))
    q = torch.tanh(conv(sd, p.replace("#", "convq"),
                        torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


def update_block(sd: State, d: dict, net: torch.Tensor, inp: torch.Tensor,
                 corr: torch.Tensor, flow: torch.Tensor):
    """BasicUpdateBlock / SmallUpdateBlock: (net, mask or None, delta)."""
    u = "update_block"
    e = f"{u}.encoder"
    if d["small"]:
        cor = F.relu(conv(sd, f"{e}.convc1", corr))
    else:
        cor = F.relu(conv(sd, f"{e}.convc2",
                          F.relu(conv(sd, f"{e}.convc1", corr))))
    flo = F.relu(conv(sd, f"{e}.convf2", F.relu(conv(sd, f"{e}.convf1", flow))))
    motion = torch.cat([F.relu(conv(sd, f"{e}.conv",
                                    torch.cat([cor, flo], dim=1))), flow], dim=1)
    x = torch.cat([inp, motion], dim=1)
    if d["small"]:
        net = _gru_pass(sd, f"{u}.gru.#", net, x)
    else:
        net = _gru_pass(sd, f"{u}.gru.#1", net, x)      # (1, 5): horizontal
        net = _gru_pass(sd, f"{u}.gru.#2", net, x)      # (5, 1): vertical
    delta = conv(sd, f"{u}.flow_head.conv2",
                 F.relu(conv(sd, f"{u}.flow_head.conv1", net)))
    if d["small"]:
        return net, None, delta
    mask = MASK_SCALE * conv(sd, f"{u}.mask.2",
                             F.relu(conv(sd, f"{u}.mask.0", net)))
    return net, mask, delta


# -- upsampling -----------------------------------------------------------------

def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 2, h, w] -> [B, 2, 8h, 8w]: softmax over the 3x3 taps of the
    mask [B, 9*64, h, w], each output a convex mix of 8 * flow's taps."""
    B, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(B, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(B, 2, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * h, 8 * w)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """raft-small: bilinear (align corners) by 8, the values scaled by 8."""
    _, _, h, w = flow.shape
    return 8 * F.interpolate(flow, size=(8 * h, 8 * w), mode="bilinear",
                             align_corners=True)


# -- the model ----------------------------------------------------------------------

def forward(sd: State, cfg: dict, image1: torch.Tensor, image2: torch.Tensor,
            iters: int, train: bool = False, all_flows: bool = False,
            coords_out: Optional[list] = None):
    """RAFT on images [B, H, W, 3] in [0, 1] (H, W multiples of 8).  Returns
    the final flow [B, H, W, 2], or with ``all_flows`` every iteration's
    [iters, B, H, W, 2].  ``train``: the context encoder's batch norm on
    the batch's statistics.  ``coords_out``: each iteration's lookup
    coordinates [B, 2, h, w] are appended to it."""
    d = dims(cfg)
    x1 = 2 * image1.permute(0, 3, 1, 2) - 1
    x2 = 2 * image2.permute(0, 3, 1, 2) - 1
    B = x1.shape[0]
    fmaps = encoder(sd, "fnet", d, "instance", torch.cat([x1, x2]), train)
    fmap1, fmap2 = fmaps[:B], fmaps[B:]
    cnet = encoder(sd, "cnet", d, "none" if d["small"] else "batch", x1, train)
    net = torch.tanh(cnet[:, :d["hidden"]])
    inp = F.relu(cnet[:, d["hidden"]:])
    pyramid = corr_pyramid(fmap1, fmap2, d["levels"])
    _, _, h, w = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=x1.dtype,
                                         device=x1.device),
                            torch.arange(w, dtype=x1.dtype,
                                         device=x1.device), indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(B, 2, h, w)
    coords1 = coords0
    flows, mask = [], None
    for _ in range(iters):
        coords1 = coords1.detach()
        if coords_out is not None:
            coords_out.append(coords1)
        corr = corr_lookup(pyramid, coords1, d["radius"])
        net, mask, delta = update_block(sd, d, net, inp, corr,
                                        coords1 - coords0)
        coords1 = coords1 + delta
        if all_flows:
            flows.append(_upsample(coords1 - coords0, mask))
    if all_flows:
        return torch.stack(flows).permute(0, 1, 3, 4, 2)
    return _upsample(coords1 - coords0, mask).permute(0, 2, 3, 1)


def _upsample(flow: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return upflow8(flow) if mask is None else convex_upsample(flow, mask)

