"""Correlation pyramid and the plain windowed lookup (NHWC).

Semantics (those of the JAX package's ``ops/corr.py``):
``corr[b, q, p] = <fmap1[b, q], fmap2_l[b, p]> / sqrt(C)`` against the
2x2-average-pooled fmap2 of level ``l``, sampled bilinearly on a
``(2r+1)^2`` window centred at ``coords / 2^l`` with zeros outside the map,
channels ordered (level, x-offset, y-offset): the window is
**x-offset-major**.

``corr_impl='dense'`` materialises the volume, as the JAX package does
outside any Pallas kernel: :func:`build_pyramid` correlates fmap1 with
each pooled fmap2 level in one large matrix product per level
(:func:`dense_corr`, 191 MB at level 0 for a 432x1024 frame), then each
iteration samples it with :func:`lookup_dense_onehot`
(``corr_lookup='onehot'``) or :func:`lookup_dense` (``'gather'``).

The plain PyTorch versions of the CUDA lookup kernels (``ops/corr_cuda.py``),
none of which builds the ``(HW)^2`` volume:

* :func:`lookup_blockwise_onehot` (``corr_lookup.cu``): per query chunk and
  level one ``[T, P]`` correlation tile, then the separable one-hot window
  lookup, as two small matmuls;
* :func:`lookup_window_plain` (``corr_lookup.cu``, window entry): the
  same, correlating each chunk only against the rows its windows touch
  (the window schedule);
* :func:`lookup_ragged_plain` (``corr_lookup.cu``, ragged entry):
  mixed-resolution items in one max box (:func:`mask_ragged_rows`,
  :func:`ragged_pyramid`), dead queries exact zeros;
* :func:`lookup_packed_plain` (``corr_lookup.cu``, packed entry,
  ``pallas_pack=True``):
  the TPU's row-packed formulation on the narrow levels (the predicate of
  :func:`packed_levels_from`), the others as above.

``corr_impl='blockwise'`` with ``corr_lookup='gather'`` runs
:func:`lookup_ondemand`: per query chunk and level it gathers each
query's (2r+2)^2 fmap2 feature window and contracts it with the query's
fmap1 vector, a plain gather path with no kernel (slow by design, as in
JAX).  :func:`naive_corr_lookup` samples the dense pyramid point by point
with ``ops/grid_sample.py``: a test oracle only.

Operands may be float32 or bfloat16 (:func:`lookup_operands` rounds them
under ``corr_precision='default'``); every plain version computes in
float32 and returns float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..lint.contracts import contract
from .conv import avg_pool2d

# The TPU's vector lanes: raft_tpu's row-packed kernel lays ``128 // W_l``
# rows of a narrow level side by side to fill them.
LANES = 128


def fmap2_pyramid(fmap2: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """[B, H, W, C] -> ``num_levels`` pooled maps (level 0 = input)."""
    levels = [fmap2]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2d(levels[-1]))
    return levels


def live_mask(sizes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H, W] bool: inside item b's corner-anchored ``sizes[b] = (h, w)``
    crop of an ``H x W`` max box."""
    sizes = sizes.to(torch.int32)
    iy = torch.arange(H, device=sizes.device)[None, :, None]
    ix = torch.arange(W, device=sizes.device)[None, None, :]
    return (iy < sizes[:, 0, None, None]) & (ix < sizes[:, 1, None, None])


def mask_ragged_rows(x: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Zero everything outside each item's live crop of a shared max box.
    x [B, H, W, ...] with every item corner-anchored at (0, 0); sizes
    [B, 2] integer per-item (h, w) live extents.  Dtype-preserving."""
    B, H, W = x.shape[:3]
    live = live_mask(sizes, H, W).reshape((B, H, W) + (1,) * (x.dim() - 3))
    return torch.where(live, x, torch.zeros((), dtype=x.dtype, device=x.device))


def ragged_pyramid(fmap2: torch.Tensor, sizes: torch.Tensor,
                   num_levels: int = 4) -> List[torch.Tensor]:
    """Ragged twin of :func:`fmap2_pyramid` for items in one max box: mask
    level 0 at ``sizes``, then per level pool and mask at the floor-halved
    extents.  At an odd live extent the boundary window mixes a live row
    with a dead one, and that window is exactly the first index the next
    mask kills, so each level equals the crop's own pyramid embedded with
    zeros outside.  Pooling first and masking once would not."""
    sizes = sizes.to(torch.int32)
    levels = [mask_ragged_rows(fmap2, sizes)]
    for _ in range(num_levels - 1):
        sizes = sizes // 2
        levels.append(mask_ragged_rows(avg_pool2d(levels[-1]), sizes))
    return levels


def pack_factor(w2: int) -> int:
    """Rows of width ``w2`` the TPU's row-packed kernel lays side by side:
    ``max(1, 128 // W_l)`` (``raft_tpu/lint/budget.py::corr_level_plan``)."""
    return max(1, LANES // w2)


def packed_levels_from(widths: Sequence[int]) -> int:
    """Index of the first level that ``pallas_pack=True`` runs packed: a
    level packs iff ``128 // W_l >= 2``, i.e. ``W_l <= 64``.  A level pooled
    away to width 0 counts as packed (it gives zeros whichever kernel takes
    it).  Pooling halves the width, so the packed levels are the suffix of
    the pyramid from this index; raises when ``widths`` are not so."""
    packed = [w == 0 or pack_factor(w) >= 2 for w in widths]
    first = packed.index(True) if True in packed else len(widths)
    if not all(packed[first:]):
        raise ValueError(f"level widths {list(widths)}: the packed levels "
                         f"are not a suffix")
    return first


def lookup_operands(fmap1: torch.Tensor, fmap2: torch.Tensor,
                    num_levels: int, corr_precision: str = "highest",
                    sizes8: Optional[torch.Tensor] = None):
    """The lookup's operands, once per forward: fmap1 [B, H, W, C] and the
    ``num_levels`` pyramid of fmap2, pooled in float32 (masked per level for
    a ragged batch at ``sizes8``, see :func:`ragged_pyramid`).  Under
    ``corr_precision='default'`` fmap1 and each pooled level are then
    rounded to bfloat16: the lookup's dot products take bfloat16 operands
    and accumulate in float32, as one bf16 pass of the TPU's matrix unit
    does.  Returns contiguous (f1, levels)."""
    if corr_precision not in ("highest", "default"):
        raise ValueError(f"corr_precision must be 'highest' or 'default', "
                         f"got {corr_precision!r}")
    f1, f2 = fmap1.float(), fmap2.float()
    if sizes8 is None:
        levels = fmap2_pyramid(f2, num_levels)
    else:
        f1 = mask_ragged_rows(f1, sizes8)
        levels = ragged_pyramid(f2, sizes8, num_levels)
    if corr_precision == "default":
        f1, levels = f1.bfloat16(), [lv.bfloat16() for lv in levels]
    return f1.contiguous(), [lv.contiguous() for lv in levels]


def corr_scale(c: int) -> float:
    """``1/sqrt(C)`` rounded to float32, as the JAX package computes it."""
    return float(torch.rsqrt(torch.tensor(float(c), dtype=torch.float32)))


def _onehot_interp(idx0: torch.Tensor, frac: torch.Tensor, n: int, size: int,
                   offset: int = 0) -> torch.Tensor:
    """Separable bilinear selection matrix A [B, Q, n, size]:
    ``A[b,q,j,p] = (1-frac)*[p+offset == idx0+j] + frac*[p+offset == idx0+j+1]``.
    Out-of-range indices never match: zeros padding."""
    dev = idx0.device
    ids = torch.arange(size, device=dev)[None, None, None, :] + offset
    tgt = idx0[:, :, None, None] + torch.arange(n, device=dev)[None, None, :, None]
    f = frac[:, :, None, None]
    zero = torch.zeros((), dtype=frac.dtype, device=dev)
    return (torch.where(ids == tgt, 1.0 - f, zero)
            + torch.where(ids == tgt + 1, f, zero))


@contract(corr3="f32[B,Q,HB,W]", coords="*[B,Q,2]", _returns="f32[B,Q,N]")
def lookup_partial_onehot(corr3: torch.Tensor, coords: torch.Tensor,
                          radius: int, level: int,
                          row_offset: int = 0) -> torch.Tensor:
    """Window lookup on a (possibly row-partial) correlation plane.

    corr3 [B, Q, Hblk, W2] against rows ``[row_offset, row_offset + Hblk)``
    of the level-``level`` plane; coords [B, Q, 2] full-resolution (x, y).
    Returns [B, Q, (2r+1)^2], x-offset-major.
    """
    B, Q, Hblk, W2 = corr3.shape
    n = 2 * radius + 1
    c = coords / (2.0 ** level)
    cx, cy = c[..., 0], c[..., 1]
    cx0 = torch.floor(cx)
    cy0 = torch.floor(cy)
    a_y = _onehot_interp(cy0.long() - radius, cy - cy0, n, Hblk,
                         offset=row_offset)                     # [B,Q,n,Hblk]
    a_x = _onehot_interp(cx0.long() - radius, cx - cx0, n, W2)  # [B,Q,n,W2]
    win_y = torch.matmul(a_y, corr3)                            # [B,Q,n(y),W2]
    win = torch.matmul(a_x, win_y.transpose(-1, -2))            # [B,Q,n(x),n(y)]
    return win.reshape(B, Q, n * n)


@contract(fmap1="*[B,H,W,C]", fmap2_l="*[B,H2,W2,C]",
          _returns="f32[B,Q,H2,W2]")
def dense_corr(fmap1: torch.Tensor, fmap2_l: torch.Tensor) -> torch.Tensor:
    """[B, H1, W1, C] x [B, H2, W2, C] -> [B, H1*W1, H2, W2] float32
    correlation, divided by ``sqrt(C)`` as the JAX package's
    ``dense_corr``; the operands are upcast to float32 first (bfloat16
    ones under ``corr_precision='default'``: exact products, float32
    sums).  A plain matrix product: the caller sets TF32 (off under
    ``compute_dtype='float32'``)."""
    B, H1, W1, C = fmap1.shape
    _, H2, W2, _ = fmap2_l.shape
    f1 = fmap1.reshape(B, H1 * W1, C).float()
    f2 = fmap2_l.reshape(B, H2 * W2, C).float()
    corr = torch.matmul(f1, f2.transpose(1, 2))
    # sqrt(C) in float32, made on the device: a true division, as JAX's
    # (a host scalar is a multiply by its reciprocal on CUDA), and no
    # host-to-device copy, which a CUDA graph capture refuses
    corr = corr / torch.full((), float(C), device=corr.device).sqrt()
    return corr.reshape(B, H1 * W1, H2, W2)


def build_pyramid(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """The dense correlation pyramid of ``corr_impl='dense'``: fmap1
    against each pooled fmap2 level (:func:`lookup_operands` gives both),
    a list of [B, Q, H2/2^l, W2/2^l] float32."""
    return [dense_corr(fmap1, f2) for f2 in f2_levels]


@contract(coords="*[B,H,W,2]", _returns="f32[B,H,W,N]")
def lookup_dense_onehot(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """Sample the dense pyramid at ``coords`` [B, H, W, 2] (x, y) with the
    one-hot matmul lookup, level by level -> [B, H, W, L*(2r+1)^2]."""
    B, H, W, _ = coords.shape
    flat = coords.reshape(B, H * W, 2)
    return torch.cat([lookup_partial_onehot(corr, flat, radius, lvl)
                      for lvl, corr in enumerate(pyramid)],
                     dim=-1).reshape(B, H, W, -1)


def _window_gather_2d(vol: torch.Tensor, ix0: torch.Tensor, iy0: torch.Tensor,
                      win: int) -> torch.Tensor:
    """The aligned integer windows of vol [B, Q, H, W] with top-left corners
    (ix0, iy0) [B, Q], zeros outside -> [B, Q, win(y), win(x)]."""
    B, Q, H, W = vol.shape
    if H == 0 or W == 0:                    # a level pooled away
        return vol.new_zeros((B, Q, win, win))
    offs = torch.arange(win, device=vol.device)
    iy = iy0[..., None] + offs                              # [B, Q, win]
    ix = ix0[..., None] + offs
    zero = torch.zeros((), dtype=vol.dtype, device=vol.device)
    rows = torch.gather(vol, 2, iy.clamp(0, H - 1)[..., None].expand(
        B, Q, win, W))                                      # [B, Q, win, W]
    rows = torch.where(((iy >= 0) & (iy < H))[..., None], rows, zero)
    winv = torch.gather(rows, 3, ix.clamp(0, W - 1)[:, :, None, :].expand(
        B, Q, win, win))                                    # [B, Q, win, win]
    return torch.where(((ix >= 0) & (ix < W))[:, :, None, :], winv, zero)


def _bilinear_window(winv: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """A (2r+2)^2 integer window [B, Q, y, x] and the fractions [B, Q] ->
    the (2r+1)^2 bilinear samples, x-offset-major [B, Q, (2r+1)^2]."""
    n = 2 * radius + 1
    fx, fy = fx[..., None, None], fy[..., None, None]
    out = ((1 - fx) * (1 - fy) * winv[:, :, :n, :n]
           + fx * (1 - fy) * winv[:, :, :n, 1:]
           + (1 - fx) * fy * winv[:, :, 1:, :n]
           + fx * fy * winv[:, :, 1:, 1:])                  # [B, Q, n(y), n(x)]
    return out.transpose(2, 3).reshape(*out.shape[:2], n * n)


@contract(coords="*[B,H,W,2]", _returns="f32[B,H,W,N]")
def lookup_dense(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                 radius: int) -> torch.Tensor:
    """Sample the dense pyramid at ``coords`` [B, H, W, 2] (x, y) with the
    gather lookup (``corr_lookup='gather'``): per level the (2r+2)^2
    integer window of each query, gathered with zeros outside, combined
    by the query's shared fraction -> [B, H, W, L*(2r+1)^2]."""
    B, H, W, _ = coords.shape
    flat = coords.reshape(B, H * W, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        c = flat / (2.0 ** lvl)
        cx0, cy0 = torch.floor(c[..., 0]), torch.floor(c[..., 1])
        winv = _window_gather_2d(corr, cx0.long() - radius,
                                 cy0.long() - radius, 2 * radius + 2)
        outs.append(_bilinear_window(winv, c[..., 0] - cx0, c[..., 1] - cy0,
                                     radius))
    return torch.cat(outs, dim=-1).reshape(B, H, W, -1)


def _level_blockwise(f1: torch.Tensor, f2: torch.Tensor, coords: torch.Tensor,
                     radius: int, level: int, chunk: int) -> torch.Tensor:
    """One level of :func:`lookup_blockwise_onehot`: f1 [B, Q, C] and f2
    [B, H2, W2, C] float32, coords [B, Q, 2] -> [B, Q, (2r+1)^2]."""
    B, Q, C = f1.shape
    _, H2, W2, _ = f2.shape
    scale = corr_scale(C)
    f2t = f2.reshape(B, H2 * W2, C).transpose(1, 2)
    outs = []
    for s in range(0, Q, chunk):
        f1c, cc = f1[:, s:s + chunk], coords[:, s:s + chunk]
        corr = torch.matmul(f1c, f2t)
        outs.append(lookup_partial_onehot(
            (corr * scale).reshape(B, f1c.shape[1], H2, W2), cc, radius, level))
    return torch.cat(outs, dim=1)


@contract(fmap1="*[B,H,W,C]", coords="*[B,H,W,2]", _returns="f32[B,H,W,N]")
def lookup_blockwise_onehot(fmap1: torch.Tensor,
                            f2_levels: Sequence[torch.Tensor],
                            coords: torch.Tensor, radius: int,
                            chunk: int = 512) -> torch.Tensor:
    """fmap1 [B, H, W, C], f2_levels [B, H/2^l, W/2^l, C] (float32 or
    bfloat16), coords [B, H, W, 2] -> [B, H, W, L*(2r+1)^2] float32."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    flat = coords.reshape(B, H * W, 2)
    return torch.cat([_level_blockwise(f1, f2.float(), flat, radius, lvl, chunk)
                      for lvl, f2 in enumerate(f2_levels)],
                     dim=-1).reshape(B, H, W, -1)


def _chunk_rows(iy0: torch.Tensor, n: int, H2: int):
    """The schedule of one query chunk: the rows ``[r0, r1]`` of a level
    with ``H2`` rows that windows starting at rows ``iy0`` touch (a window
    reads rows ``iy0 .. iy0 + n``), or None when they miss the map."""
    lo, hi = int(iy0.min()), int(iy0.max()) + n
    if H2 == 0 or hi < 0 or lo >= H2:
        return None
    return max(lo, 0), min(hi, H2 - 1)


def _window_starts(coords: torch.Tensor, radius: int,
                   level: int) -> torch.Tensor:
    """First window row ``floor(cy / 2^l) - r`` of each query, huge or NaN
    coordinates clamped far outside the map."""
    return (torch.floor(coords[..., 1] / (2.0 ** level)) - radius).nan_to_num(
        1e8).clamp(-1e8, 1e8)


def _level_window(f1: torch.Tensor, f2: torch.Tensor, coords: torch.Tensor,
                  radius: int, level: int, chunk: int) -> torch.Tensor:
    """One level of :func:`lookup_window_plain`, shapes as
    :func:`_level_blockwise`."""
    B, Q, C = f1.shape
    _, H2, W2, _ = f2.shape
    n = 2 * radius + 1
    scale = corr_scale(C)
    out = f1.new_zeros((B, Q, n * n))
    if W2 == 0:
        return out
    iy0 = _window_starts(coords, radius, level)
    for b in range(B):
        for s in range(0, Q, chunk):
            rows = _chunk_rows(iy0[b, s:s + chunk], n, H2)
            if rows is None:
                continue
            r0, r1 = rows
            f1c, cc = f1[b:b + 1, s:s + chunk], coords[b:b + 1, s:s + chunk]
            f2r = f2[b:b + 1, r0:r1 + 1].reshape(1, -1, C)
            corr = torch.matmul(f1c, f2r.transpose(1, 2)) * scale
            out[b:b + 1, s:s + chunk] = lookup_partial_onehot(
                corr.reshape(1, f1c.shape[1], r1 - r0 + 1, W2), cc, radius,
                level, row_offset=r0)
    return out


def lookup_window_plain(fmap1: torch.Tensor,
                        f2_levels: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        chunk: int = 512) -> torch.Tensor:
    """The window-scheduled lookup, shapes and values as
    :func:`lookup_blockwise_onehot`.  Per (item, query chunk, level) the
    schedule is the row range ``[min(iy0), max(iy0) + 2r + 1]`` of the
    chunk's windows (``iy0 = floor(cy / 2^l) - r``) clipped to the map; a
    chunk whose windows miss the map gives zeros, the others correlate
    against those rows only."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    flat = coords.reshape(B, H * W, 2)
    return torch.cat([_level_window(f1, f2.float(), flat, radius, lvl, chunk)
                      for lvl, f2 in enumerate(f2_levels)],
                     dim=-1).reshape(B, H, W, -1)


def _level_packed(f1: torch.Tensor, f2: torch.Tensor, coords: torch.Tensor,
                  radius: int, level: int, p_select: str,
                  chunk: int) -> torch.Tensor:
    """One narrow level in the TPU's row-packed formulation
    (``raft_tpu/ops/corr_pallas.py::_packed_body``), shapes as
    :func:`_level_blockwise`.  ``pack`` rows of width W2 are laid side by
    side as packed rows of width ``pack * W2``; per y tap of each window
    row a one-hot matmul over packed rows, then the parity-aware x taps of
    the packed row (tap (x, y) at ``(y % pack) * W2 + x``) guarded to their
    own sub-row, so windows never wrap into a neighbouring row.  The x
    one-hot has two non-zero weights per output, so it is taken as two
    gathers (the same sum: the one-hot adds exact zeros).  Under
    p_select='window' each chunk correlates only against the packed rows
    its windows touch."""
    B, Q, C = f1.shape
    _, H2, W2, _ = f2.shape
    n = 2 * radius + 1
    out = f1.new_zeros((B, Q, n, n))
    if H2 == 0 or W2 == 0:
        return out.reshape(B, Q, n * n)
    pack = pack_factor(W2)
    n_rows = -(-H2 // pack)
    u = pack * W2
    f2p = F.pad(f2, (0, 0, 0, 0, 0, n_rows * pack - H2)).reshape(B, n_rows, u, C)
    scale = corr_scale(C)
    c = coords / (2.0 ** level)
    cx0, cy0 = torch.floor(c[..., 0]), torch.floor(c[..., 1])
    fx, fy = c[..., 0] - cx0, c[..., 1] - cy0
    iota = torch.arange(n, device=f1.device)
    tx = cx0.long()[..., None] - radius + iota                  # [B, Q, n(x)]
    ty0 = cy0.long()[..., None] - radius + iota                 # [B, Q, n(y)]
    iy0 = _window_starts(coords, radius, level)
    zero = torch.zeros((), dtype=torch.float32, device=f1.device)
    for b in range(B):
        for s in range(0, Q, chunk):
            rows = (0, H2 - 1) if p_select == "all" else _chunk_rows(
                iy0[b, s:s + chunk], n, H2)
            if rows is None:
                continue
            p0, p1 = rows[0] // pack, rows[1] // pack
            sl = (b, slice(s, s + chunk))
            f2r = f2p[b, p0:p1 + 1].reshape(-1, C)
            corr = (torch.matmul(f1[sl], f2r.t()) * scale).reshape(-1, p1 - p0 + 1, u)
            prow_ids = torch.arange(p0, p1 + 1, device=f1.device)
            x_ok0 = ((tx[sl] >= 0) & (tx[sl] < W2))[:, :, None]   # [T, n(x), 1]
            x_ok1 = ((tx[sl] + 1 >= 0) & (tx[sl] + 1 < W2))[:, :, None]
            fx3 = fx[sl][:, None, None]
            for wy, delta in ((1.0 - fy[sl], 0), (fy[sl], 1)):   # the y taps
                ty = ty0[sl] + delta                                # [T, n(y)]
                prow = torch.div(ty, pack, rounding_mode="floor")
                parity = ty - prow * pack                           # in [0, pack)
                a_y = torch.where(prow_ids == prow[..., None],
                                  wy[:, None, None], zero)          # [T, n, rows]
                win_y = torch.matmul(a_y, corr)                     # [T, n(y), u]
                # tap (x, y) of the packed row; an in-row x keeps it in
                # [0, u), an out-of-row one is masked (the sub-row guard)
                u0 = parity[:, None, :] * W2 + tx[sl][:, :, None]  # [T, n(x), n(y)]
                rows = win_y[:, None].expand(-1, n, -1, -1)
                g0 = torch.gather(rows, 3, u0.clamp(0, u - 1)[..., None])[..., 0]
                g1 = torch.gather(rows, 3, (u0 + 1).clamp(0, u - 1)[..., None])[..., 0]
                out[sl] += (torch.where(x_ok0, (1.0 - fx3) * g0, zero)
                            + torch.where(x_ok1, fx3 * g1, zero))   # [T, n(x), n(y)]
    return out.reshape(B, Q, n * n)


def lookup_packed_plain(fmap1: torch.Tensor,
                        f2_levels: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        p_select: str = "all",
                        chunk: int = 512) -> torch.Tensor:
    """The lookup of ``pallas_pack=True``, shapes and values as
    :func:`lookup_blockwise_onehot`: the narrow levels (from
    :func:`packed_levels_from` on) in the row-packed formulation, the wider
    ones as :func:`lookup_blockwise_onehot` (p_select='all') or
    :func:`lookup_window_plain` ('window')."""
    if p_select not in ("all", "window"):
        raise ValueError(f"p_select must be 'all' or 'window', got {p_select!r}")
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    flat = coords.reshape(B, H * W, 2)
    first = packed_levels_from([f2.shape[2] for f2 in f2_levels])
    wide = _level_window if p_select == "window" else _level_blockwise
    outs = []
    for lvl, f2 in enumerate(f2_levels):
        if lvl < first:
            outs.append(wide(f1, f2.float(), flat, radius, lvl, chunk))
        else:
            outs.append(_level_packed(f1, f2.float(), flat, radius, lvl,
                                      p_select, chunk))
    return torch.cat(outs, dim=-1).reshape(B, H, W, -1)


def lookup_ragged_plain(fmap1: torch.Tensor,
                        f2_levels: Sequence[torch.Tensor],
                        coords: torch.Tensor, sizes8: torch.Tensor,
                        radius: int, chunk: int = 512) -> torch.Tensor:
    """The ragged lookup: fmap1 [B, H, W, C] masked by
    :func:`mask_ragged_rows` and f2_levels by :func:`ragged_pyramid` at
    ``sizes8`` [B, 2] (live (h, w) per item at the query grid), coords
    [B, H, W, 2] -> [B, H, W, L*(2r+1)^2].  On each item's live crop the
    values equal the crop's own lookup; dead queries are exact zeros."""
    B, H, W, _ = fmap1.shape
    out = lookup_blockwise_onehot(fmap1, f2_levels, coords, radius, chunk)
    live = live_mask(sizes8.to(out.device), H, W)[..., None]
    return torch.where(live, out, torch.zeros((), device=out.device))


def _gather_feature_windows(fmap: torch.Tensor, ix0: torch.Tensor,
                            iy0: torch.Tensor, win: int) -> torch.Tensor:
    """The ``win x win`` feature windows of fmap [B, H, W, C] with top-left
    corners (ix0, iy0) [B, T], zeros outside -> [B, T, win(y), win(x), C]:
    one flat gather over the H*W plane of exactly the T*win^2 points."""
    B, H, W, C = fmap.shape
    T = ix0.shape[1]
    if H == 0 or W == 0:                    # a level pooled away
        return fmap.new_zeros((B, T, win, win, C))
    offs = torch.arange(win, device=fmap.device)
    iy = iy0[..., None] + offs                              # [B, T, win]
    ix = ix0[..., None] + offs
    valid = (((iy >= 0) & (iy < H))[..., :, None]
             & ((ix >= 0) & (ix < W))[..., None, :])        # [B, T, win, win]
    flat = (iy.clamp(0, H - 1)[..., :, None] * W
            + ix.clamp(0, W - 1)[..., None, :])             # [B, T, win, win]
    pts = torch.gather(fmap.reshape(B, H * W, C), 1,
                       flat.reshape(B, T * win * win, 1).expand(-1, -1, C))
    zero = torch.zeros((), dtype=fmap.dtype, device=fmap.device)
    return torch.where(valid[..., None], pts.reshape(B, T, win, win, C), zero)


def ondemand_chunk(B: int, C: int, radius: int) -> int:
    """Queries per chunk of :func:`lookup_ondemand`: the window buffer
    ``B * chunk * (2r+2)^2 * C`` float32 values held near 8 MB, clipped to
    [32, 1024] and rounded down to a power of 2, as the JAX package sizes
    it."""
    win = 2 * radius + 2
    chunk = max(32, min(1024, 8 * 2 ** 20 // max(1, B * win * win * C * 4)))
    return 1 << (chunk.bit_length() - 1)


@contract(fmap1="*[B,H,W,C]", coords="*[B,H,W,2]", _returns="f32[B,H,W,N]")
def lookup_ondemand(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                    coords: torch.Tensor, radius: int,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """The gather lookup of ``corr_impl='blockwise'``, ``corr_lookup=
    'gather'``: fmap1 [B, H, W, C], f2_levels [B, H/2^l, W/2^l, C] (float32
    or bfloat16), coords [B, H, W, 2] -> [B, H, W, L*(2r+1)^2] float32.
    Per chunk of queries (``chunk``, default :func:`ondemand_chunk`) and
    level, each query's (2r+2)^2 window of fmap2 features is gathered and
    contracted with its fmap1 vector (float32), scaled by ``1/sqrt(C)``
    and combined bilinearly by the query's shared fraction.  No volume is
    built."""
    B, H, W, C = fmap1.shape
    Q = H * W
    win = 2 * radius + 2
    if chunk is None:
        chunk = ondemand_chunk(B, C, radius)
    f1 = fmap1.reshape(B, Q, C).float()
    flat = coords.reshape(B, Q, 2)
    scale = corr_scale(C)
    levels = [f2.float() for f2 in f2_levels]
    outs = []
    for s in range(0, Q, chunk):
        f1c, cc = f1[:, s:s + chunk], flat[:, s:s + chunk]
        per_level = []
        for lvl, f2 in enumerate(levels):
            c = cc / (2.0 ** lvl)
            cx0, cy0 = torch.floor(c[..., 0]), torch.floor(c[..., 1])
            winf = _gather_feature_windows(f2, cx0.long() - radius,
                                           cy0.long() - radius, win)
            winv = torch.einsum("btyxc,btc->btyx", winf, f1c) * scale
            per_level.append(_bilinear_window(winv, c[..., 0] - cx0,
                                              c[..., 1] - cy0, radius))
        outs.append(torch.cat(per_level, dim=-1))
    return torch.cat(outs, dim=1).reshape(B, H, W, -1)


def naive_corr_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      coords: torch.Tensor, num_levels: int,
                      radius: int) -> torch.Tensor:
    """Point-by-point lookup on the dense pyramid, each of the (2r+1)^2
    window points of each query and level sampled with
    ``ops/grid_sample.py`` (zeros padding), x-offset-major: a test oracle
    only.  fmap1, fmap2 [B, H, W, C] float32 -> [B, H, W, L*(2r+1)^2]."""
    from .grid_sample import grid_sample
    B, H, W, C = fmap1.shape
    pyramid = build_pyramid(fmap1, fmap2_pyramid(fmap2, num_levels))
    n = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=fmap1.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (dx, dy)
    outs = []
    for lvl, corr in enumerate(pyramid):
        _, Q, H2, W2 = corr.shape
        vol = corr.reshape(B * Q, H2, W2, 1)
        centroid = coords.reshape(B * Q, 1, 1, 2) / (2.0 ** lvl)
        pts = centroid + delta.reshape(1, n, n, 2)
        outs.append(grid_sample(vol, pts).reshape(B, H, W, n * n))
    return torch.cat(outs, dim=-1)
