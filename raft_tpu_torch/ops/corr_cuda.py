"""Correlation window lookups: the CUDA kernels and their dispatch.

Four kernels, each with a plain PyTorch version in ``ops/corr.py`` and a
launch counter:

* :func:`corr_lookup_cuda` (``csrc/corr_lookup.cu``, ``corr_lookup_*``)
  replaces the Pallas kernel ``_lookup_level`` with p_select='all'
  (``_level_kernel`` + ``_window_body``,
  ``raft_tpu/ops/corr_pallas.py:349``), reached through
  :func:`make_fused_lookup`;
* :func:`corr_ragged_cuda` (``corr_lookup.cu``, ``corr_ragged_*``)
  replaces ``_ragged_lookup_level`` (``_ragged_window_kernel`` and
  ``_ragged_schedule``, ``corr_pallas.py:604``), reached through
  :func:`make_ragged_fused_lookup`;
* :func:`corr_packed_cuda` (``corr_lookup.cu``, ``corr_packed_*``)
  replaces ``_packed_body`` (``corr_pallas.py:125``), the body both
  ``pallas_call`` of ``_lookup_level`` run under ``pallas_pack=True`` for
  the narrow levels (``W_l <= 64``,
  :func:`~raft_tpu_torch.ops.corr.packed_levels_from`), reached through
  ``make_fused_lookup(pack=True)`` and ``make_window_lookup(pack=True)``:
  one launch over every level;
* :func:`corr_window_cuda` (``corr_lookup.cu``, ``corr_window_*``)
  replaces ``_lookup_level`` with p_select='window' (``_window_kernel`` and
  ``_window_schedule``, ``corr_pallas.py:342``), reached through
  :func:`make_window_lookup`.

Each kernel has a float32 and a bfloat16 entry, picked by the dtype of
``fmap1`` (the f2 levels must share it): bfloat16 operands are what
``corr_precision='default'`` gives (``ops/corr.py::lookup_operands``);
arithmetic and output stay float32.

Bound on an H100: at the main-path shape (B=1, a 54x128 query grid,
C=256, 4 levels, radius 4) a call reads about 16.5 MB (f1 7.1, the fmap2
pyramid 9.4) and writes 9.0 MB, and its dot products are at most
6912 * 4 * 100 * 256 * 2 = 1.42 GFLOP (fewer where windows leave the map).
A product is priced at the card's fastest rate for its accuracy: float32 x
float32 as 3xTF32 on the tensor cores (165 TFLOP/s), bfloat16 x bfloat16
as one BF16 MMA (989); so the bytes bound every entry, about 7.6 us in
float32 and 5 us in bfloat16 (the ragged entry counts its live queries'
in-crop positions only).

Why the designs differ from the TPU kernels: the TPU kernels computed full
``[T, P]`` correlation tiles of a query block against fmap2 row blocks (all
of them, or those its schedule names) so that the matrix unit did the
work and no gather was needed.  The four kernels of ``corr_lookup.cu``
share one tile body that keeps that tile where it pays and gathers where
it does not: an 8x8 tile of neighbouring queries per CTA computes the box
its windows cover (for a ragged item, clipped to its live crop at the
level; dead queries are exact zeros and read nothing); a coherent tile
(box at most :data:`MMA_RATIO` times its queries' in-region window
positions) forms ``F1_tile . F2_box^T`` on the tensor cores (``mma.sync``;
3xTF32 for float32 operands, one BF16 MMA for bfloat16, so every product
keeps float32 accuracy) and keeps each query's window entries; an
incoherent one (random-weight flows of hundreds of pixels) gathers each
query's window, lanes reading 16-byte vectors of channels and reducing a
group of positions at once.  The TPU packs the rows of a narrow level
side by side to fill its 128 lanes; the H100 has no lanes to fill, and
what packing bought, one matrix tile over a narrow level, is a small box
here: the packed entries run the first lookup's kernel as it is, every
level on the 8x8 tile, and compute its values under either p_select.
What the TPU's window schedule selects, the f2 row blocks a query block's
windows touch, is each tile's window box here: the window entries run the
first lookup's kernel as it is too, and give its values bit for bit.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, never another kernel or the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .corr import (lookup_blockwise_onehot, lookup_operands,
                   lookup_packed_plain, lookup_ragged_plain,
                   lookup_window_plain, corr_scale)

SOURCE = "corr_lookup.cu"
MAX_LEVELS = 8
MAX_RADIUS = 15
MAX_CHANNELS = 512
# corr_lookup.cu's entries: a tile takes the MMA path when its window box
# holds at most this many times its queries' in-region window positions, by
# operand dtype (set by measurement: chip_smoke.py phase 7, PERF.md)
MMA_RATIO = {torch.float32: 0.0625, torch.bfloat16: 0.25}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_LOOKUP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]


def _fn(source: str, name: str, argtypes: list):
    from .. import _build
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _entry(stem: str, t: torch.Tensor) -> str:
    """The C entry of ``stem`` for the operand dtype of ``t``."""
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{stem} takes float32 or bfloat16 operands, got "
                         f"{t.dtype}")
    return f"{stem}_{_SUFFIX[t.dtype]}"


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lookup(entry: str, fmap1: torch.Tensor,
                  f2_levels: Sequence[torch.Tensor], coords: torch.Tensor,
                  radius: int) -> List[int]:
    """Validate the arguments every lookup entry shares: fmap1 and the f2
    levels float32 or bfloat16 (one dtype), coords float32; returns the
    levels' (h, w) pairs, flattened."""
    dev = fmap1.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} needs CUDA tensors, got {dev}")
    _entry(entry, fmap1)
    _check("fmap1", fmap1, dev, 4, fmap1.dtype)
    _check("coords", coords, dev, 4)
    B, H, W, C = fmap1.shape
    if tuple(coords.shape) != (B, H, W, 2):
        raise ValueError(f"coords shape {tuple(coords.shape)} != {(B, H, W, 2)}")
    L = len(f2_levels)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {L}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in 0..{MAX_RADIUS}, got {radius}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"C must be in 1..{MAX_CHANNELS}, got {C}")
    hw = []
    for i, f2 in enumerate(f2_levels):
        _check(f"f2_levels[{i}]", f2, dev, 4, fmap1.dtype)
        if f2.shape[0] != B or f2.shape[3] != C:
            raise ValueError(f"f2_levels[{i}] shape {tuple(f2.shape)} does "
                             f"not match fmap1 {tuple(fmap1.shape)}")
        hw += [f2.shape[1], f2.shape[2]]
    return hw


def _output(fmap1: torch.Tensor, L: int, radius: int) -> torch.Tensor:
    """The [B, H, W, L*(2r+1)^2] float32 output."""
    B, H, W, _ = fmap1.shape
    return torch.empty((B, H, W, L * (2 * radius + 1) ** 2),
                       dtype=torch.float32, device=fmap1.device)


def _level_args(f2_levels: Sequence[torch.Tensor], hw: List[int]) -> Tuple:
    L = len(f2_levels)
    return ((ctypes.c_void_p * L)(*[f2.data_ptr() for f2 in f2_levels]),
            (ctypes.c_int * (2 * L))(*hw))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _launch_tiled(wrapper, stem: str, fmap1: torch.Tensor,
                  f2_levels: Sequence[torch.Tensor], coords: torch.Tensor,
                  radius: int, mma_ratio: Optional[float],
                  stats: Optional[torch.Tensor],
                  lead: Tuple = ()) -> torch.Tensor:
    """Validate and launch one of ``corr_lookup.cu``'s entries, called as
    ``(f1, coords, out, f2_ptrs, level_hw, *lead, L, B, H, W, C, radius,
    scale, mma_ratio, stats, stream)`` (``lead``: pointers), adding one to
    ``wrapper.launches`` where it launches (once at a graph's capture, not
    at its replays).  It reads shapes only: no host sync, so it can be
    captured."""
    hw = _check_lookup(stem, fmap1, f2_levels, coords, radius)
    B, H, W, C = fmap1.shape
    L = len(f2_levels)
    ratio = MMA_RATIO[fmap1.dtype] if mma_ratio is None else float(mma_ratio)
    if not ratio >= 0:
        raise ValueError(f"mma_ratio must be >= 0, got {mma_ratio}")
    if stats is not None:
        _check("stats", stats, fmap1.device, 1, torch.int32)
        if stats.numel() != 2 * L:
            raise ValueError(f"stats must hold 2 * {L} counts, got "
                             f"{stats.numel()}")
    out = _output(fmap1, L, radius)
    if B * H * W == 0:
        return out
    name = _entry(stem, fmap1)
    fn = _fn(SOURCE, name, _LOOKUP_ARGS + [ctypes.c_void_p] * len(lead)
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_void_p])
    ptrs, dims = _level_args(f2_levels, hw)
    with torch.cuda.device(fmap1.device):
        err = fn(fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), ptrs,
                 dims, *lead, L, B, H, W, C, radius, corr_scale(C),
                 min(ratio, 3e38), None if stats is None else stats.data_ptr(),
                 _stream(fmap1.device))
    _raise_on(err, name)
    wrapper.launches += 1
    return out


def corr_lookup_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int,
                     mma_ratio: Optional[float] = None,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA lookup (``corr_lookup_f32`` / ``_bf16``): fmap1
    [B,H,W,C] and f2_levels [B,H_l,W_l,C] float32 or bfloat16, coords
    [B,H,W,2] float32, all contiguous on one CUDA device ->
    [B,H,W,L*(2r+1)^2] float32.  A tile takes the MMA path when its window
    box holds at most ``mma_ratio`` (None: :data:`MMA_RATIO` of the
    operands' dtype) times its queries' in-map window positions:
    ``float('inf')`` sends every tile the MMA path can take there, 0 every
    tile to the gather (for measurement; the values are the same).
    ``stats``: None, or an int32 CUDA tensor of 2 per level, (MMA,
    gather) for each level in turn, to which each launch adds its tiles of
    each path."""
    return _launch_tiled(corr_lookup_cuda, "corr_lookup", fmap1, f2_levels,
                         coords, radius, mma_ratio, stats)


# kernel launches issued from Python (each entry's counter; callers that
# count reset it).  A captured CUDA graph (models/capture.py) counts at
# capture, not at replay.
corr_lookup_cuda.launches = 0


def corr_window_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int,
                     mma_ratio: Optional[float] = None,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the window-scheduled lookup (``corr_window_f32`` / ``_bf16``):
    the kernel of :func:`corr_lookup_cuda`, each tile reading only its
    windows' box (what ``_window_schedule`` selects), under a launch
    counter of its own.  Arguments and values as :func:`corr_lookup_cuda`."""
    return _launch_tiled(corr_window_cuda, "corr_window", fmap1, f2_levels,
                         coords, radius, mma_ratio, stats)


corr_window_cuda.launches = 0


def corr_ragged_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, sizes8: torch.Tensor,
                     radius: int, mma_ratio: Optional[float] = None,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the ragged CUDA lookup (``corr_ragged_f32`` / ``_bf16``):
    fmap1 [B,H,W,C] masked by ``mask_ragged_rows`` and f2_levels by
    ``ragged_pyramid`` at ``sizes8`` [B,2] int32 (each item's live (h, w)
    on the query grid, on the same device), coords [B,H,W,2] ->
    [B,H,W,L*(2r+1)^2] float32, dead queries exact zeros.  Each window is
    clipped to its item's live crop at the level (what the masked pyramid
    holds there); operands, ``mma_ratio`` and ``stats`` as
    :func:`corr_lookup_cuda`."""
    _check("sizes8", sizes8, fmap1.device, 2, torch.int32)
    if tuple(sizes8.shape) != (fmap1.shape[0], 2):
        raise ValueError(f"sizes8 shape {tuple(sizes8.shape)} != "
                         f"{(fmap1.shape[0], 2)}")
    return _launch_tiled(corr_ragged_cuda, "corr_ragged", fmap1, f2_levels,
                         coords, radius, mma_ratio, stats,
                         lead=(sizes8.data_ptr(),))


corr_ragged_cuda.launches = 0


def corr_packed_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int,
                     p_select: str = "all", mma_ratio: Optional[float] = None,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the lookup of ``pallas_pack=True`` (``corr_packed_f32`` /
    ``_bf16``), one launch over every level, the narrow levels that
    ``pallas_pack`` packs (from ``packed_levels_from`` on) as the others:
    the kernel of :func:`corr_lookup_cuda`, under a launch counter of its
    own.  'all' and 'window' take the same route (each tile's box is its
    windows' box, what 'window' schedules); the values are those of
    :func:`corr_lookup_cuda` whatever the p_select.  Other arguments as
    :func:`corr_lookup_cuda`."""
    if p_select not in ("all", "window"):
        raise ValueError(f"p_select must be 'all' or 'window', got {p_select!r}")
    return _launch_tiled(corr_packed_cuda, "corr_packed", fmap1, f2_levels,
                         coords, radius, mma_ratio, stats)


corr_packed_cuda.launches = 0


class _Lookup(torch.autograd.Function):
    """``plain`` on CPU tensors, ``kernel`` on CUDA tensors, both called as
    ``fn(fmap1, f2_levels, coords, [sizes8,] radius)``.  The f2 levels are
    separate arguments so that autograd sees them."""

    @staticmethod
    def forward(ctx, plain, kernel, radius, fmap1, coords, sizes8, *f2_levels):
        fn = plain if fmap1.device.type == "cpu" else kernel
        extra = () if sizes8 is None else (sizes8,)
        return fn(fmap1, list(f2_levels), coords, *extra, radius)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the correlation lookups have no backward yet: training is "
            "ROADMAP Queue A item 7")


def _supported(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def fused_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                 coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup of ``corr_impl='pallas'``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors.  Shapes as
    :func:`corr_lookup_cuda`; returns [B, H, W, L*(2r+1)^2]."""
    _supported(fmap1)
    return _Lookup.apply(lookup_blockwise_onehot, corr_lookup_cuda, radius,
                         fmap1, coords, None, *f2_levels)


def window_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                  coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup of ``pallas_p_select='window'``: :func:`corr_window_cuda`
    on CUDA tensors, :func:`lookup_window_plain` on CPU tensors."""
    _supported(fmap1)
    return _Lookup.apply(lookup_window_plain, corr_window_cuda, radius,
                         fmap1, coords, None, *f2_levels)


def packed_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                  coords: torch.Tensor, radius: int,
                  p_select: str = "all") -> torch.Tensor:
    """The lookup of ``pallas_pack=True``: :func:`corr_packed_cuda` on
    CUDA tensors, :func:`lookup_packed_plain` on CPU tensors."""
    _supported(fmap1)
    return _Lookup.apply(
        functools.partial(lookup_packed_plain, p_select=p_select),
        functools.partial(corr_packed_cuda, p_select=p_select), radius,
        fmap1, coords, None, *f2_levels)


def ragged_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                  coords: torch.Tensor, sizes8: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """The ragged lookup of ``corr_impl='pallas'``: :func:`corr_ragged_cuda`
    on CUDA tensors, :func:`lookup_ragged_plain` on CPU tensors."""
    _supported(fmap1)
    return _Lookup.apply(lookup_ragged_plain, corr_ragged_cuda, radius,
                         fmap1, coords, sizes8, *f2_levels)


def make_fused_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      num_levels: int, radius: int, pack: bool = False,
                      corr_precision: str = "highest"):
    """Pool the fmap2 pyramid once (``lookup_operands``: bfloat16 operands
    under ``corr_precision='default'``) and return the per-iteration
    closure ``lookup(coords) -> [B, H, W, L*(2r+1)^2]`` float32 (NHWC
    inputs); ``pack=True`` is ``pallas_pack=True``."""
    f1, levels = lookup_operands(fmap1, fmap2, num_levels, corr_precision)

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        if pack:
            return packed_lookup(f1, levels, coords.contiguous(), radius, "all")
        return fused_lookup(f1, levels, coords.contiguous(), radius)

    return lookup


def make_window_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int, radius: int, pack: bool = False,
                       corr_precision: str = "highest"):
    """As :func:`make_fused_lookup`, each iteration running the
    window-scheduled lookup.  The TPU tiling knobs ``pallas_q_blk`` and
    ``pallas_p_blk`` set the Pallas kernel's query and row blocks; the CUDA
    kernels have their own fixed tiling, so they change no value here."""
    f1, levels = lookup_operands(fmap1, fmap2, num_levels, corr_precision)

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        if pack:
            return packed_lookup(f1, levels, coords.contiguous(), radius,
                                 "window")
        return window_lookup(f1, levels, coords.contiguous(), radius)

    return lookup


def make_ragged_fused_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                             sizes8: torch.Tensor, num_levels: int,
                             radius: int, corr_precision: str = "highest"):
    """Ragged twin of :func:`make_fused_lookup` for items sharing one max
    box: masks fmap1 and builds the masked pyramid once (``sizes8`` [B, 2]
    live (h, w) per item on the query grid), then each iteration runs the
    ragged lookup.  As in :func:`make_window_lookup`, the TPU tiling knobs
    change no value; ``pallas_pack`` does not apply (as in the JAX
    package, row packing does not compose with per-item pages)."""
    sizes8 = sizes8.to(device=fmap1.device, dtype=torch.int32).contiguous()
    f1, levels = lookup_operands(fmap1, fmap2, num_levels, corr_precision,
                                 sizes8)

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        return ragged_lookup(f1, levels, coords.contiguous(), sizes8, radius)

    return lookup
