"""Correlation window lookups: the CUDA kernels and their dispatch.

Three entries, each with a plain PyTorch version in ``ops/corr.py`` and a
launch counter:

* :func:`corr_lookup_cuda` (``csrc/corr_lookup.cu``) replaces the Pallas
  kernel ``_lookup_level`` with p_select='all' (``_level_kernel`` +
  ``_window_body``, ``raft_tpu/ops/corr_pallas.py:349``), reached through
  :func:`make_fused_lookup`;
* :func:`corr_window_cuda` (``csrc/corr_window.cu``, ``corr_window_f32``)
  replaces ``_lookup_level`` with p_select='window' (``_window_kernel`` and
  ``_window_schedule``, ``corr_pallas.py:342``), reached through
  :func:`make_window_lookup`;
* :func:`corr_ragged_cuda` (``corr_window.cu``, ``corr_ragged_f32``)
  replaces ``_ragged_lookup_level`` (``_ragged_window_kernel`` and
  ``_ragged_schedule``, ``corr_pallas.py:604``), reached through
  :func:`make_ragged_fused_lookup`.

Bound on an H100: at the main-path shape (B=1, a 54x128 query grid,
C=256, 4 levels, radius 4) a call reads about 16.5 MB (f1 7.1, the fmap2
pyramid 9.4) and writes 9.0 MB, and computes at most
6912 * 4 * 100 * 256 * 2 = 1.42 GFLOP of FP32 FMA (fewer where windows
leave the map), so operations bound it: about 21 us at the 67 TFLOP/s
FP32 rate.  The same holds for the other two entries; the ragged one
counts only the live queries' in-crop positions.

Why the designs differ from the TPU kernels: the TPU kernels computed full
``[T, P]`` correlation tiles of a query block against fmap2 row blocks (all
of them, or those its schedule names) so that the matrix unit did the
work and no gather was needed.  On Hopper a gather is cheap.
``corr_lookup.cu`` computes the correlation only at the ``(2r+2)^2``
integer positions around each window: one warp per (query, level), the
query's features in registers, a shuffle reduction per position, f2 read
from global memory per query.  ``corr_window.cu`` gives an 8x8 tile of
neighbouring queries one CTA, computes the tile's window box (the
schedule) on the device and stages that f2 box through shared memory, so
the tile's overlapping windows share each read; for a ragged item the box
is clipped to its live crop and dead queries are written as zeros without
reading f2.  Where a tile's windows are incoherent (flows of hundreds of
pixels in all directions) the box would be mostly waste, and that CTA
computes its windows as ``corr_lookup.cu`` does.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, never another kernel or the plain version.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .corr import (corr_scale, fmap2_pyramid, lookup_blockwise_onehot,
                   lookup_ragged_plain, lookup_window_plain, mask_ragged_rows,
                   ragged_pyramid)

SOURCE = "corr_lookup.cu"
WINDOW_SOURCE = "corr_window.cu"
MAX_LEVELS = 8
MAX_RADIUS = 15
MAX_WINDOW_RADIUS = 7
MAX_CHANNELS = 512

_LOOKUP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]


def _fn(source: str, name: str, argtypes: list):
    from .. import _build
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


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
                  radius: int, max_radius: int) -> List[int]:
    """Validate the arguments every lookup entry shares; returns the
    levels' (h, w) pairs, flattened."""
    dev = fmap1.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} needs CUDA tensors, got {dev}")
    _check("fmap1", fmap1, dev, 4)
    _check("coords", coords, dev, 4)
    B, H, W, C = fmap1.shape
    if tuple(coords.shape) != (B, H, W, 2):
        raise ValueError(f"coords shape {tuple(coords.shape)} != {(B, H, W, 2)}")
    L = len(f2_levels)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {L}")
    if not 0 <= radius <= max_radius:
        raise ValueError(f"radius must be in 0..{max_radius}, got {radius}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"C must be in 1..{MAX_CHANNELS}, got {C}")
    hw = []
    for i, f2 in enumerate(f2_levels):
        _check(f"f2_levels[{i}]", f2, dev, 4)
        if f2.shape[0] != B or f2.shape[3] != C:
            raise ValueError(f"f2_levels[{i}] shape {tuple(f2.shape)} does "
                             f"not match fmap1 {tuple(fmap1.shape)}")
        hw += [f2.shape[1], f2.shape[2]]
    return hw


def _level_args(f2_levels: Sequence[torch.Tensor], hw: List[int]) -> Tuple:
    L = len(f2_levels)
    return ((ctypes.c_void_p * L)(*[f2.data_ptr() for f2 in f2_levels]),
            (ctypes.c_int * (2 * L))(*hw))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def corr_lookup_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the CUDA lookup: fmap1 [B,H,W,C], f2_levels [B,H_l,W_l,C],
    coords [B,H,W,2], all float32 contiguous on one CUDA device ->
    [B,H,W,L*(2r+1)^2]."""
    hw = _check_lookup("corr_lookup_cuda", fmap1, f2_levels, coords, radius,
                       MAX_RADIUS)
    B, H, W, C = fmap1.shape
    L, n, dev = len(f2_levels), 2 * radius + 1, fmap1.device
    out = torch.empty((B, H, W, L * n * n), dtype=torch.float32, device=dev)
    if B * H * W == 0:
        return out
    fn = _fn(SOURCE, "corr_lookup_f32", _LOOKUP_ARGS + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p])
    ptrs, dims = _level_args(f2_levels, hw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), ptrs,
                 dims, L, B, H * W, C, radius, corr_scale(C), stream)
    _raise_on(err, "corr_lookup_f32")
    corr_lookup_cuda.launches += 1
    return out


corr_lookup_cuda.launches = 0      # kernel launches; callers that count reset it


def _check_window(entry: str, fmap1, f2_levels, coords, radius) -> List[int]:
    """As :func:`_check_lookup`; the kernel also copies 16-byte vectors of
    channels, so C is a multiple of 4 and the feature maps 16-byte
    aligned."""
    hw = _check_lookup(entry, fmap1, f2_levels, coords, radius,
                       MAX_WINDOW_RADIUS)
    if fmap1.shape[3] % 4:
        raise ValueError(f"{entry} needs C a multiple of 4, got {fmap1.shape[3]}")
    for t in (fmap1, *f2_levels):
        if t.data_ptr() % 16:
            raise ValueError(f"{entry} needs 16-byte aligned feature maps")
    return hw


def corr_window_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the window-scheduled CUDA lookup (``corr_window_f32``).
    Shapes and values as :func:`corr_lookup_cuda`; C a multiple of 4,
    radius at most 7."""
    hw = _check_window("corr_window_cuda", fmap1, f2_levels, coords, radius)
    B, H, W, C = fmap1.shape
    L, n, dev = len(f2_levels), 2 * radius + 1, fmap1.device
    out = torch.empty((B, H, W, L * n * n), dtype=torch.float32, device=dev)
    if B * H * W == 0:
        return out
    fn = _fn(WINDOW_SOURCE, "corr_window_f32", _LOOKUP_ARGS + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    ptrs, dims = _level_args(f2_levels, hw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), ptrs,
                 dims, L, B, H, W, C, radius, corr_scale(C), stream)
    _raise_on(err, "corr_window_f32")
    corr_window_cuda.launches += 1
    return out


corr_window_cuda.launches = 0


def corr_ragged_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, sizes8: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """Launch the ragged CUDA lookup (``corr_ragged_f32``): fmap1
    [B,H,W,C] masked by ``mask_ragged_rows`` and f2_levels by
    ``ragged_pyramid`` at ``sizes8`` [B,2] int32 (each item's live (h, w)
    on the query grid, on the same device), coords [B,H,W,2] ->
    [B,H,W,L*(2r+1)^2], dead queries exact zeros.  C a multiple of 4,
    radius at most 7."""
    hw = _check_window("corr_ragged_cuda", fmap1, f2_levels, coords, radius)
    B, H, W, C = fmap1.shape
    _check("sizes8", sizes8, fmap1.device, 2, torch.int32)
    if tuple(sizes8.shape) != (B, 2):
        raise ValueError(f"sizes8 shape {tuple(sizes8.shape)} != {(B, 2)}")
    L, n, dev = len(f2_levels), 2 * radius + 1, fmap1.device
    out = torch.empty((B, H, W, L * n * n), dtype=torch.float32, device=dev)
    if B * H * W == 0:
        return out
    fn = _fn(WINDOW_SOURCE, "corr_ragged_f32", _LOOKUP_ARGS + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p])
    ptrs, dims = _level_args(f2_levels, hw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), ptrs,
                 dims, sizes8.data_ptr(), L, B, H, W, C, radius,
                 corr_scale(C), stream)
    _raise_on(err, "corr_ragged_f32")
    corr_ragged_cuda.launches += 1
    return out


corr_ragged_cuda.launches = 0


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


def ragged_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                  coords: torch.Tensor, sizes8: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """The ragged lookup of ``corr_impl='pallas'``: :func:`corr_ragged_cuda`
    on CUDA tensors, :func:`lookup_ragged_plain` on CPU tensors."""
    _supported(fmap1)
    return _Lookup.apply(lookup_ragged_plain, corr_ragged_cuda, radius,
                         fmap1, coords, sizes8, *f2_levels)


def make_fused_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      num_levels: int, radius: int):
    """Pool the fmap2 pyramid once and return the per-iteration closure
    ``lookup(coords) -> [B, H, W, L*(2r+1)^2]`` (NHWC float32 inputs)."""
    f1 = fmap1.float().contiguous()
    levels = [lv.contiguous() for lv in fmap2_pyramid(fmap2.float(), num_levels)]

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        return fused_lookup(f1, levels, coords.contiguous(), radius)

    return lookup


def make_window_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int, radius: int):
    """As :func:`make_fused_lookup`, each iteration running the
    window-scheduled lookup.  The TPU tiling knobs ``pallas_q_blk`` and
    ``pallas_p_blk`` set the Pallas kernel's query and row blocks; the CUDA
    kernel has its own fixed tiling, so they change no value here."""
    f1 = fmap1.float().contiguous()
    levels = [lv.contiguous() for lv in fmap2_pyramid(fmap2.float(), num_levels)]

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        return window_lookup(f1, levels, coords.contiguous(), radius)

    return lookup


def make_ragged_fused_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                             sizes8: torch.Tensor, num_levels: int,
                             radius: int):
    """Ragged twin of :func:`make_fused_lookup` for items sharing one max
    box: masks fmap1 and builds the masked pyramid once (``sizes8`` [B, 2]
    live (h, w) per item on the query grid), then each iteration runs the
    ragged lookup.  As in :func:`make_window_lookup`, the TPU tiling knobs
    change no value."""
    sizes8 = sizes8.to(device=fmap1.device, dtype=torch.int32).contiguous()
    f1 = mask_ragged_rows(fmap1.float(), sizes8).contiguous()
    levels = [lv.contiguous()
              for lv in ragged_pyramid(fmap2.float(), sizes8, num_levels)]

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        return ragged_lookup(f1, levels, coords.contiguous(), sizes8, radius)

    return lookup
