"""Correlation window lookup: the CUDA kernel and its dispatch.

Replaces ``raft_tpu/ops/corr_pallas.py::fused_lookup`` / ``make_fused_lookup``
(the Pallas kernel ``_lookup_level`` with ``_level_kernel`` +
``_window_body``, p_select='all').  Kernel source: ``csrc/corr_lookup.cu``.

Bound on an H100: at the main-path shape (B=1, a 54x128 query grid,
C=256, 4 levels, radius 4) a call reads about 16.5 MB (f1 7.1, the fmap2
pyramid 9.4) and writes 9.0 MB, and computes at most
6912 * 4 * 100 * 256 * 2 = 1.42 GFLOP of FP32 FMA (fewer where windows
leave the map), so operations bound it: about 21 us at the 67 TFLOP/s
FP32 rate.

Why the design differs from the TPU kernel: the TPU kernel computed the
full ``[T, P]`` correlation tile of each query block against every fmap2
row block (about 32 GFLOP per call here) so that the matrix unit did the
work and no gather was needed.  On Hopper a gather is cheap, so the
kernel computes the correlation only at the ``(2r+2)^2`` integer positions
around each window — one warp per (query, level), the query's features in
registers, a shuffle reduction per position — and skips positions outside
the map.

On a CPU tensor the wrapper runs the plain version
(:func:`raft_tpu_torch.ops.corr.lookup_blockwise_onehot`); on a CUDA tensor
it launches the kernel or raises.  ``corr_lookup_cuda.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .corr import corr_scale, fmap2_pyramid, lookup_blockwise_onehot

SOURCE = "corr_lookup.cu"
MAX_LEVELS = 8
MAX_RADIUS = 15
MAX_CHANNELS = 512


def _lib():
    from .. import _build
    lib = _build.load(SOURCE)
    fn = lib.corr_lookup_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def corr_lookup_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the CUDA lookup: fmap1 [B,H,W,C], f2_levels [B,H_l,W_l,C],
    coords [B,H,W,2], all float32 contiguous on one CUDA device ->
    [B,H,W,L*(2r+1)^2]."""
    dev = fmap1.device
    if dev.type != "cuda":
        raise ValueError(f"corr_lookup_cuda needs CUDA tensors, got {dev}")
    _check("fmap1", fmap1, dev, 4)
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
        _check(f"f2_levels[{i}]", f2, dev, 4)
        if f2.shape[0] != B or f2.shape[3] != C:
            raise ValueError(f"f2_levels[{i}] shape {tuple(f2.shape)} does "
                             f"not match fmap1 {tuple(fmap1.shape)}")
        hw += [f2.shape[1], f2.shape[2]]
    n = 2 * radius + 1
    out = torch.empty((B, H, W, L * n * n), dtype=torch.float32, device=dev)
    if B * H * W == 0:
        return out
    fn = _lib()
    ptrs = (ctypes.c_void_p * L)(*[f2.data_ptr() for f2 in f2_levels])
    dims = (ctypes.c_int * (2 * L))(*hw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(), ptrs,
                 dims, L, B, H * W, C, radius, corr_scale(C), stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup_f32 launch failed: cudaError_t {err}")
    corr_lookup_cuda.launches += 1
    return out


corr_lookup_cuda.launches = 0      # kernel launches; callers that count reset it


class _CorrLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, fmap1, coords, *f2_levels):
        if fmap1.device.type == "cpu":
            return lookup_blockwise_onehot(fmap1, f2_levels, coords, radius)
        return corr_lookup_cuda(fmap1, f2_levels, coords, radius)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the correlation lookup has no backward yet: training is "
            "ROADMAP Queue A item 7")


def fused_lookup(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                 coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup of ``corr_impl='pallas'``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors.  Shapes as
    :func:`corr_lookup_cuda`; returns [B, H, W, L*(2r+1)^2]."""
    if fmap1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fmap1.device}")
    return _CorrLookup.apply(radius, fmap1, coords, *f2_levels)


def make_fused_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      num_levels: int, radius: int):
    """Pool the fmap2 pyramid once and return the per-iteration closure
    ``lookup(coords) -> [B, H, W, L*(2r+1)^2]`` (NHWC float32 inputs)."""
    f1 = fmap1.float().contiguous()
    levels = [lv.contiguous() for lv in fmap2_pyramid(fmap2.float(), num_levels)]

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        return fused_lookup(f1, levels, coords.contiguous(), radius)

    return lookup
