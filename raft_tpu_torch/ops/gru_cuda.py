"""One SepConvGRU iteration: the CUDA kernel, its plain version, dispatch.

Replaces ``raft_tpu/ops/gru_pallas.py::sep_conv_gru_pallas`` (the Pallas
kernel ``_pallas_gru`` / ``_gru_kernel``).  Kernel source:
``csrc/sep_conv_gru.cu``.

Bound on an H100: at the main-path shape (B=1, a 54x128 grid, hidden,
motion and context 128) a call computes 1.97 MFLOP per pixel, about
13.6 GFLOP of FP32, and moves about 36 MB (h, motion and the six context
terms in, h out, the weights), so operations bound it: about 0.20 ms at
the 67 TFLOP/s FP32 rate.

Why the design differs from the TPU kernel: the TPU kernel held a row
block plus a 4-row recompute halo in VMEM and ran both passes in one
program, each tap a matmul on the matrix unit.  On Hopper each gate conv
is an implicit GEMM (pixels x output channels x 5 taps * input channels)
tiled through shared memory, with the gate nonlinearities and the blend as
its epilogue; the two passes are four launches, so no halo is recomputed.

On a CPU tensor the wrapper runs the plain version
(:func:`sep_conv_gru_plain`); on a CUDA tensor it launches the kernel or
raises.  ``sep_conv_gru_cuda.launches`` counts kernel launches (four per
call).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import to_nchw, to_nhwc

SOURCE = "sep_conv_gru.cu"
LAUNCHES_PER_CALL = 4
_WEIGHTS = ("wzr1", "wqh1", "wqm1", "wzr2", "wqh2", "wqm2")


def fuse_gru_weights(gru: nn.Module, hidden: int, ctx_dim: int
                     ) -> Dict[str, torch.Tensor]:
    """Tap-major gate weights with the context input-channel block removed
    (the JAX package's ``fuse_gru_weights``), from the ``convz1`` ..
    ``convq2`` convs of ``gru``.  For each pass ``s`` (1 = 1x5, 2 = 5x1):

    * ``wzr{s}`` [5, hidden+motion, 2*hidden]: z and r fused on the output;
    * ``wqh{s}`` [5, hidden, hidden]: the q gate's ``r*h`` columns;
    * ``wqm{s}`` [5, motion, hidden]: the q gate's motion columns.

    The hx channel layout is [h, inp, motion]; the inp block (columns
    ``[hidden, hidden+ctx_dim)``) is dropped.  Biases are not included:
    they ride the hoisted context terms.  Float32, contiguous.
    """
    lo, hi = hidden, hidden + ctx_dim
    out = {}
    for s in ("1", "2"):
        def taps(name: str, s=s) -> torch.Tensor:
            w = getattr(gru, name + s).weight            # [Cout, Cin, kh, kw]
            w = w[:, :, 0, :] if s == "1" else w[:, :, :, 0]
            return w.permute(2, 1, 0)                    # [5, Cin, Cout]

        def loop_cols(w: torch.Tensor) -> torch.Tensor:
            return torch.cat([w[:, :lo], w[:, hi:]], dim=1)

        wq = taps("convq")
        out["wzr" + s] = torch.cat([loop_cols(taps("convz")),
                                    loop_cols(taps("convr"))], dim=2)
        out["wqh" + s] = wq[:, :lo]
        out["wqm" + s] = wq[:, hi:]
    return {k: v.detach().float().contiguous() for k, v in out.items()}


def sep_conv_gru_plain(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                       motion: torch.Tensor,
                       ctx: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The kernel's computation in plain PyTorch (the JAX package's
    ``sep_conv_gru_xla``): h [B,H,W,hidden], motion [B,H,W,M], ctx the two
    hoisted context terms [B,H,W,3*hidden] (z | r | q, biases included) of
    the 1x5 and the 5x1 pass.  Float32 compute; output in h's dtype."""
    hidden = h.shape[-1]
    hf = to_nchw(h.float())
    mot = to_nchw(motion.float())
    for s, cs in (("1", ctx[0]), ("2", ctx[1])):
        c = to_nchw(cs.float())

        def conv(x, w, s=s):
            w = w.permute(2, 1, 0)                        # [Cout, Cin, 5]
            if s == "1":
                return F.conv2d(x, w[:, :, None, :], padding=(0, 2))
            return F.conv2d(x, w[:, :, :, None], padding=(2, 0))

        zr = conv(torch.cat([hf, mot], dim=1), fw["wzr" + s])
        z = torch.sigmoid(zr[:, :hidden] + c[:, :hidden])
        r = torch.sigmoid(zr[:, hidden:] + c[:, hidden:2 * hidden])
        q = torch.tanh(conv(r * hf, fw["wqh" + s]) + conv(mot, fw["wqm" + s])
                       + c[:, 2 * hidden:])
        hf = (1.0 - z) * hf + z * q
    return to_nhwc(hf).contiguous().to(h.dtype)


def _lib():
    from .. import _build
    lib = _build.load(SOURCE)
    fn = lib.sep_conv_gru_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sep_conv_gru_cuda(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                      motion: torch.Tensor,
                      ctx: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Launch the CUDA kernel (four launches).  Every tensor float32,
    contiguous, 16-byte aligned, on h's CUDA device; hidden a multiple of
    64 and motion a multiple of 16."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"sep_conv_gru_cuda needs CUDA tensors, got {dev}")
    B, H, W, hid = h.shape
    mot = motion.shape[-1]
    if hid % 64 or mot % 16 or hid == 0 or mot == 0:
        raise ValueError(f"the kernel needs hidden % 64 == 0 and motion % 16 "
                         f"== 0, got hidden={hid}, motion={mot}")
    want = {"h": (B, H, W, hid), "motion": (B, H, W, mot),
            "ctx1": (B, H, W, 3 * hid), "ctx2": (B, H, W, 3 * hid),
            "wzr1": (5, hid + mot, 2 * hid), "wzr2": (5, hid + mot, 2 * hid),
            "wqh1": (5, hid, hid), "wqh2": (5, hid, hid),
            "wqm1": (5, mot, hid), "wqm2": (5, mot, hid)}
    tensors = {"h": h, "motion": motion, "ctx1": ctx[0], "ctx2": ctx[1],
               **{k: fw[k] for k in _WEIGHTS}}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scratch = torch.empty((3, B, H, W, hid), dtype=torch.float32, device=dev)
    out = torch.empty_like(h)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(h.data_ptr(), motion.data_ptr(), ctx[0].data_ptr(),
                 ctx[1].data_ptr(), *[fw[k].data_ptr() for k in _WEIGHTS],
                 scratch[0].data_ptr(), scratch[1].data_ptr(),
                 scratch[2].data_ptr(), out.data_ptr(), B, H, W, hid, mot,
                 stream)
    if err != 0:
        raise RuntimeError(f"sep_conv_gru_f32 launch failed: cudaError_t {err}")
    sep_conv_gru_cuda.launches += LAUNCHES_PER_CALL
    return out


sep_conv_gru_cuda.launches = 0      # kernel launches; callers that count reset it


class _SepConvGRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, h, motion, c1, c2, *weights):
        fw = dict(zip(_WEIGHTS, weights))
        if h.device.type == "cpu":
            return sep_conv_gru_plain(fw, h, motion, (c1, c2))
        return sep_conv_gru_cuda(fw, h, motion, (c1, c2))

    @staticmethod
    def backward(ctx_, grad):
        raise NotImplementedError(
            "the SepConvGRU kernel has no backward yet: training is ROADMAP "
            "Queue A item 7")


def sep_conv_gru(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                 motion: torch.Tensor,
                 ctx: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One SepConvGRU iteration of ``gru_impl='pallas'``: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors.  Arguments as
    :func:`sep_conv_gru_plain`."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")
    return _SepConvGRU.apply(h, motion, ctx[0], ctx[1],
                             *[fw[k] for k in _WEIGHTS])
