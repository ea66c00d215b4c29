"""One SepConvGRU iteration: the CUDA kernel, its plain version, dispatch.

Replaces ``raft_tpu/ops/gru_pallas.py::sep_conv_gru_pallas`` (the Pallas
kernel ``_pallas_gru`` / ``_gru_kernel``).  Kernel source:
``csrc/sep_conv_gru.cu``.

Bound on an H100: at the main-path shape (B=1, a 54x128 grid, hidden,
motion and context 128) a call computes 1.97 MFLOP of products per pixel,
about 13.6 GFLOP, and moves about 36 MB (h, motion and the six context
terms in, h out, the weights), so the products bound it, priced at the
card's rate for their accuracy: float32 x float32 as 3xTF32 on the tensor
cores (165 TFLOP/s), about 0.083 ms; with bfloat16 I/O two thirds of the
products take two bfloat16 operands (989 TFLOP/s) and the rest a float32
activation (r*h, h1) and a bfloat16 weight (three bfloat16 pieces, 330),
about 0.023 ms.

Design: each gate conv is an implicit GEMM (pixels x output channels x 5
taps * input channels) on the tensor cores (``mma.sync``), fed through a
3-stage ``cp.async`` ring; a CTA stages its pixels plus a 2-pixel halo
along the pass's axis once per slab of channels and runs the 5 taps from
it; the gate nonlinearities and the blend are the epilogues; four launches
per iteration.  The TPU kernel held a row block plus a 4-row recompute halo
in VMEM and ran both passes in one program; here the passes are separate
launches, so no halo is recomputed.  Every product keeps float32 accuracy
(``csrc/tensor_core.cuh``): the float32 entry splits activations and
weights into tf32 hi + lo (3 MMAs per product), the bfloat16 entry runs a
bfloat16 activation in one BF16 MMA and a float32 one in three bfloat16
pieces.  The kernel reads its weights as :func:`prepare_gru_weights` lays
them out, once per forward (``models/raft.py::prepare_loop``).

I/O in the activations' dtype, as the TPU kernel's: float32
(``sep_conv_gru_f32``) or, under ``compute_dtype='bfloat16'``, bfloat16
(``sep_conv_gru_bf16``: bfloat16 h, motion and context terms in, bfloat16
h out, bfloat16 weights); the accumulation and the scratch (z, r*h, and
h1 between the two passes) are float32, so only the final h is rounded.

On a CPU tensor the wrapper runs the plain version
(:func:`sep_conv_gru_plain`); on a CUDA tensor it launches the kernel or
raises.  ``sep_conv_gru_cuda.launches`` counts kernel launches (four per
call).  The model reaches both through the operator
``torch.ops.raft_tpu_torch.sep_conv_gru`` (``torch.library``):
its CPU implementation is the plain version, its CUDA one the kernel (or a
raise); its fake implementation gives h's shape and dtype, so
``torch.export`` traces it as one node; its FLOP formula counts the gate
convs' products, ``30*hidden*(hidden+motion)`` multiply-adds a pixel at 2
FLOPs each (:func:`gru_flops`, from the fused weights' shapes).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.flop_counter import register_flop_formula

from ..lint.contracts import contract
from . import spmd
from .conv import conv_nchw, to_nchw, to_nhwc
from ..telemetry.trace import stage
from .corr_cuda import LIB

SOURCE = "sep_conv_gru.cu"
# the rows a row slab is widened by for the kernel (the JAX package's
# lint/budget.py GRU_HALO): the 5x1 pass's two taps, twice (q reads r*h1,
# r reads h1)
GRU_HALO = 4
LAUNCHES_PER_CALL = 4
# the profiler range of the backward twin (what a profile of a training
# step reads its device time by)
TWIN_STAGE = "gru/twin_bwd"
_WEIGHTS = ("wzr1", "wqh1", "wqm1", "wzr2", "wqh2", "wqm2")
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
    they ride the hoisted context terms.  Float32, contiguous, and
    differentiable: a training forward's gradient reaches the convs'
    weights through them.
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
    return {k: v.float().contiguous() for k, v in out.items()}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to tf32: to nearest, ties away from zero, on
    the bits, as the kernels round their activations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (float32) as the kernels split their activations
    (``csrc/tensor_core.cuh::split_tf32``): hi = tf32(x), lo = tf32(x - hi);
    a NaN or infinite x leaves lo a NaN (rounding on the bits would carry
    CUDA's NaN, 0x7fffffff, into the sign and give -0, as the kernels'
    cvt.rna does not)."""
    hi = _tf32(x)
    rest = x - hi
    return hi, torch.where(torch.isnan(rest), rest, _tf32(rest))


def prepare_gru_weights(fw: Dict[str, torch.Tensor], dtype: torch.dtype
                        ) -> Dict[str, torch.Tensor]:
    """The fused weights of :func:`fuse_gru_weights` as the kernel's entry
    for activations of ``dtype`` reads them; once per forward.  Each
    ``[5, Cin, N]`` weight is cut into slabs of channels (one MMA k-step per
    tap) and laid out ``[5, slab, N, quad thread t, 4]`` in the order of the
    MMA fragments:

    * float32: slabs of 8 channels; (hi[2t], hi[2t+1], lo[2t], lo[2t+1]),
      the 3xTF32 split of :func:`_split_tf32`, float32;
    * bfloat16: slabs of 16 channels; channels 4t..4t+3, bfloat16.  The
      weights must be bfloat16-exact: bfloat16 weights are by type; float32
      ones are checked on the host (a sync) and raise otherwise.
    """
    if dtype not in _SUFFIX:
        raise ValueError(f"the kernel takes float32 or bfloat16 activations, "
                         f"got {dtype}")
    out = {}
    for k in _WEIGHTS:
        src = fw[k].detach()
        w = src.float()
        taps, cin, n = w.shape
        if dtype == torch.float32:
            hi, lo = _split_tf32(w)

            def slabs(x):                                 # [5, S, N, t, 2]
                return x.reshape(taps, cin // 8, 4, 2, n).permute(0, 1, 4, 2, 3)
            out[k] = torch.cat([slabs(hi), slabs(lo)], dim=-1).contiguous()
        else:
            wb = w.to(torch.bfloat16)
            if src.dtype != torch.bfloat16 and not torch.equal(wb.float(), w):
                raise ValueError(f"{k}: the bfloat16 entry needs bfloat16-"
                                 f"exact weights")
            out[k] = wb.reshape(taps, cin // 16, 4, 4, n).permute(
                0, 1, 4, 2, 3).contiguous()
    return out


@contract(h="*[B,H,W,C]", motion="*[B,H,W,M]", _returns="*[B,H,W,C]")
def sep_conv_gru_plain(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                       motion: torch.Tensor,
                       ctx: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The kernel's computation in plain PyTorch (the JAX package's
    ``sep_conv_gru_xla``): h [B,H,W,hidden], motion [B,H,W,M], ctx the two
    hoisted context terms [B,H,W,3*hidden] (z | r | q, biases included) of
    the 1x5 and the 5x1 pass.  The inputs are upcast once, everything is
    computed in float32 (h1 between the passes too), and only the result is
    cast to h's dtype."""
    hidden = h.shape[-1]
    hf = to_nchw(h.float())
    mot = to_nchw(motion.float())
    for s, cs in (("1", ctx[0]), ("2", ctx[1])):
        c = to_nchw(cs.float())

        def conv(x, w, s=s):
            # conv_nchw: row-sharded, the 5x1 pass's H padding is a halo
            w = w.permute(2, 1, 0)                        # [Cout, Cin, 5]
            return conv_nchw(x, w[:, :, None, :] if s == "1"
                             else w[:, :, :, None], None)

        zr = conv(torch.cat([hf, mot], dim=1), fw["wzr" + s])
        z = torch.sigmoid(zr[:, :hidden] + c[:, :hidden])
        r = torch.sigmoid(zr[:, hidden:] + c[:, hidden:2 * hidden])
        q = torch.tanh(conv(r * hf, fw["wqh" + s]) + conv(mot, fw["wqm" + s])
                       + c[:, 2 * hidden:])
        hf = (1.0 - z) * hf + z * q
    return to_nhwc(hf).contiguous().to(h.dtype)



def _lib(name: str):
    from .. import _build
    fn = getattr(_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sep_conv_gru_cuda(kw: Dict[str, torch.Tensor], h: torch.Tensor,
                      motion: torch.Tensor,
                      ctx: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Launch the CUDA kernel (four launches).  h, motion and the context
    terms float32 or bfloat16 (one dtype, the output's); ``kw`` the
    weights as :func:`prepare_gru_weights` gives them for that dtype; every
    tensor contiguous, 16-byte aligned, on h's CUDA device; hidden a
    multiple of 64 and motion a multiple of 16."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"sep_conv_gru_cuda needs CUDA tensors, got {dev}")
    if h.dtype not in _SUFFIX:
        raise ValueError(f"sep_conv_gru_cuda takes float32 or bfloat16 "
                         f"activations, got {h.dtype}")
    B, H, W, hid = h.shape
    mot = motion.shape[-1]
    if hid % 64 or mot % 16 or hid == 0 or mot == 0:
        raise ValueError(f"the kernel needs hidden % 64 == 0 and motion % 16 "
                         f"== 0, got hidden={hid}, motion={mot}")
    cs = 8 if h.dtype == torch.float32 else 16      # channels per slab

    def prepared(cin, n):
        return (5, cin // cs, n, 4, 4)
    want = {"h": (B, H, W, hid), "motion": (B, H, W, mot),
            "ctx1": (B, H, W, 3 * hid), "ctx2": (B, H, W, 3 * hid),
            "wzr1": prepared(hid + mot, 2 * hid),
            "wzr2": prepared(hid + mot, 2 * hid),
            "wqh1": prepared(hid, hid), "wqh2": prepared(hid, hid),
            "wqm1": prepared(mot, hid), "wqm2": prepared(mot, hid)}
    tensors = {"h": h, "motion": motion, "ctx1": ctx[0], "ctx2": ctx[1],
               **{k: kw[k] for k in _WEIGHTS}}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != h.dtype:
            raise ValueError(f"{name} must be {h.dtype}, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}"
                             + (" (weights must come from prepare_gru_weights"
                                " for this dtype)" if name in _WEIGHTS else ""))
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scratch = torch.empty((3, B, H, W, hid), dtype=torch.float32, device=dev)
    out = torch.empty_like(h)
    name = f"sep_conv_gru_{_SUFFIX[h.dtype]}"
    fn = _lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(h.data_ptr(), motion.data_ptr(), ctx[0].data_ptr(),
                 ctx[1].data_ptr(), *[kw[k].data_ptr() for k in _WEIGHTS],
                 scratch[0].data_ptr(), scratch[1].data_ptr(),
                 scratch[2].data_ptr(), out.data_ptr(), B, H, W, hid, mot,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    sep_conv_gru_cuda.launches += LAUNCHES_PER_CALL
    return out


# kernel launches issued from Python; callers that count reset it.  A
# captured CUDA graph (models/capture.py) counts at capture, not at replay.
sep_conv_gru_cuda.launches = 0


def _gru_plain(h: torch.Tensor, motion: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor, fw: Sequence[torch.Tensor],
               kw: Sequence[torch.Tensor]) -> torch.Tensor:
    return sep_conv_gru_plain(dict(zip(_WEIGHTS, fw)), h, motion, (c1, c2))


def _gru_kernel(h, motion, c1, c2, fw, kw):
    if len(kw) != len(_WEIGHTS):
        raise ValueError("sep_conv_gru on CUDA tensors needs the kernel's "
                         "weights: pass kw=prepare_gru_weights(fw, dtype)")
    return sep_conv_gru_cuda(dict(zip(_WEIGHTS, kw)), h, motion, (c1, c2))


LIB.define("sep_conv_gru(Tensor h, Tensor motion, Tensor c1, Tensor c2, "
           "Tensor[] fw, Tensor[] kw) -> Tensor")
LIB.impl("sep_conv_gru", _gru_plain, "CPU")
LIB.impl("sep_conv_gru", _gru_kernel, "CUDA")


@torch.library.register_fake("raft_tpu_torch::sep_conv_gru", lib=LIB)
def _gru_fake(h, motion, c1, c2, fw, kw):
    return h.new_empty(h.shape)


sep_conv_gru_op = torch.ops.raft_tpu_torch.sep_conv_gru.default


def gru_flops(h_shape, fw_shapes) -> int:
    """The gate convs' products of one iteration: per pixel, each fused
    weight ``[5, Cin, Cout]`` once, 2 FLOPs a multiply-add
    (``30*hidden*(hidden+motion)`` multiply-adds a pixel)."""
    B, H, W, _ = h_shape
    return 2 * B * H * W * sum(math.prod(s) for s in fw_shapes)


@register_flop_formula(torch.ops.raft_tpu_torch.sep_conv_gru)
def _gru_flop(h_shape, motion_shape, c1_shape, c2_shape, fw_shapes,
              kw_shapes, *args, out_shape=None, **kwargs) -> int:
    return gru_flops(h_shape, fw_shapes)


class _SepConvGRU(torch.autograd.Function):
    """The operator ``raft_tpu_torch::sep_conv_gru``: the kernel on CUDA
    tensors, :func:`sep_conv_gru_plain` on CPU tensors.  The backward is
    the JAX package's ``_gru_fused_bwd`` (``raft_tpu/ops/gru_pallas.py``):
    the vjp of the plain version (``sep_conv_gru_xla`` there), recomputed
    from the saved ``(h, motion, c1, c2, fw)``; the gradient reaches the
    module's weights through the fused weights ``fw``, so the kernel's
    prepared weights ``kw`` get none.  Its convolutions run on cuDNN in
    float32 (TF32 held off by the train step, ``training/step.py``).  At
    bfloat16 I/O it keeps the dtypes of JAX's ``_gru_fused_bwd``: the
    fused weights ride float32 (``fuse_gru_weights`` upcasts the bfloat16
    casts of a bfloat16 training forward, and their gradient goes back
    through that cast to bfloat16), h, motion and the context terms are
    upcast once, everything is differentiated in float32, and their
    gradients come back bfloat16 (tests/test_torch_port_train_bf16.py).
    The twin is recomputed under the row-sharding context the forward saw
    (``spmd.entered``): its 5x1 pass halo-exchanges under a context, and
    the autograd engine's device thread has none of its own."""

    @staticmethod
    def forward(ctx_, kw, h, motion, c1, c2, *weights):
        ctx_.axis = spmd.spatial_axis()
        ctx_.save_for_backward(h, motion, c1, c2, *weights)
        return sep_conv_gru_op(h, motion, c1, c2, list(weights),
                               [] if kw is None else [kw[k] for k in _WEIGHTS])

    @staticmethod
    def backward(ctx_, grad):
        saved = ctx_.saved_tensors
        wanted = ctx_.needs_input_grad[1:]
        inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
        grads = [None] * len(inputs)
        live = [i for i, w in enumerate(wanted) if w]
        if live:
            with torch.enable_grad(), stage(TWIN_STAGE), \
                    spmd.entered(ctx_.axis):
                h, motion, c1, c2, *weights = inputs
                out = sep_conv_gru_plain(dict(zip(_WEIGHTS, weights)), h,
                                         motion, (c1, c2))
                got = torch.autograd.grad(out, [inputs[i] for i in live],
                                          grad, allow_unused=True)
            for i, g in zip(live, got):
                grads[i] = torch.zeros_like(saved[i]) if g is None else g
        return (None, *grads)


@contract(h="*[B,H,W,C]", motion="*[B,H,W,M]", _returns="*[B,H,W,C]")
def sep_conv_gru(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                 motion: torch.Tensor,
                 ctx: Tuple[torch.Tensor, torch.Tensor],
                 kw: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One SepConvGRU iteration of ``gru_impl='pallas'``: the CUDA kernel
    on CUDA tensors (weights ``kw`` from :func:`prepare_gru_weights`), the
    plain version on CPU tensors (weights ``fw``).  Other arguments as
    :func:`sep_conv_gru_plain`."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")
    return _SepConvGRU.apply(kw, h, motion, ctx[0], ctx[1],
                             *[fw[k] for k in _WEIGHTS])


def sep_conv_gru_rows(fw: Dict[str, torch.Tensor], h: torch.Tensor,
                      motion: torch.Tensor,
                      ctx: Tuple[torch.Tensor, torch.Tensor],
                      kw: Optional[Dict[str, torch.Tensor]] = None,
                      axis: Optional[spmd.Axis] = None) -> torch.Tensor:
    """:func:`sep_conv_gru` on a row slab (the active row-sharding axis
    unless ``axis`` is given; unsharded, the call itself): h, motion and
    the two context terms are widened by :data:`GRU_HALO` rows of the
    interior neighbours (``spmd.halo_extend``: none on an edge rank's
    image-edge side, where the kernel's own zero padding is the image's;
    a halo of zero rows would not be, since the 1x5 pass turns a zero row
    into a non-zero one), the unchanged kernel (or on CPU tensors its plain
    twin) runs on the widened slab outside the context, and the added rows
    are cropped.  Its backward is the twin's vjp on the widened slab, the
    halo rows' cotangents sent back to the neighbours."""
    axis = spmd.spatial_axis() if axis is None else axis
    if axis is None or axis.size == 1:
        with spmd.entered(None):
            return sep_conv_gru(fw, h, motion, ctx, kw)
    wide, top, _ = spmd.halo_extend([h, motion, ctx[0], ctx[1]], GRU_HALO,
                                    axis, dim=1)
    hw, mw, c1, c2 = (t.contiguous() for t in wide)
    with spmd.entered(None):
        out = sep_conv_gru(fw, hw, mw, (c1, c2), kw)
    return out.narrow(1, top, h.shape[1]).contiguous()
