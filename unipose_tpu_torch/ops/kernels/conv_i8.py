"""s8 x s8 -> s32 convolution, and the same conv with the int8 front end's
epilogue fused: the hand-written CUDA kernel and its plain PyTorch versions.

Counterpart of ``unipose_tpu/ops/quant.py::conv_i8`` (:116-127), an XLA
conv with ``preferred_element_type=int32`` (not a Pallas kernel), and of the
f32 epilogue that follows it in ``frontend_int8`` (:291-303), which XLA
fuses into the conv's consumers.  No PyTorch call computes the conv on
CUDA, so the port writes it: ``csrc/conv_i8.cu`` (its header says what
bounds it and how it is laid out), one main loop on the int8 tensor cores
with three epilogues.  The layout is the JAX one: NHWC int8 input, NHWC
output; the weights, HWIO int8 in JAX, are packed once
(:func:`pack_weight`) as the kernel's (N, Kp) rows.

Two registered ops run the kernel: ``unipose::conv_i8`` returns the int32
accumulator (the JAX function), ``unipose::conv_i8_requant`` the
epilogue's output (:func:`conv_i8_requant`), which is what the front end
calls.  Each has a CPU implementation that is its plain version, a CUDA
implementation that launches the kernel or raises, a fake implementation
that gives ``torch.export`` the outputs' shapes, and an operation formula
(:func:`conv_macs`) that lets ``FlopCounterMode`` count it, whose inside it
does not see.  ``<wrapper>.launches`` counts inside the CUDA
implementation.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from unipose_tpu_torch.ops.kernels import build

TK = 32  # pack_weight pads K to a multiple of this (csrc KP_ALIGN)


def out_size(n: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def conv_macs(b: int, ho: int, wo: int, n: int, kh: int, kw: int, cin: int) -> int:
    """Multiply-adds of a conv with a (B, Ho, Wo, N) output and kh x kw x
    Cin taps an output."""
    return b * ho * wo * n * kh * kw * cin


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, N) int8 -> (N, Kp) int8: row n holds K = kh*kw*Cin
    weights tap-major, (ky*kw + kx)*Cin + c, then zeros up to Kp, the next
    multiple of 32."""
    kh, kw, cin, n = w_hwio.shape
    k = kh * kw * cin
    packed = w_hwio.new_zeros((n, -(-k // TK) * TK))
    packed[:, :k] = w_hwio.permute(3, 0, 1, 2).reshape(n, k)
    return packed


def unpack_weight(packed: torch.Tensor, kh: int, kw: int, cin: int) -> torch.Tensor:
    """The inverse of :func:`pack_weight`: (N, Kp) -> (kh, kw, Cin, N)."""
    n = packed.shape[0]
    return packed[:, : kh * kw * cin].reshape(n, kh, kw, cin).permute(1, 2, 3, 0)


def conv_i8_reference(
    x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1
) -> torch.Tensor:
    """The plain version: (B, H, W, Cin) int8 * (kh, kw, Cin, N) int8 ->
    (B, Ho, Wo, N) int32, exact.  The conv runs in f64: every partial sum
    is an integer below 2^53, so it is exact (f32 is not: the front end's
    sums reach 127^2 * 1152 > 2^24)."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2).double(), w_hwio.permute(3, 2, 0, 1).double(),
        stride=stride, padding=padding, dilation=dilation,
    )
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def requant(h: torch.Tensor, s: float) -> torch.Tensor:
    """Int8 codes of ``h`` at scale ``s``: clamp(round(h / s), -127, 127),
    rounding half to even.  The divisor is a 0-dim f32 tensor on ``h``'s
    device: divided by a Python float, a CUDA tensor is multiplied by the
    f32 reciprocal (ATen's CPU-scalar branch of true division), which can
    round apart from the CPU's, JAX's and the kernel's true division."""
    return torch.clamp(
        torch.round(h.float() / torch.full((), s, dtype=torch.float32, device=h.device)), -127, 127
    ).to(torch.int8)


def conv_i8_requant_reference(
    x: torch.Tensor, w_hwio: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    stride: int = 1, padding: int = 0, dilation: int = 1, out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None, residual_scale: float = 1.0,
    deq_dtype: Optional[torch.dtype] = None,
) -> List[torch.Tensor]:
    """The plain version of the fused op: :func:`conv_i8_reference`, then
    the f32 epilogue of ``ops/quant.py``, a PyTorch op each step.
    ``y = acc * scale + bias`` ((Cout,) f32 each; ``scale`` is
    ``w_scale * s_in``).  ``out_scale`` None: ``[y]``.  Otherwise the codes
    ``q = requant(relu(y + r), out_scale)``, ``r`` the f32 ``residual`` or
    the int8 one times ``residual_scale`` (or none), and with ``deq_dtype``
    also ``q * out_scale`` in that dtype: ``[q]`` or ``[q, deq]``."""
    y = conv_i8_reference(x, w_hwio, stride, padding, dilation).float() * scale + bias
    if out_scale is None:
        return [y]
    if residual is not None:
        y = y + (residual if residual.dtype == torch.float32 else residual.float() * residual_scale)
    q = requant(torch.relu(y), out_scale)
    return [q] if deq_dtype is None else [q, (q.float() * out_scale).to(deq_dtype)]


def _library() -> ctypes.CDLL:
    lib = build.load("conv_i8")
    if lib.conv_i8_forward.argtypes is None:
        lib.conv_i8_forward.restype = ctypes.c_int
        lib.conv_i8_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        lib.conv_i8_requant_forward.restype = ctypes.c_int
        lib.conv_i8_requant_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.conv_i8_blocks_per_sm.restype = ctypes.c_int
        lib.conv_i8_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.conv_i8_error_string.restype = ctypes.c_char_p
        lib.conv_i8_error_string.argtypes = [ctypes.c_int]
    return lib


def blocks_per_sm(bm: int, vec: bool) -> int:
    """Blocks of the fused op's kernel that fit one SM at once (CUDA's
    occupancy calculator), for a tile of ``bm`` rows and the 16-byte or the
    byte gather; -1 on a CUDA error."""
    return _library().conv_i8_blocks_per_sm(bm, int(vec))


def conv_i8(
    x: torch.Tensor, w_packed: torch.Tensor, kh: int, kw: int,
    stride: int = 1, padding: int = 0, dilation: int = 1,
) -> torch.Tensor:
    """s8 x s8 -> s32 conv, (B, H, W, Cin) int8 and :func:`pack_weight`
    weights -> (B, Ho, Wo, N) int32, through the op ``unipose::conv_i8``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    return torch.ops.unipose.conv_i8(x, w_packed, kh, kw, stride, padding, dilation)


conv_i8.launches = 0


def _check(x, w, kh, kw, stride, padding, dilation) -> None:
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"conv_i8 expects (B, H, W, Cin), got {tuple(x.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv_i8 takes int8 input and weights, got {x.dtype} and {w.dtype}")
    k = kh * kw * x.shape[3]
    if w.dim() != 2 or w.shape[1] < k or w.shape[1] % TK or w.device != x.device:
        raise ValueError(
            f"conv_i8 weights are {tuple(w.shape)} on {w.device}; want (N, Kp >= {k}, Kp % {TK} == 0) "
            f"on {x.device} (pack_weight)"
        )
    if min(kh, kw, stride, dilation) < 1 or padding < 0:
        raise ValueError("conv_i8 needs kh, kw, stride, dilation >= 1 and padding >= 0")
    if min(out_size(x.shape[1], kh, stride, padding, dilation),
           out_size(x.shape[2], kw, stride, padding, dilation)) < 1:
        raise ValueError(f"conv_i8: a {kh}x{kw} window does not fit {tuple(x.shape)}")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv_i8 needs contiguous, 16-byte-aligned input and weights")


@torch.library.custom_op("unipose::conv_i8", mutates_args=(), device_types="cpu")
def _conv_i8_op(
    x: torch.Tensor, w: torch.Tensor, kh: int, kw: int, stride: int, padding: int, dilation: int
) -> torch.Tensor:
    return conv_i8_reference(x, unpack_weight(w, kh, kw, x.shape[3]), stride, padding, dilation)


@_conv_i8_op.register_kernel("cuda")
def _conv_i8_cuda(x, w, kh, kw, stride, padding, dilation):
    _check(x, w, kh, kw, stride, padding, dilation)
    b, h, wd, cin = x.shape
    _, ho, wo, n = _out_shape(x, w, kh, kw, stride, padding, dilation)
    with torch.cuda.device(x.device):
        out = torch.empty((b, ho, wo, n), dtype=torch.int32, device=x.device)
        lib = _library()
        rc = lib.conv_i8_forward(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, h, wd, cin, ho, wo, n, kh, kw, stride, padding, dilation, w.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"conv_i8 launch failed: {lib.conv_i8_error_string(rc).decode()}")
    conv_i8.launches += 1
    return out


@_conv_i8_op.register_fake
def _(x, w, kh, kw, stride, padding, dilation):
    return x.new_empty(_out_shape(x, w, kh, kw, stride, padding, dilation), dtype=torch.int32)


@register_flop_formula(torch.ops.unipose.conv_i8)
def _(x_shape, w_shape, kh, kw, *args, out_shape=None, **kwargs) -> int:
    return 2 * conv_macs(*out_shape, kh, kw, x_shape[3])


# ---------------------------------------------------------------------------
# The fused op: the same main loop with the front end's epilogue
# ---------------------------------------------------------------------------

_RESIDUAL_KIND = {None: 0, torch.float32: 1, torch.int8: 2}
_DEQ_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def conv_i8_requant(
    x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
    stride: int = 1, padding: int = 0, dilation: int = 1, out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None, residual_scale: float = 1.0,
    deq_dtype: Optional[torch.dtype] = None,
) -> List[torch.Tensor]:
    """The conv of :func:`conv_i8` with its epilogue
    (:func:`conv_i8_requant_reference` says which), through the op
    ``unipose::conv_i8_requant``: ``[y]`` f32, ``[q]`` int8 codes or
    ``[q, deq]``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    return torch.ops.unipose.conv_i8_requant(
        x, w_packed, scale, bias, kh, kw, stride, padding, dilation, out_scale, residual, residual_scale,
        deq_dtype,
    )


conv_i8_requant.launches = 0


def _out_shape(x, w, kh, kw, stride, padding, dilation):
    b, h, wd, _ = x.shape
    return (b, out_size(h, kh, stride, padding, dilation), out_size(wd, kw, stride, padding, dilation),
            w.shape[0])


def _check_epilogue(x, w, scale, bias, out_scale, residual, deq_dtype, shape) -> None:
    n = w.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"conv_i8_requant's {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"want contiguous f32 ({n},) on {x.device}")
    if out_scale is None and (residual is not None or deq_dtype is not None):
        raise ValueError("conv_i8_requant: the f32 output takes no residual and no dequantised output")
    if out_scale is not None and not out_scale > 0:
        raise ValueError(f"conv_i8_requant needs out_scale > 0, got {out_scale}")
    if deq_dtype not in _DEQ_KIND:
        raise TypeError(f"conv_i8_requant writes the dequantised output as f32 or bf16, not {deq_dtype}")
    if residual is not None and (
        residual.dtype not in (torch.float32, torch.int8) or tuple(residual.shape) != shape
        or not residual.is_contiguous() or residual.device != x.device
    ):
        raise ValueError(f"conv_i8_requant's residual is {residual.dtype} {tuple(residual.shape)} on "
                         f"{residual.device}; want contiguous f32 or int8 {shape} on {x.device}")


@torch.library.custom_op("unipose::conv_i8_requant", mutates_args=(), device_types="cpu")
def _conv_i8_requant_op(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
    stride: int, padding: int, dilation: int, out_scale: Optional[float], residual: Optional[torch.Tensor],
    residual_scale: float, deq_dtype: Optional[torch.dtype],
) -> List[torch.Tensor]:
    return conv_i8_requant_reference(
        x, unpack_weight(w, kh, kw, x.shape[3]), scale, bias, stride, padding, dilation, out_scale,
        residual, residual_scale, deq_dtype,
    )


@_conv_i8_requant_op.register_kernel("cuda")
def _conv_i8_requant_cuda(x, w, scale, bias, kh, kw, stride, padding, dilation, out_scale, residual,
                          residual_scale, deq_dtype):
    _check(x, w, kh, kw, stride, padding, dilation)
    shape = _out_shape(x, w, kh, kw, stride, padding, dilation)
    _check_epilogue(x, w, scale, bias, out_scale, residual, deq_dtype, shape)
    b, h, wd, cin = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty(shape, dtype=torch.float32 if out_scale is None else torch.int8, device=x.device)
        deq = None if deq_dtype is None else torch.empty(shape, dtype=deq_dtype, device=x.device)
        lib = _library()
        rc = lib.conv_i8_requant_forward(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(bias.data_ptr()), ctypes.c_void_p(None if residual is None else residual.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(None if deq is None else deq.data_ptr()),
            b, h, wd, cin, shape[1], shape[2], shape[3], kh, kw, stride, padding, dilation, w.shape[1],
            1.0 if out_scale is None else out_scale, residual_scale, 1 if out_scale is None else 2,
            _RESIDUAL_KIND[None if residual is None else residual.dtype], _DEQ_KIND[deq_dtype],
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"conv_i8_requant launch failed: {lib.conv_i8_error_string(rc).decode()}")
    conv_i8_requant.launches += 1
    return [out] if deq is None else [out, deq]


@_conv_i8_requant_op.register_fake
def _(x, w, scale, bias, kh, kw, stride, padding, dilation, out_scale, residual, residual_scale, deq_dtype):
    shape = _out_shape(x, w, kh, kw, stride, padding, dilation)
    out = x.new_empty(shape, dtype=torch.float32 if out_scale is None else torch.int8)
    return [out] if deq_dtype is None else [out, x.new_empty(shape, dtype=deq_dtype)]


@register_flop_formula(torch.ops.unipose.conv_i8_requant)
def _(x_shape, w_shape, scale_shape, bias_shape, kh, kw, *args, out_shape=None, **kwargs) -> int:
    return 2 * conv_macs(*out_shape[0], kh, kw, x_shape[3])
