"""s8 x s8 -> s32 convolution: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``unipose_tpu/ops/quant.py::conv_i8`` (:116-127), an XLA
conv with ``preferred_element_type=int32`` (not a Pallas kernel).  No
PyTorch call computes it on CUDA, so the port writes it: ``csrc/conv_i8.cu``
(its header says what bounds it and how it is laid out).  The layout is the
JAX one: NHWC int8 input, int32 NHWC output; the weights, HWIO int8 in
JAX, are packed once (:func:`pack_weight`) as the kernel's (N, Kp) rows.

The kernel is the registered op ``unipose::conv_i8``: its CPU
implementation is the plain version, its CUDA implementation the launch,
and a fake implementation gives ``torch.export`` the output's shape, so an
exported int8 program calls the op.  ``conv_i8.launches`` counts inside the
CUDA implementation.  An operation formula (:func:`conv_macs`) lets
``FlopCounterMode`` count the op, whose inside it does not see.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from unipose_tpu_torch.ops.kernels import build

TK = 32  # K bytes a kernel step (csrc TK): Kp is a multiple of it


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


def _library() -> ctypes.CDLL:
    lib = build.load("conv_i8")
    if lib.conv_i8_forward.argtypes is None:
        lib.conv_i8_forward.restype = ctypes.c_int
        lib.conv_i8_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        lib.conv_i8_error_string.restype = ctypes.c_char_p
        lib.conv_i8_error_string.argtypes = [ctypes.c_int]
    return lib


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
    ho = out_size(h, kh, stride, padding, dilation)
    wo = out_size(wd, kw, stride, padding, dilation)
    n = w.shape[0]
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
    b, h, wd, _ = x.shape
    return x.new_empty(
        (b, out_size(h, kh, stride, padding, dilation), out_size(wd, kw, stride, padding, dilation), w.shape[0]),
        dtype=torch.int32,
    )


@register_flop_formula(torch.ops.unipose.conv_i8)
def _(x_shape, w_shape, kh, kw, *args, out_shape=None, **kwargs) -> int:
    return 2 * conv_macs(*out_shape, kh, kw, x_shape[3])
