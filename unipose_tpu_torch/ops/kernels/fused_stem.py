"""Fused eval-mode ResNet stem: the hand-written CUDA kernel, its plain
PyTorch version and the BN folding they share.

Counterpart of ``unipose_tpu/ops/pallas/stem.py``.  The kernel is
``csrc/fused_stem.cu`` (its header says what bounds it and how it is laid
out); this module folds the weights, checks what the kernel is given and
launches it.  The public functions keep the JAX layout: NHWC in, NHWC out.

The stem is conv 7x7/2 pad 3 -> eval BatchNorm -> ReLU -> maxpool 3x3/2
pad 1.  The folded weights hold the conv in its exact space-to-depth form
(``models.resnet.s2d_stem_kernel``): a 4x4 stride-1 conv over
space-to-depth(2) input, (192, 64) tap-major, and BN as an f32 scale and
bias.  The bf16 kernel takes the weights packed for its k16 tensor-core
steps (:func:`pack_stem_weights`); :func:`cast_folded` packs them once.

The kernel is the registered op ``unipose::fused_stem``: its CPU
implementation is the plain version, its CUDA implementation the launch,
and a fake implementation gives ``torch.export`` the output's shape and
dtype, so that an exported program calls the op and not this module's
Python.  ``fused_stem.launches`` counts inside the CUDA implementation.
A FLOP formula (:func:`stem_macs`) lets ``FlopCounterMode`` count the
op, whose inside it does not see.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from unipose_tpu_torch.ops.kernels import build

C_OUT = 64
TAPS = 16 * 12  # 4x4 taps of the 12 space-to-depth channels
_SHAPES = {"w4": (TAPS, C_OUT), "scale": (C_OUT,), "bias": (C_OUT,)}


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


@torch.no_grad()
def fold_stem_params(resnet) -> Dict[str, torch.Tensor]:
    """Fold a ``models.resnet.ResNet101``'s stem (``conv1`` through
    ``s2d_stem_kernel``, or ``conv1_s2d`` as it is, and ``bn1``) into f32
    ``{"w4": (192, 64), "scale": (64,), "bias": (64,)}`` on the module's
    device, as the JAX ``fold_stem_params`` (:44-62) does."""
    from unipose_tpu_torch.models.resnet import s2d_stem_kernel

    if resnet.stem_s2d:
        w4 = resnet.conv1_s2d.weight.float().permute(2, 3, 1, 0)  # OIHW -> HWIO
    else:
        w4 = s2d_stem_kernel(resnet.conv1.weight.float().permute(2, 3, 1, 0))
    bn = resnet.bn1
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return {
        "w4": w4.reshape(TAPS, C_OUT).contiguous(),
        "scale": s.contiguous(),
        "bias": (bn.bias.float() - bn.running_mean.float() * s).contiguous(),
    }


def stem_macs(b: int, h: int, w: int, products: int = TAPS) -> int:
    """Multiply-adds of the stem conv on (B, H, W, 3) images: ``products``
    a conv output, 192 in the space-to-depth form the op computes (4x4
    taps of 12 channels; 147 of them are the 7x7 kernel's)."""
    return b * ((h + 1) // 2) * ((w + 1) // 2) * C_OUT * products


def pack_stem_weights(w4: torch.Tensor) -> torch.Tensor:
    """(192, 64) tap-major weights -> (16 taps, 16, 64): tap (ti*4 + tj),
    row (dy*2 + dx)*3 + c as in w4, rows 12-15 zero.  Each tap is then one
    k16 step of the bf16 kernel's MMAs."""
    packed = w4.new_zeros(16, 16, C_OUT)
    packed[:, :12] = w4.reshape(16, 12, C_OUT)
    return packed


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` itself when it already has ``dtype`` and is contiguous (so an
    exported program that holds cast weights records no conversion)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def cast_folded(folded: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Weights in the compute dtype, scale and bias f32 (the JAX wrapper's
    casts, :153-155), and for bf16 the packed weights ``w16``, done once
    instead of at every call."""
    out = {
        "w4": _as(folded["w4"], dtype),
        "scale": _as(folded["scale"], torch.float32),
        "bias": _as(folded["bias"], torch.float32),
    }
    if dtype == torch.bfloat16:
        w16 = folded.get("w16")
        if w16 is None or w16.dtype != dtype or w16.device != out["w4"].device:
            w16 = pack_stem_weights(out["w4"])
        out["w16"] = w16
    return out


def fused_stem_reference(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (B, H, W, 3) ->
    (B, ceil(H/4), ceil(W/4), 64) in x.dtype, with the Pallas kernel's
    rounding points: products in f32 on operands of x.dtype, then scale and
    bias in f32, ReLU, the max pool, and one rounding at the output.  An odd
    H or W gets one zero row or column first, which leaves the 7x7/2 conv
    unchanged."""
    b, h, w, _ = x.shape
    xs = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    xs = space_to_depth(xs, 2).permute(0, 3, 1, 2).float()  # (B, 12, H/2, W/2)
    w4 = folded["w4"].to(x.dtype).float().reshape(4, 4, 12, C_OUT).permute(3, 2, 0, 1)
    conv = F.conv2d(F.pad(xs, (2, 1, 2, 1)), w4)
    act = torch.relu(conv * folded["scale"].float()[:, None, None] + folded["bias"].float()[:, None, None])
    return F.max_pool2d(act, 3, 2, 1).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> None:
    if x.dim() != 4 or x.shape[3] != 3 or min(x.shape[:3]) < 1:
        raise ValueError(f"fused_stem expects (B, H, W, 3), got {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"fused_stem takes at most 65535 images a call, got {x.shape[0]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_stem takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_stem needs a contiguous, 16-byte-aligned NHWC input")
    for k, shape in _SHAPES.items():
        t = folded[k]
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"folded[{k!r}] is {tuple(t.shape)} on {t.device}; want {shape} on {x.device}"
            )


def _library() -> ctypes.CDLL:
    lib = build.load("fused_stem")
    if lib.fused_stem_forward.argtypes is None:
        lib.fused_stem_forward.restype = ctypes.c_int
        lib.fused_stem_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        lib.fused_stem_error_string.restype = ctypes.c_char_p
        lib.fused_stem_error_string.argtypes = [ctypes.c_int]
        lib.fused_stem_blocks_per_sm.restype = ctypes.c_int
        lib.fused_stem_blocks_per_sm.argtypes = [ctypes.c_int]
    return lib


def blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the ``dtype`` kernel resident on one SM at once (CUDA's
    occupancy calculator, on the current card)."""
    return _library().fused_stem_blocks_per_sm(0 if dtype == torch.float32 else 1)


def fused_stem(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fused eval stem: (B, H, W, 3) -> (B, ceil(H/4), ceil(W/4), 64) in
    x.dtype, through the op ``unipose::fused_stem``.

    ``folded``: :func:`fold_stem_params` output (the weights are cast to
    x.dtype, and packed for bf16; pass :func:`cast_folded` output to skip
    that).  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    w = cast_folded(folded, x.dtype)
    return torch.ops.unipose.fused_stem(x, w["w4"], w["scale"], w["bias"], w.get("w16"))


fused_stem.launches = 0


@torch.library.custom_op("unipose::fused_stem", mutates_args=(), device_types="cpu")
def _fused_stem_op(
    x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    w16: Optional[torch.Tensor],
) -> torch.Tensor:
    return fused_stem_reference(x, {"w4": w4, "scale": scale, "bias": bias})


@_fused_stem_op.register_kernel("cuda")
def _fused_stem_cuda(x, w4, scale, bias, w16):
    folded = {"w4": w4, "scale": scale, "bias": bias}
    _check(x, folded)
    w = w4 if x.dtype == torch.float32 else w16
    if w is None or w.dtype != x.dtype or (x.dtype == torch.bfloat16 and tuple(w.shape) != (16, 16, C_OUT)):
        raise ValueError("fused_stem in bf16 needs the packed bf16 weights w16 (cast_folded)")
    if w4.dtype != x.dtype or scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_stem needs weights in x.dtype and an f32 scale and bias (cast_folded)")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (w, scale, bias)):
        raise ValueError("fused_stem needs contiguous, 16-byte-aligned folded weights")
    b, h, wd, _ = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty((b, (h + 3) // 4, (wd + 3) // 4, C_OUT), dtype=x.dtype, device=x.device)
        lib = _library()
        rc = lib.fused_stem_forward(
            0 if x.dtype == torch.float32 else 1,
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            b, h, wd,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"fused_stem launch failed: {lib.fused_stem_error_string(rc).decode()}")
    fused_stem.launches += 1
    return out


@_fused_stem_op.register_fake
def _(x, w4, scale, bias, w16):
    b, h, w, _ = x.shape
    return x.new_empty((b, (h + 3) // 4, (w + 3) // 4, C_OUT))


@register_flop_formula(torch.ops.unipose.fused_stem)
def _(x_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, w, _ = x_shape
    return 2 * stem_macs(b, h, w)
