"""Fused Gaussian-target MSE loss: the hand-written CUDA kernels (forward
and backward), their plain PyTorch versions and the autograd function.

Counterpart of ``unipose_tpu/ops/pallas/heatmap_loss.py``.  The kernels are
``csrc/heatmap_mse.cu`` (its header says what bounds them and how they are
laid out).  They build the Gaussian targets from the keypoints inside the
loss and its gradient, so the (B, H, W, K+1) target tensor never exists.
The public functions keep the JAX layout: ``pred`` is NHWC (B, H, W, K+1),
``kpts`` (B, K, 2) pixel coordinates at input resolution.  The keypoints
get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from unipose_tpu_torch.ops.heatmap import render_targets
from unipose_tpu_torch.ops.kernels import build


def _targets(pred: torch.Tensor, kpts: torch.Tensor, stride: int, sigma: float) -> torch.Tensor:
    _, h, w, _ = pred.shape
    return render_targets(kpts, h * stride, w * stride, stride, sigma)


def heatmap_mse_reference(
    pred: torch.Tensor, kpts: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """The plain version of the forward: ``render_targets`` + the mean
    squared error, in f32 whatever ``pred``'s dtype (the kernel's
    arithmetic).  Differentiable by autograd."""
    return torch.mean(torch.square(pred.float() - _targets(pred, kpts, stride, sigma)))


def heatmap_mse_backward_reference(
    pred: torch.Tensor, kpts: torch.Tensor, g: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """The plain version of the backward: ``(pred - target) * 2g / N`` in
    f32, returned in ``pred``'s dtype."""
    scale = g.float() * 2.0 / pred.numel()
    return ((pred.float() - _targets(pred, kpts, stride, sigma)) * scale).to(pred.dtype)


def _check(pred: torch.Tensor, kpts: torch.Tensor) -> None:
    if pred.device.type != "cuda" or kpts.device != pred.device:
        raise ValueError(
            f"heatmap_mse runs on one CUDA device; got pred on {pred.device}, "
            f"kpts on {kpts.device}"
        )
    if pred.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"heatmap_mse takes float32 or bfloat16 pred, got {pred.dtype}")
    if kpts.dtype != torch.float32:
        raise TypeError(f"heatmap_mse takes float32 keypoints, got {kpts.dtype}")
    if pred.dim() != 4 or kpts.dim() != 3 or kpts.shape[2] != 2:
        raise ValueError(
            f"heatmap_mse expects pred (B, H, W, K+1) and kpts (B, K, 2), got "
            f"{tuple(pred.shape)} and {tuple(kpts.shape)}"
        )
    b, _, _, c = pred.shape
    if kpts.shape[0] != b or kpts.shape[1] + 1 != c or c < 2:
        raise ValueError(
            f"pred {tuple(pred.shape)} needs kpts ({b}, {c - 1}, 2), got {tuple(kpts.shape)}"
        )
    # a strided kpts view, such as kpts3[..., :2], would be read as (B, K, 2)
    # with the visibility column taken for a coordinate
    if not (pred.is_contiguous() and kpts.is_contiguous()):
        raise ValueError("heatmap_mse needs contiguous NHWC pred and (B, K, 2) kpts")


def _library() -> ctypes.CDLL:
    lib = build.load("heatmap_mse")
    if lib.heatmap_mse_forward.argtypes is None:
        dims = [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.heatmap_mse_num_partials.restype = ctypes.c_int
        lib.heatmap_mse_num_partials.argtypes = [ctypes.c_int] * 3
        lib.heatmap_mse_forward.restype = ctypes.c_int
        lib.heatmap_mse_forward.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + dims
        lib.heatmap_mse_backward.restype = ctypes.c_int
        lib.heatmap_mse_backward.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + dims
        lib.heatmap_mse_error_string.restype = ctypes.c_char_p
        lib.heatmap_mse_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(entry: str, pred, kpts, operand, out, stride: int, sigma: float) -> None:
    """Launch ``heatmap_mse_forward`` (operand = partial sums) or
    ``heatmap_mse_backward`` (operand = the cotangent g) on pred's stream."""
    b, h, w, c = pred.shape
    lib = _library()
    rc = getattr(lib, entry)(
        0 if pred.dtype == torch.float32 else 1,
        ctypes.c_void_p(pred.data_ptr()),
        ctypes.c_void_p(kpts.data_ptr()),
        ctypes.c_void_p(operand.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        b, h, w, c - 1, int(stride), float(sigma) * float(sigma), float(pred.numel()),
        ctypes.c_void_p(torch.cuda.current_stream(pred.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.heatmap_mse_error_string(rc).decode()}")


def heatmap_mse_backward(
    pred: torch.Tensor, kpts: torch.Tensor, g: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """dL/dpred of :func:`heatmap_mse` for the 0-dim cotangent ``g``, read
    on the device (no host sync).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if pred.device.type == "cpu":
        return heatmap_mse_backward_reference(pred, kpts, g, stride, sigma)
    _check(pred, kpts)
    g = g.to(device=pred.device, dtype=torch.float32).reshape(())
    with torch.cuda.device(pred.device):
        dpred = torch.empty_like(pred)
        _launch("heatmap_mse_backward", pred, kpts, g, dpred, stride, sigma)
    heatmap_mse_backward.launches += 1
    return dpred


heatmap_mse_backward.launches = 0


class _HeatmapMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, kpts, stride, sigma):
        ctx.save_for_backward(pred, kpts)
        ctx.stride, ctx.sigma = stride, sigma
        if pred.device.type == "cpu":
            return heatmap_mse_reference(pred, kpts, stride, sigma)
        _check(pred, kpts)
        b, h, w, _ = pred.shape
        with torch.cuda.device(pred.device):
            partials = torch.empty(
                _library().heatmap_mse_num_partials(b, h, w),
                dtype=torch.float32, device=pred.device,
            )
            loss = torch.empty((), dtype=torch.float32, device=pred.device)
            _launch("heatmap_mse_forward", pred, kpts, partials, loss, stride, sigma)
        heatmap_mse.launches += 1
        return loss

    @staticmethod
    def backward(ctx, g):
        pred, kpts = ctx.saved_tensors
        return heatmap_mse_backward(pred, kpts, g, ctx.stride, ctx.sigma), None, None, None


def heatmap_mse(
    pred: torch.Tensor, kpts: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """``mean((pred - targets(kpts))^2)`` as a 0-dim f32 tensor, without
    building the targets in memory.  pred: (B, H, W, K+1) heatmaps, f32 or
    bf16; kpts: (B, K, 2) f32 pixel coordinates.  Differentiable in
    ``pred`` through the backward kernel.  CPU tensors take the plain
    versions; CUDA tensors launch the kernels or raise."""
    return _HeatmapMSE.apply(pred, kpts, stride, sigma)


heatmap_mse.launches = 0
