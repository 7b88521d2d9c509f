"""Fused Gaussian-target MSE loss: the hand-written CUDA kernels (forward
and backward), their plain PyTorch versions, the tile plan and the autograd
function.

Counterpart of ``unipose_tpu/ops/pallas/heatmap_loss.py``.  The kernels are
``csrc/heatmap_mse.cu`` (its header says what bounds them and how they are
laid out).  They build the Gaussian targets from the keypoints inside the
loss and its gradient, so the (B, H, W, K+1) target tensor never exists.
The public functions keep the JAX layout: ``pred`` is NHWC (B, H, W, K+1),
``kpts`` (B, K, 2) pixel coordinates at input resolution, which may be the
``[..., :2]`` view of (B, K, 3) keypoints.  The keypoints get no gradient.

Each direction is one launch.  The call path allocates only its result
(the 0-dim loss, or dpred): the forward's scratch (a slot a block for its
partial sum, which the kernel leaves empty) is held per (device, stream),
so that the path can be captured by a CUDA graph and replayed.  A graph's
replays use the scratch of the stream it was captured on, which is never
freed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from unipose_tpu_torch.ops.heatmap import render_targets
from unipose_tpu_torch.ops.kernels import build

# Mirrors of csrc/heatmap_mse.cu: a change goes in both places.
THREADS = 256  # threads a block, and pixels a tile at most (csrc THREADS)
SMEM_LIMIT = 46 * 1024  # dynamic shared memory a block (csrc SMEM_LIMIT)
BLOCKS_PER_SM = 4  # blocks an SM before a block takes several tiles
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


class TilePlan(NamedTuple):
    """How the kernels cut B*H*W pixels: tile i holds pixels [i*P, (i+1)*P)
    (the last one fewer), block j takes tiles [j*tiles_per_block, (j+1)*
    tiles_per_block); the forward writes one partial sum a block, and
    launches one block more, which adds them."""

    tile_pixels: int  # P, a multiple of 8
    tiles: int
    tiles_per_block: int
    blocks: int
    partials: int  # 64-bit slots of the forward's scratch (= blocks)
    smem_bytes: int  # the backward's (two tiles); the forward uses less


def _smem_bytes(b: int, hw: int, c: int, elem: int, p: int) -> int:
    """csrc smem_bytes(backward=True): an input and an output tile of
    p*c*elem + 16 bytes, and the centers of the images p pixels can touch."""
    images = min(b, (p - 1) // hw + 2)
    return 2 * (p * c * elem + 16) + images * 2 * (c - 1) * 4


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype, num_sms: int) -> TilePlan:
    """The kernels' plan for pred (b, h, w, c) of ``dtype`` on a card with
    ``num_sms`` SMs: P = pixels / SMs rounded down to a multiple of 8 (at
    least 8, at most THREADS, and small enough for the shared memory), so
    that there are at least ``num_sms`` tiles where the pixels allow; one
    tile a block up to BLOCKS_PER_SM blocks an SM, then several."""
    pixels, elem = b * h * w, _ELEM[dtype]
    p = min(THREADS, max(8, pixels // num_sms // 8 * 8))
    while p > 8 and _smem_bytes(b, h * w, c, elem, p) > SMEM_LIMIT:
        p -= 8
    smem = _smem_bytes(b, h * w, c, elem, p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"heatmap_mse: {c} channels do not fit a tile of 8 pixels")
    tiles = -(-pixels // p)
    per_block = -(-tiles // (BLOCKS_PER_SM * num_sms))
    blocks = -(-tiles // per_block)
    return TilePlan(p, tiles, per_block, blocks, blocks, smem)


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


def _check(pred: torch.Tensor, kpts: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the keypoints' row
    stride (2, or 3 for a (B, K, 3)[..., :2] view)."""
    if pred.device.type != "cuda" or kpts.device != pred.device:
        raise ValueError(
            f"heatmap_mse runs on one CUDA device; got pred on {pred.device}, "
            f"kpts on {kpts.device}"
        )
    if pred.device.index != torch.cuda.current_device():
        raise ValueError(
            f"heatmap_mse launches on the current device, cuda:{torch.cuda.current_device()}; "
            f"pred is on {pred.device}"
        )
    if pred.dtype not in _ELEM:
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
    if not pred.is_contiguous():
        raise ValueError("heatmap_mse needs contiguous NHWC pred")
    row = kpts.stride(1)
    if kpts.stride(2) != 1 or row not in (2, 3) or kpts.stride(0) != row * (c - 1):
        raise ValueError(
            f"heatmap_mse reads kpts as rows of 2 or 3 floats, (B, K, 2) or a (B, K, 3)[..., :2] "
            f"view; got strides {kpts.stride()}"
        )
    return row


class _Kernels(NamedTuple):
    forward: Callable[..., int]
    backward: Callable[..., int]
    error_string: Callable[[int], bytes]


@functools.lru_cache(maxsize=None)
def _kernels() -> _Kernels:
    """The library's entry points, built, loaded and typed once."""
    lib = build.load("heatmap_mse")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.heatmap_mse_forward.restype = i32
    lib.heatmap_mse_forward.argtypes = (
        [i32, ptr, ptr, i32, ptr, ptr] + [i32] * 5 + [f32] + [i32] * 3 + [ptr]
    )
    lib.heatmap_mse_backward.restype = i32
    lib.heatmap_mse_backward.argtypes = (
        [i32, ptr, ptr, i32, ptr, ptr] + [i32] * 5 + [f32] + [i32] * 3 + [ptr]
    )
    lib.heatmap_mse_error_string.restype = ctypes.c_char_p
    lib.heatmap_mse_error_string.argtypes = [i32]
    return _Kernels(lib.heatmap_mse_forward, lib.heatmap_mse_backward, lib.heatmap_mse_error_string)


@functools.lru_cache(maxsize=None)
def _num_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device, stream) -> the forward's partial-sum slots, smallest first.  No
# slots are ever freed: a CUDA graph keeps writing and polling the slots it
# was captured with, so a plan that needs more adds a larger tensor and the
# old ones stay alive.  Slots made inside a capture are zeroed only when the
# graph replays, so they go to _captured, which eager calls never take from.
_scratch: Dict[Tuple[int, int], List[torch.Tensor]] = {}
_captured: List[torch.Tensor] = []


def _forward_slots(device: torch.device, stream: int, partials: int) -> torch.Tensor:
    """The forward's slots on ``stream``: zeroed when they are made (the
    kernel leaves them at 0), and never freed."""
    held = _scratch.setdefault((device.index, stream), [])
    if held and held[-1].numel() >= partials:
        return held[-1]
    slots = torch.zeros(partials, dtype=torch.int64, device=device)
    (_captured if torch.cuda.is_current_stream_capturing() else held).append(slots)
    return slots


def _launch_plan(pred: torch.Tensor, kpts: torch.Tensor):
    """Checks, then (row stride, plan, stream) for a launch on pred's device."""
    row = _check(pred, kpts)
    index = pred.device.index
    b, h, w, c = pred.shape
    # the raw current stream of the device, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    return row, tile_plan(b, h, w, c, pred.dtype, _num_sms(index)), stream


def _launch(entry, name, pred, kpts, row, plan, stream, operand, out, stride, sigma) -> None:
    """One launch of ``heatmap_mse_forward`` (operand: the slots, out: the
    loss) or ``heatmap_mse_backward`` (operand: g, out: dpred)."""
    b, h, w, c = pred.shape
    rc = entry(
        0 if pred.dtype == torch.float32 else 1, pred.data_ptr(), kpts.data_ptr(), row,
        operand.data_ptr(), out.data_ptr(),
        b, h, w, c - 1, int(stride), float(sigma) * float(sigma),
        plan.tile_pixels, plan.tiles_per_block, plan.blocks, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {_kernels().error_string(rc).decode()}")


def _forward(pred: torch.Tensor, kpts: torch.Tensor, stride: int, sigma: float) -> torch.Tensor:
    row, plan, stream = _launch_plan(pred, kpts)
    slots = _forward_slots(pred.device, stream, plan.partials)
    loss = torch.empty((), dtype=torch.float32, device=pred.device)
    _launch(_kernels().forward, "heatmap_mse_forward", pred, kpts, row, plan, stream, slots, loss,
            stride, sigma)
    heatmap_mse.launches += 1
    return loss


def heatmap_mse_backward(
    pred: torch.Tensor, kpts: torch.Tensor, g: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """dL/dpred of :func:`heatmap_mse` for the 0-dim cotangent ``g``, read
    on the device (no host sync).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if pred.device.type == "cpu":
        return heatmap_mse_backward_reference(pred, kpts, g, stride, sigma)
    row, plan, stream = _launch_plan(pred, kpts)
    if g.device != pred.device or g.dtype != torch.float32:
        g = g.to(device=pred.device, dtype=torch.float32)
    if g.numel() != 1:
        raise ValueError(f"heatmap_mse_backward takes a one-element cotangent, got {tuple(g.shape)}")
    dpred = torch.empty_like(pred)
    _launch(_kernels().backward, "heatmap_mse_backward", pred, kpts, row, plan, stream, g, dpred,
            stride, sigma)
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
        return _forward(pred, kpts, stride, sigma)

    @staticmethod
    def backward(ctx, g):
        pred, kpts = ctx.saved_tensors
        return heatmap_mse_backward(pred, kpts, g, ctx.stride, ctx.sigma), None, None, None


def heatmap_mse(
    pred: torch.Tensor, kpts: torch.Tensor, stride: int = 8, sigma: float = 3.0
) -> torch.Tensor:
    """``mean((pred - targets(kpts))^2)`` as a 0-dim f32 tensor, without
    building the targets in memory.  pred: (B, H, W, K+1) heatmaps, f32 or
    bf16; kpts: (B, K, 2) f32 pixel coordinates, contiguous or the
    ``[..., :2]`` view of (B, K, 3).  Differentiable in ``pred`` through the
    backward kernel.  CPU tensors take the plain versions; CUDA tensors
    launch the kernels or raise."""
    return _HeatmapMSE.apply(pred, kpts, stride, sigma)


heatmap_mse.launches = 0
