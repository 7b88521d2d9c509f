"""Fused eval-mode WASP: the hand-written CUDA kernel, its plain PyTorch
version and the BN folding they share.

Counterpart of ``unipose_tpu/ops/pallas/wasp_cascade.py``.  The kernel is
``csrc/wasp_cascade.cu`` (its header says what bounds it and how it is laid
out); this module folds the weights, checks what the kernel is given and
launches it.  The public functions keep the JAX layout: NHWC in, NHWC out.

Two algebraic simplifications are baked into the folded weights, as on the
TPU: eval-mode BatchNorm folded into each conv, and the double ``conv2``
(wasp.py:72-80, linear after linear) collapsed to one 1x1 with ``W2 @ W2``.

The bf16 kernel cuts the K loop of a product with fewer output tiles than
the card has SMs into slices (:func:`split_plan`, computed here and passed
to the kernel, so that a CPU test can check it).

The kernel is the registered op ``unipose::wasp_cascade`` (the folded
tensors in :data:`FOLDED` order, and the three dilations): its CPU
implementation is the plain version, its CUDA implementation the launch,
and a fake implementation gives ``torch.export`` the output's shape and
dtype.  ``wasp_cascade.launches`` counts inside the CUDA implementation.
A FLOP formula (:func:`cascade_macs`) lets ``FlopCounterMode`` count the
op, whose inside it does not see.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from unipose_tpu_torch.ops.kernels import build

C_IN, C_MID = 2048, 256
GAP_SPLIT = 16  # spatial slices of the GAP partial sums (csrc GAP_SPLIT)
TILE_M, TILE_N, TILE_K = 64, 128, 64  # the bf16 kernel's tile (csrc TBM, TBN, TBK)
WEIGHTS = ("w1", "w2", "w3", "w4", "w2eff", "wg", "wc")
BIASES = ("b1", "b2", "b3", "b4", "bg", "bc")
FOLDED = WEIGHTS + BIASES  # the op's order of the folded tensors
_SHAPES = {
    "w1": (C_IN, C_MID),
    "w2": (3, 3, C_MID, C_MID),
    "w3": (3, 3, C_MID, C_MID),
    "w4": (3, 3, C_MID, C_MID),
    "w2eff": (C_MID, C_MID),
    "wg": (C_IN, C_MID),
    "wc": (5 * C_MID, C_MID),
    **{k: (C_MID,) for k in BIASES},
}


class Product(NamedTuple):
    """One of the cascade's six products as the bf16 kernel runs it."""

    name: str
    rows: int    # M
    k: int       # contraction depth (dilated: active taps * 256)
    tiles: int   # TILE_M x TILE_N output tiles
    slices: int  # K slices (1: not split); slice i of n takes K steps
    #              [i * steps // n, (i + 1) * steps // n), steps = k // TILE_K


def active_taps(d: int, s: int) -> List[Tuple[int, int]]:
    """Taps (ky, kx) of a 3x3 conv of dilation d on an s x s map that reach
    a real pixel, in the kernel's order (csrc active_taps)."""
    return [(ky, kx) for ky in range(3) for kx in range(3)
            if abs((ky - 1) * d) < s and abs((kx - 1) * d) < s]


def cascade_macs(b: int, s: int, dilations: Sequence[int]) -> int:
    """Multiply-adds of the folded WASP's products on (B, S, S, 2048): the
    1x1 of aspp1, each dilated 3x3 at its active taps, the collapsed conv2
    (``W2 @ W2``) once on each of the four branches, the GAP branch's 1x1
    and the 1x1 over the concatenation.  The GAP's sum is not a product."""
    m = b * s * s
    macs = m * C_IN * C_MID + sum(m * len(active_taps(d, s)) * C_MID * C_MID for d in dilations)
    return macs + 4 * m * C_MID * C_MID + b * C_IN * C_MID + m * 5 * C_MID * C_MID


def split_plan(b: int, s: int, dilations: Sequence[int], sms: int) -> List[Product]:
    """The bf16 kernel's split-K plan: a product with at least ``sms``
    output tiles is not split; one with fewer has its K steps cut into
    min(steps, ceil(sms / tiles)) contiguous slices, so that the card is
    full.  A pure function of (B, S, dilations, SM count)."""
    m = b * s * s
    shapes = [("aspp1", m, C_IN)]
    shapes += [(f"x{i + 2}", m, len(active_taps(d, s)) * C_MID) for i, d in enumerate(dilations)]
    shapes += [("branches", 4 * m, C_MID), ("concat", m, 5 * C_MID)]
    plan = []
    for name, rows, k in shapes:
        tiles = -(-rows // TILE_M) * (C_MID // TILE_N)
        slices = 1 if tiles >= sms else min(k // TILE_K, -(-sms // tiles))
        plan.append(Product(name, rows, k, tiles, slices))
    return plan


def _bn_scale_bias(bn) -> tuple:
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


@torch.no_grad()
def fold_wasp_params(wasp) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BN into the conv weights of a ``models.wasp.WASP`` and
    collapse its double conv2.  Returns f32 tensors on the module's device:
    1x1 weights as (in, out) matrices, 3x3 weights as HWIO, as the JAX
    ``fold_wasp_params`` (:44-88) does from its HWIO kernels."""

    def matrix(conv):  # OIHW (O, I, 1, 1) -> (I, O)
        return conv.weight[:, :, 0, 0].float().t()

    out = {}
    s, b = _bn_scale_bias(wasp.aspp1.bn)
    out["w1"], out["b1"] = matrix(wasp.aspp1.atrous_conv) * s, b
    for i, module in ((2, wasp.aspp2), (3, wasp.aspp3), (4, wasp.aspp4)):
        s, b = _bn_scale_bias(module.bn)
        out[f"w{i}"] = module.atrous_conv.weight.float().permute(2, 3, 1, 0) * s
        out[f"b{i}"] = b
    w2 = matrix(wasp.conv2)
    out["w2eff"] = w2 @ w2 if wasp.double_conv2 else w2
    wg = matrix(wasp.global_avg_pool[1])
    if wasp.gap_batchnorm:
        s, b = _bn_scale_bias(wasp.global_avg_pool[2])
        out["wg"], out["bg"] = wg * s, b
    else:
        out["wg"], out["bg"] = wg, torch.zeros_like(wg[0])
    s, b = _bn_scale_bias(wasp.bn1)
    out["wc"], out["bc"] = matrix(wasp.conv1) * s, b
    return {k: v.contiguous() for k, v in out.items()}


def cast_folded(folded: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Weights in the compute dtype, biases f32 (the JAX wrapper's casts,
    :181-182), done once instead of at every call."""
    out = {}
    for k, v in folded.items():
        want = dtype if k in WEIGHTS else torch.float32
        # the tensor itself when it is already cast, so that an exported
        # program holding cast weights records no conversion
        out[k] = v if v.dtype == want and v.is_contiguous() else v.to(want).contiguous()
    return out


def wasp_cascade_reference(
    x: torch.Tensor, folded: Dict[str, torch.Tensor], dilations: Sequence[int] = (18, 12, 6)
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (B, S, S, 2048) ->
    (B, S, S, 256) in x.dtype, with the Pallas kernel's rounding points.
    Every product is taken in f32 on operands of x.dtype (bf16 products are
    exact in f32), as the kernel's f32 accumulation does."""
    b, s, _, _ = x.shape
    dt = x.dtype
    w = cast_folded(folded, dt)

    def mm(a, k):  # (rows, K) @ w[k], f32 accumulation
        return a.float() @ w[k].float()

    xs = x.reshape(b * s * s, C_IN)
    x1 = torch.relu(mm(xs, "w1") + w["b1"]).to(dt).reshape(b, s, s, C_MID)

    def dilated(t, k, bias, d):
        padded = F.pad(t, (0, 0, d, d, d, d))
        acc = torch.zeros(b * s * s, C_MID, dtype=torch.float32, device=x.device)
        for ki in range(3):
            for kj in range(3):
                if abs((ki - 1) * d) >= s or abs((kj - 1) * d) >= s:
                    continue  # the tap falls wholly in the zero padding
                shifted = padded[:, ki * d : ki * d + s, kj * d : kj * d + s, :]
                acc = acc + shifted.reshape(-1, C_MID).float() @ w[k][ki, kj].float()
        return torch.relu(acc + w[bias]).to(dt).reshape(b, s, s, C_MID)

    x2 = dilated(x1, "w2", "b2", dilations[0])
    x3 = dilated(x2, "w3", "b3", dilations[1])
    x4 = dilated(x3, "w4", "b4", dilations[2])

    branches = [mm(t.reshape(-1, C_MID), "w2eff").to(dt) for t in (x1, x2, x3, x4)]

    gap = x.float().mean(dim=(1, 2)).to(dt)  # (B, 2048), mean in f32
    x5 = torch.relu(mm(gap, "wg") + w["bg"]).to(dt)
    x5 = x5[:, None, :].expand(b, s * s, C_MID).reshape(b * s * s, C_MID)

    cat = torch.cat([*branches, x5], dim=-1)  # (B*S*S, 1280)
    y = torch.relu(mm(cat, "wc") + w["bc"])
    return y.reshape(b, s, s, C_MID).to(dt)


def _check(x: torch.Tensor, folded: Dict[str, torch.Tensor], dilations) -> None:
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != C_IN:
        raise ValueError(f"wasp_cascade expects (B, S, S, {C_IN}), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wasp_cascade takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("wasp_cascade needs a contiguous, 16-byte-aligned NHWC input")
    if len(dilations) != 3 or min(dilations) < 1:
        raise ValueError(f"wasp_cascade needs three dilations >= 1, got {dilations}")
    for k, shape in _SHAPES.items():
        t = folded[k]
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"folded[{k!r}] is {tuple(t.shape)} on {t.device}; "
                f"want {shape} on {x.device}"
            )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _library() -> ctypes.CDLL:
    lib = build.load("wasp_cascade")
    if lib.wasp_cascade_forward.argtypes is None:
        lib.wasp_cascade_forward.restype = ctypes.c_int
        lib.wasp_cascade_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 20 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.wasp_cascade_error_string.restype = ctypes.c_char_p
        lib.wasp_cascade_error_string.argtypes = [ctypes.c_int]
        lib.wasp_mma_blocks_per_sm.restype = ctypes.c_int
        lib.wasp_mma_blocks_per_sm.argtypes = []
    return lib


def blocks_per_sm() -> int:
    """Blocks of the bf16 tensor-core GEMM resident on one SM at once (CUDA's
    occupancy calculator, on the current card)."""
    return _library().wasp_mma_blocks_per_sm()


def wasp_cascade(
    x: torch.Tensor, folded: Dict[str, torch.Tensor], dilations: Sequence[int] = (18, 12, 6)
) -> torch.Tensor:
    """Fused WASP eval forward: (B, S, S, 2048) -> (B, S, S, 256) in x.dtype,
    through the op ``unipose::wasp_cascade``.

    ``folded``: :func:`fold_wasp_params` output (weights are cast to x.dtype,
    biases to f32; pass :func:`cast_folded` output to skip the casts).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    w = cast_folded(folded, x.dtype)
    return torch.ops.unipose.wasp_cascade(x, [w[k] for k in FOLDED], [int(d) for d in dilations])


wasp_cascade.launches = 0


@torch.library.custom_op("unipose::wasp_cascade", mutates_args=(), device_types="cpu")
def _wasp_cascade_op(x: torch.Tensor, folded: List[torch.Tensor], dilations: List[int]) -> torch.Tensor:
    return wasp_cascade_reference(x, dict(zip(FOLDED, folded)), dilations)


@_wasp_cascade_op.register_kernel("cuda")
def _wasp_cascade_cuda(x, folded, dilations):
    w = dict(zip(FOLDED, folded))
    _check(x, w, dilations)
    dt = x.dtype
    if any(t.dtype != (dt if k in WEIGHTS else torch.float32) for k, t in w.items()):
        raise TypeError("wasp_cascade needs weights in x.dtype and f32 biases (cast_folded)")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in w.values()):
        raise ValueError("wasp_cascade needs contiguous, 16-byte-aligned folded weights")
    b, s = x.shape[0], x.shape[1]
    m = b * s * s
    with torch.cuda.device(x.device):
        out = torch.empty((b, s, s, C_MID), dtype=dt, device=x.device)
        xs = torch.empty((4, m, C_MID), dtype=dt, device=x.device)
        br = torch.empty((4, m, C_MID), dtype=dt, device=x.device)
        partial = torch.empty((b, GAP_SPLIT, C_IN), dtype=torch.float32, device=x.device)
        x5 = torch.empty((b, C_MID), dtype=dt, device=x.device)
        # the f32 CUDA-core path does not split (0 SMs: every product fills them)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count if dt == torch.bfloat16 else 0
        plan = split_plan(b, s, dilations, sms)
        ws_elems = max((p.slices * p.rows * C_MID for p in plan if p.slices > 1), default=0)
        ws = torch.empty(ws_elems, dtype=torch.float32, device=x.device) if ws_elems else None
        lib = _library()
        rc = lib.wasp_cascade_forward(
            0 if dt == torch.float32 else 1,
            _ptr(x),
            _ptr(w["w1"]), _ptr(w["b1"]),
            _ptr(w["w2"]), _ptr(w["b2"]),
            _ptr(w["w3"]), _ptr(w["b3"]),
            _ptr(w["w4"]), _ptr(w["b4"]),
            _ptr(w["w2eff"]),
            _ptr(w["wg"]), _ptr(w["bg"]),
            _ptr(w["wc"]), _ptr(w["bc"]),
            _ptr(out), _ptr(xs), _ptr(br), _ptr(partial), _ptr(x5),
            None if ws is None else _ptr(ws),
            b, s, int(dilations[0]), int(dilations[1]), int(dilations[2]),
            *(p.slices for p in plan),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"wasp_cascade launch failed: {lib.wasp_cascade_error_string(rc).decode()}"
        )
    wasp_cascade.launches += 1
    return out


@_wasp_cascade_op.register_fake
def _(x, folded, dilations):
    b, s = x.shape[0], x.shape[1]
    return x.new_empty((b, s, s, C_MID))


@register_flop_formula(torch.ops.unipose.wasp_cascade)
def _(x_shape, folded_shapes, dilations, *, out_shape=None, **kwargs) -> int:
    return 2 * cascade_macs(x_shape[0], x_shape[1], dilations)
