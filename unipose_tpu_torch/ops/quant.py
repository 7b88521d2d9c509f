"""Int8 quantization of the bandwidth-bound ResNet front end (stem, layer1,
layer2) for serving.

Counterpart of ``unipose_tpu/ops/quant.py``, with the same scheme:
symmetric and zero-point free (quantized 0 is real 0, so conv padding stays
exact), weights per output channel, activations per tensor with static
scales calibrated once from a representative batch (max-abs / 127), int32
accumulation and an f32 epilogue ``acc * (w_scale * s) + b``.  The conv is
the hand-written ``unipose::conv_i8`` kernel (``ops/kernels/conv_i8.py``),
which returns the int32 accumulator exactly as the JAX ``conv_i8`` does.

Layout is the JAX one: NHWC tensors and HWIO weights (the kernel's packed
rows are made once, in :func:`quantize_conv`).  :func:`fold_frontend` reads
the port's ``ResNet101`` modules, which keep the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from unipose_tpu_torch.ops.kernels import conv_i8 as conv_i8_kernel

# ----------------------------------------------------------------------------
# Folding and quantization primitives
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class FoldedConv:
    """A conv with its following eval-mode BatchNorm folded in."""

    w: torch.Tensor  # (kh, kw, cin, cout) f32
    b: torch.Tensor  # (cout,) f32
    stride: int = 1
    padding: int = 0
    dilation: int = 1


@dataclasses.dataclass
class QuantConv:
    """Int8 twin of a FoldedConv: s8 weights + per-channel dequant scale,
    and the weights packed for the kernel (``conv_i8.pack_weight``)."""

    w_i8: torch.Tensor  # (kh, kw, cin, cout) int8
    w_scale: torch.Tensor  # (cout,) f32: w ~= w_i8 * w_scale
    b: torch.Tensor  # (cout,) f32
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    w_packed: Optional[torch.Tensor] = None  # (cout, Kp) int8

    def __post_init__(self):
        if self.w_packed is None:
            self.w_packed = conv_i8_kernel.pack_weight(self.w_i8)


def fold_bn(
    w: torch.Tensor,
    bn_params: Dict[str, torch.Tensor],
    bn_stats: Dict[str, torch.Tensor],
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    eps: float = 1e-5,
) -> FoldedConv:
    """Fold eval-mode BN (running stats) into the preceding HWIO conv.

    y = gamma * (conv(x, w) - mean) / sqrt(var + eps) + beta
      = conv(x, w * s) + (beta - mean * s),   s = gamma / sqrt(var + eps)
    """
    s = bn_params["weight"].float() * torch.rsqrt(bn_stats["running_var"].float() + eps)
    return FoldedConv(
        w=(w.float() * s).contiguous(),
        b=(bn_params["bias"].float() - bn_stats["running_mean"].float() * s).contiguous(),
        stride=stride,
        padding=padding,
        dilation=dilation,
    )


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an HWIO kernel."""
    amax = w.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_i8, scale


def quantize_conv(fc: FoldedConv) -> QuantConv:
    w_i8, w_scale = quantize_weight(fc.w)
    return QuantConv(
        w_i8=w_i8,
        w_scale=w_scale,
        b=fc.b,
        stride=fc.stride,
        padding=fc.padding,
        dilation=fc.dilation,
    )


def conv_i8(x_i8: torch.Tensor, qc: QuantConv) -> torch.Tensor:
    """s8 x s8 -> s32 conv: (B, H, W, Cin) int8 -> (B, Ho, Wo, Cout) int32."""
    kh, kw = qc.w_i8.shape[:2]
    return conv_i8_kernel.conv_i8(
        x_i8, qc.w_packed, int(kh), int(kw), qc.stride, qc.padding, qc.dilation
    )


# ----------------------------------------------------------------------------
# Front-end graph (stem + layer1 + layer2), shared between modes
# ----------------------------------------------------------------------------

# (layer index, planes, n_blocks, first stride) for the front end.
_FRONTEND_STAGES = ((1, 64, 3, 1), (2, 128, 4, 2))


def frontend_conv_specs() -> Dict[str, Tuple[int, int]]:
    """name -> (stride, padding) for every conv in the front end."""
    specs: Dict[str, Tuple[int, int]] = {"conv1": (2, 3)}
    for layer, _planes, n_blocks, stride in _FRONTEND_STAGES:
        for i in range(n_blocks):
            s = stride if i == 0 else 1
            specs[f"layer{layer}.{i}.conv1"] = (1, 0)
            specs[f"layer{layer}.{i}.conv2"] = (s, 1)
            specs[f"layer{layer}.{i}.conv3"] = (1, 0)
            if i == 0:
                specs[f"layer{layer}.0.downsample.0"] = (s, 0)
    return specs


def fold_frontend(resnet) -> Dict[str, FoldedConv]:
    """Fold each front-end conv+BN pair of a ``models.resnet.ResNet101``
    (``conv1``/``bn1``, ``layer{L}.{i}.conv{1..3}/bn{1..3}``,
    ``layer{L}.0.downsample.{0,1}``; the 7x7 stem, not ``stem_s2d``) into
    HWIO f32 weights and biases."""
    modules = dict(resnet.named_modules())
    folded: Dict[str, FoldedConv] = {}
    with torch.no_grad():
        for name, (stride, padding) in frontend_conv_specs().items():
            if name == "conv1":
                bn = "bn1"
            elif name.endswith("downsample.0"):
                bn = name[: -len("0")] + "1"
            else:
                bn = name.replace("conv", "bn")
            m = modules[bn]
            folded[name] = fold_bn(
                modules[name].weight.permute(2, 3, 1, 0),  # OIHW -> HWIO
                {"weight": m.weight, "bias": m.bias},
                {"running_mean": m.running_mean, "running_var": m.running_var},
                stride=stride,
                padding=padding,
                eps=m.eps,
            )
    return folded


# The "quantized-domain value" threaded through the shared graph below is a
# (tensor, scale) pair: (int8, python-float scale) on the int8 path,
# (f32/bf16, 1.0) on the calibration/baseline path.
_QVal = Tuple[torch.Tensor, float]


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad 1 max pool of an NHWC tensor, -inf padding."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _run_frontend(
    x: torch.Tensor,
    conv: Callable[[str, _QVal], torch.Tensor],
    requant: Callable[[str, torch.Tensor], _QVal],
    deq: Callable[[_QVal], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stem+layer1+layer2 graph (NHWC), parameterized over the numeric
    mode, as the JAX ``_run_frontend``.

    ``conv(name, qv)`` maps a quantized-domain value through conv ``name``
    into the real-valued domain (scale + bias applied); ``requant(name, h)``
    maps a real-valued tensor into the quantized domain for point ``name``;
    ``deq(qv)`` maps back to real values (for residual adds / the output).
    The stem's max pool runs before its requantisation: rounding and
    clipping do not decrease, so they commute with the max and the codes are
    the ones the JAX function pools.

    Returns (layer2 output, layer1 output) — the latter is ResNet101's
    ``low_level_feat`` (stride 4, 256ch), which the decoder consumes.
    """
    qv = requant("input", x)
    h = torch.relu(conv("conv1", qv))
    qv = requant("stem", _max_pool(h))

    low_level = None
    for layer, _planes, n_blocks, _stride in _FRONTEND_STAGES:
        for i in range(n_blocks):
            blk = f"layer{layer}.{i}"
            h = torch.relu(conv(f"{blk}.conv1", qv))
            q1 = requant(f"{blk}.relu1", h)
            h = torch.relu(conv(f"{blk}.conv2", q1))
            q2 = requant(f"{blk}.relu2", h)
            h = conv(f"{blk}.conv3", q2)
            if i == 0:
                residual = conv(f"layer{layer}.0.downsample.0", qv)
            else:
                residual = deq(qv)
            h = torch.relu(h + residual)
            qv = requant(f"{blk}.out", h)
        if layer == 1:
            low_level = deq(qv)
    return deq(qv), low_level


def frontend_f32(
    folded: Dict[str, FoldedConv],
    x: torch.Tensor,
    *,
    dtype: torch.dtype = torch.float32,
    record: Optional[Dict[str, torch.Tensor]] = None,
    return_low: bool = False,
):
    """Folded-conv front end in f32/bf16 on NHWC ``x``.  With ``record``
    given, stores the max-abs at every requantization point (static
    calibration pass; the stem's is taken after its max pool, which leaves
    the max-abs of a ReLU output unchanged)."""

    def conv(name, qv):
        fc = folded[name]
        y = F.conv2d(
            qv[0].to(dtype).permute(0, 3, 1, 2),
            fc.w.to(dtype).permute(3, 2, 0, 1),
            stride=fc.stride,
            padding=fc.padding,
            dilation=fc.dilation,
        )
        return y.permute(0, 2, 3, 1).float() + fc.b

    def requant(name, h):
        if record is not None:
            record[name] = h.abs().amax()
        return (h.to(dtype), 1.0)

    out, low = _run_frontend(x, conv, requant, lambda qv: qv[0].float())
    return (out, low) if return_low else out


@torch.no_grad()
def calibrate_frontend(folded: Dict[str, FoldedConv], x: torch.Tensor) -> Dict[str, float]:
    """Static per-tensor activation scales from one representative batch."""
    record: Dict[str, torch.Tensor] = {}
    frontend_f32(folded, x, record=record)
    return {k: max(float(v), 1e-12) / 127.0 for k, v in record.items()}


def frontend_int8(
    qconvs: Dict[str, QuantConv],
    act_scales: Dict[str, float],
    x: torch.Tensor,
    *,
    out_dtype: torch.dtype = torch.float32,
    return_low: bool = False,
):
    """w8a8 front end on NHWC ``x``: int8 tensors between convs, f32
    epilogues."""

    def requant(name, h):
        s = act_scales[name]
        q = torch.clamp(torch.round(h.float() / s), -127, 127).to(torch.int8)
        return (q, s)

    def conv(name, qv):
        q, s = qv
        qc = qconvs[name]
        y = conv_i8(q, qc)
        return y.float() * (qc.w_scale * s) + qc.b

    def deq(qv):
        return qv[0].float() * qv[1]

    out, low = _run_frontend(x, conv, requant, deq)
    out = out.to(out_dtype)
    return (out, low.to(out_dtype)) if return_low else out


def quantize_frontend(folded: Dict[str, FoldedConv]) -> Dict[str, QuantConv]:
    return {name: quantize_conv(fc) for name, fc in folded.items()}
