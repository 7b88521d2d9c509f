"""Int8 quantization of the bandwidth-bound ResNet front end (stem, layer1,
layer2) for serving.

Counterpart of ``unipose_tpu/ops/quant.py``, with the same scheme:
symmetric and zero-point free (quantized 0 is real 0, so conv padding stays
exact), weights per output channel, activations per tensor with static
scales calibrated once from a representative batch (max-abs / 127), int32
accumulation and an f32 epilogue ``acc * (w_scale * s) + b``.  The conv is
the hand-written kernel of ``ops/kernels/conv_i8.py``: ``unipose::conv_i8``
returns the int32 accumulator exactly as the JAX ``conv_i8`` does, and
``unipose::conv_i8_requant``, which :func:`frontend_int8` calls, runs the
same conv with the epilogue (scale, bias, residual, ReLU, requantisation)
fused, with the arithmetic of the JAX function step for step.

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


def frontend_input_points() -> Dict[str, str]:
    """conv name -> the requantisation point whose codes the conv reads:
    the activation scale of its input, read off :func:`_run_frontend`'s
    graph (each value stands for its point's name)."""
    points: Dict[str, str] = {}

    def conv(name, qv, point, residual=None, deq=False):
        points[name] = qv[1]
        return ((None, point), None) if deq else (None, point)

    _run_frontend(None, lambda name, x: (None, name), conv, lambda qv: qv)
    return points


def combined_scales(qconvs: Dict[str, QuantConv], act_scales: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Each conv's per-channel epilogue scale ``w_scale * s_in`` (f32), the
    torch op the unfused epilogue ran at every call."""
    points = frontend_input_points()
    return {name: qc.w_scale * act_scales[points[name]] for name, qc in qconvs.items()}


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
# (tensor, scale) pair: (int8 codes, python-float scale) on the int8 path,
# (f32/bf16, 1.0) on the calibration/baseline path; a real-valued conv
# output (the downsample's) is (f32, 1.0) on both.
_QVal = Tuple[torch.Tensor, float]


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad 1 max pool of an NHWC tensor, -inf padding."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _run_frontend(
    x: torch.Tensor,
    quantize: Callable[[str, torch.Tensor], _QVal],
    conv: Callable[..., object],
    pool: Callable[[_QVal], _QVal],
    *,
    return_low: bool = True,
):
    """The stem+layer1+layer2 graph (NHWC), parameterized over the numeric
    mode, as the JAX ``_run_frontend``.

    ``quantize(name, x)`` maps the real-valued input into the quantized
    domain of point ``name``.  ``conv(name, qv, point, residual=None,
    deq=False)`` runs conv ``name`` on ``qv`` with its scale and bias; with
    ``point`` None it returns the real-valued output as ``(y, 1.0)``, else
    the codes of ``relu(y + residual)`` at point ``point``, and with
    ``deq`` also their real value: ``(qv, real)``.  ``residual`` is a
    quantized-domain value
    (the block input, or the downsample's real-valued output).  ``pool``
    max-pools the stem's codes: rounding and clipping do not decrease, so
    they commute with the max, and these are the codes of the pooled values
    that the JAX function requantises.

    Returns (layer2 output, layer1 output) — the latter is ResNet101's
    ``low_level_feat`` (stride 4, 256ch), which the decoder consumes; None
    without ``return_low``.
    """
    qv = pool(conv("conv1", quantize("input", x), "stem"))
    low = None
    for layer, _planes, n_blocks, _stride in _FRONTEND_STAGES:
        for i in range(n_blocks):
            blk = f"layer{layer}.{i}"
            q1 = conv(f"{blk}.conv1", qv, f"{blk}.relu1")
            q2 = conv(f"{blk}.conv2", q1, f"{blk}.relu2")
            residual = conv(f"layer{layer}.0.downsample.0", qv, None) if i == 0 else qv
            deq = i == n_blocks - 1 and (layer == 2 or return_low)
            qv = conv(f"{blk}.conv3", q2, f"{blk}.out", residual, deq)
            if deq:
                qv, out = qv
        if layer == 1 and return_low:
            low = out
    return out, low


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
    calibration pass; the stem's is taken before its max pool, whose
    3x3/2 pad-1 windows cover every pixel, so the max-abs is the pooled
    one)."""

    def quantize(name, h):
        if record is not None:
            record[name] = h.abs().amax()
        return (h.to(dtype), 1.0)

    def conv(name, qv, point, residual=None, deq=False):
        fc = folded[name]
        y = F.conv2d(
            qv[0].to(dtype).permute(0, 3, 1, 2),
            fc.w.to(dtype).permute(3, 2, 0, 1),
            stride=fc.stride,
            padding=fc.padding,
            dilation=fc.dilation,
        )
        y = y.permute(0, 2, 3, 1).float() + fc.b
        if point is None:
            return (y, 1.0)
        if residual is not None:
            y = y + residual[0].float()
        qv = quantize(point, torch.relu(y))
        return (qv, qv[0].float()) if deq else qv

    out, low = _run_frontend(x, quantize, conv, lambda qv: (_max_pool(qv[0]), qv[1]), return_low=return_low)
    return (out, low) if return_low else out


@torch.no_grad()
def calibrate_frontend(folded: Dict[str, FoldedConv], x: torch.Tensor) -> Dict[str, float]:
    """Static per-tensor activation scales from one representative batch."""
    record: Dict[str, torch.Tensor] = {}
    frontend_f32(folded, x, record=record)
    return {k: max(float(v), 1e-12) / 127.0 for k, v in record.items()}


def _pool_codes(qv: _QVal) -> _QVal:
    """The stem's codes pooled as f16 (exact: integers up to 2048), which
    max_pool2d takes on every device."""
    return (_max_pool(qv[0].half()).to(torch.int8), qv[1])


def frontend_int8(
    qconvs: Dict[str, QuantConv],
    act_scales: Dict[str, float],
    x: torch.Tensor,
    *,
    scales: Dict[str, torch.Tensor],
    out_dtype: torch.dtype = torch.float32,
    return_low: bool = False,
):
    """w8a8 front end on NHWC ``x``: int8 tensors between convs, the graph
    of :func:`_run_frontend` with each conv one ``unipose::conv_i8_requant``
    call (24 in all) whose epilogue does the f32 work: scale and bias,
    the residual (the downsample's f32 output, or the block input's codes
    dequantised), ReLU, requantisation to the next point's codes, and the
    dequantised stage outputs in ``out_dtype``.  ``scales``: each conv's
    ``w_scale * s_in`` (:func:`combined_scales`; ``Int8Frontend`` holds
    them as buffers).  Codes and outputs equal those of
    :func:`frontend_int8_unfused`."""

    def conv(name, qv, point, residual=None, deq=False):
        qc = qconvs[name]
        kh, kw = qc.w_i8.shape[:2]
        epilogue = {} if point is None else {"out_scale": act_scales[point]}
        if residual is not None:
            epilogue.update(residual=residual[0], residual_scale=residual[1])
        outs = conv_i8_kernel.conv_i8_requant(
            qv[0], qc.w_packed, scales[name], qc.b, int(kh), int(kw), qc.stride, qc.padding, qc.dilation,
            deq_dtype=out_dtype if deq else None, **epilogue,
        )
        qv = (outs[0], 1.0 if point is None else act_scales[point])
        return (qv, outs[1]) if deq else qv

    def quantize(name, h):
        return (conv_i8_kernel.requant(h, act_scales[name]), act_scales[name])

    out, low = _run_frontend(x, quantize, conv, _pool_codes, return_low=return_low)
    return (out, low) if return_low else out


def frontend_int8_unfused(
    qconvs: Dict[str, QuantConv],
    act_scales: Dict[str, float],
    x: torch.Tensor,
    *,
    out_dtype: torch.dtype = torch.float32,
    return_low: bool = False,
):
    """The int8 front end as it ran before its epilogue was fused, the
    yardstick of :func:`frontend_int8`: the int32 ``unipose::conv_i8``,
    then scale, bias, residual, ReLU and requantisation (dividing by a
    Python float) as separate PyTorch ops on the same graph.  On the CPU
    its codes and outputs equal :func:`frontend_int8`'s, bit for bit; on
    the card its divisions multiply by the reciprocal."""

    def quantize(name, h):
        s = act_scales[name]
        return (torch.clamp(torch.round(h.float() / s), -127, 127).to(torch.int8), s)

    def conv(name, qv, point, residual=None, deq=False):
        qc = qconvs[name]
        y = conv_i8(qv[0], qc).float() * (qc.w_scale * qv[1]) + qc.b
        if point is None:
            return (y, 1.0)
        if residual is not None:
            y = y + (residual[0] if residual[0].dtype == torch.float32 else residual[0].float() * residual[1])
        qv = quantize(point, torch.relu(y))
        return (qv, (qv[0].float() * qv[1]).to(out_dtype)) if deq else qv

    out, low = _run_frontend(x, quantize, conv, _pool_codes, return_low=return_low)
    return (out, low) if return_low else out


def quantize_frontend(folded: Dict[str, FoldedConv]) -> Dict[str, QuantConv]:
    return {name: quantize_conv(fc) for name, fc in folded.items()}
