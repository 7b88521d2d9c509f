"""UniPose forwards (image and video) with a w8a8 int8 front end, for
serving only.

Counterpart of ``unipose_tpu/models/quantized.py``.  The ResNet front end
(stem, layer1, layer2) runs quantized (``ops/quant.py``): int8 tensors
between convs, each conv one call of the ``conv_i8_requant`` kernel (s8 x
s8 -> s32 on the tensor cores, the f32 epilogue fused), static calibrated
activation scales.  Layer3/4, WASP (its ``wasp_cascade`` kernel) and the
decoder, and for video the ConvLSTM and the head, are the modules of the
same model, so their weights are not copied.  Only ``output_stride=16`` is
assembled, and video serves fresh-state clips only, as in JAX.

Layout: the front end is NHWC (the kernel's); its outputs become the
model's NCHW as channels-last views, which costs no copy.  The forwards
take normalised NHWC inputs and return NHWC heatmaps in f32, the JAX
package's contract, so ``compat/export.py`` exports them as the JAX
``forward=`` override does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from unipose_tpu_torch.models.unipose_lstm import UniPoseLSTM
from unipose_tpu_torch.ops import quant
from unipose_tpu_torch.ops.kernels import conv_i8 as conv_i8_kernel


class Int8Frontend(nn.Module):
    """Prepared (offline) quantization state for the front end: per conv
    its packed int8 weights (the kernel's layout, held once), per-channel
    scales, the epilogue's combined scales ``w_scale * s_in`` and f32
    biases as buffers (so an exported program holds them), with the
    kernel's shape, stride and padding; and the activation scales, python
    floats baked into the program as constants."""

    def __init__(self, qconvs: Dict[str, quant.QuantConv], act_scales: Dict[str, float]):
        super().__init__()
        self.names = tuple(qconvs)
        self.specs = {}
        for i, (name, qc) in enumerate(qconvs.items()):
            self.register_buffer(f"p{i}", qc.w_packed.contiguous())
            self.register_buffer(f"s{i}", qc.w_scale.float().contiguous())
            self.register_buffer(f"b{i}", qc.b.float().contiguous())
            self.specs[name] = (tuple(qc.w_i8.shape[:3]), qc.stride, qc.padding, qc.dilation)
        self.act_scales = {k: float(v) for k, v in act_scales.items()}
        for i, scale in enumerate(quant.combined_scales(qconvs, self.act_scales).values()):
            self.register_buffer(f"c{i}", scale.float().contiguous())

    @property
    def qconvs(self) -> Dict[str, quant.QuantConv]:
        """The QuantConvs; ``w_i8`` is a view of the packed weights."""
        out = {}
        for i, name in enumerate(self.names):
            (kh, kw, cin), stride, padding, dilation = self.specs[name]
            packed = getattr(self, f"p{i}")
            out[name] = quant.QuantConv(
                w_i8=conv_i8_kernel.unpack_weight(packed, kh, kw, cin), w_scale=getattr(self, f"s{i}"),
                b=getattr(self, f"b{i}"), stride=stride, padding=padding, dilation=dilation, w_packed=packed,
            )
        return out

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype = torch.float32):
        """NHWC normalised images -> (layer2 output, layer1 output), NHWC."""
        scales = {name: getattr(self, f"c{i}") for i, name in enumerate(self.names)}
        return quant.frontend_int8(self.qconvs, self.act_scales, x, out_dtype=out_dtype, return_low=True,
                                   scales=scales)


@torch.no_grad()
def prepare_int8_frontend(model: nn.Module, calib_x: torch.Tensor) -> Int8Frontend:
    """Fold BN, quantize weights, and calibrate activation scales from one
    representative NHWC batch ``calib_x`` (normalised).  ``model`` is a
    ``UniPose`` or ``UniPoseLSTM`` (its backbone is read)."""
    folded = quant.fold_frontend(model.backbone)
    scales = quant.calibrate_frontend(folded, calib_x)
    return Int8Frontend(quant.quantize_frontend(folded), scales)


class Int8ImageForward(nn.Module):
    """The int8 image forward as a module: ``fe`` and the model's own
    layer3, layer4, WASP and decoder (what ``compat/export.py::
    export_inference(forward=)`` exports; the rest of the model, whose
    front end ``fe`` replaces, is not held)."""

    def __init__(self, model: nn.Module, fe: Int8Frontend, dtype: torch.dtype):
        super().__init__()
        self.fe, self.compute_dtype = fe, dtype
        self.layer3, self.layer4 = model.backbone.layer3, model.backbone.layer4
        self.wasp, self.decoder = model.wasp, model.decoder

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC normalised frames -> the decoder's (N, K+1, H/8, W/8)."""
        out2, low_level = self.fe(x, out_dtype=self.compute_dtype)
        # NHWC -> NCHW as channels-last views, no copy
        h = self.layer4(self.layer3(out2.permute(0, 3, 1, 2)))
        return self.decoder(self.wasp(h), low_level.permute(0, 3, 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tower(x).float().permute(0, 2, 3, 1)


def int8_image_forward(
    model: nn.Module,
    fe: Int8Frontend,
    x: torch.Tensor,
    *,
    output_stride: int = 16,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Eval-mode UniPose forward: int8 front end + layer3/4, WASP and
    decoder in ``dtype``.  (B, H, W, 3) normalised -> (B, H/8, W/8, K+1)
    f32.  Only ``output_stride=16`` (the reference's) is assembled."""
    if output_stride != 16:
        raise NotImplementedError("int8 frontend is assembled for output_stride=16")
    return Int8ImageForward(model, fe, dtype)(x)


def int8_forward_fn(
    model: nn.Module, calib_x: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16
) -> Tuple[Int8Frontend, Int8ImageForward]:
    """Prepare the quantized front end and return (state, forward)."""
    fe = prepare_int8_frontend(model, calib_x)
    return fe, Int8ImageForward(model, fe, dtype)


class Int8VideoForward(Int8ImageForward):
    """The int8 video forward as a module: the int8 image tower over the
    B*T frames, then ``UniPoseLSTM.temporal`` (its ConvLSTM cells and head,
    the model's own modules) from a fresh state; gates and carry in f32."""

    head = UniPoseLSTM.head
    features = UniPoseLSTM.features
    scan = UniPoseLSTM.scan
    heat = UniPoseLSTM.heat
    temporal = UniPoseLSTM.temporal

    def __init__(self, model: nn.Module, fe: Int8Frontend, dtype: torch.dtype):
        super().__init__(model, fe, dtype)
        self.lstm_0, self.lstm = model.lstm_0, model.lstm
        for n in range(1, 6):
            setattr(self, f"conv{n}", getattr(model, f"conv{n}"))
        self.num_classes, self.remat_scan = model.num_classes, False

    def forward(self, frames: torch.Tensor, centermap: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = frames.shape
        y = self.tower(frames.reshape(b * t, h, w, c))
        heat, _ = self.temporal(y, centermap.permute(0, 1, 4, 2, 3))
        return heat.permute(0, 1, 3, 4, 2)


def int8_video_forward(
    model: nn.Module,
    fe: Int8Frontend,
    frames: torch.Tensor,
    centermap: torch.Tensor,
    *,
    output_stride: int = 16,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Eval-mode UniPose-LSTM forward with the int8 front end: (B, T, H, W,
    3) normalised frames and (B, T, H, W, 1) centermaps -> (B, T, H/8, W/8,
    K+1) f32, from a fresh state (:class:`Int8VideoForward`)."""
    if output_stride != 16:
        raise NotImplementedError("int8 frontend is assembled for output_stride=16")
    return Int8VideoForward(model, fe, dtype)(frames, centermap)


def int8_video_forward_fn(
    model: nn.Module, calib_frames: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16
) -> Tuple[Int8Frontend, Int8VideoForward]:
    """Prepare the quantized front end (calibrated on the flattened
    (B, T, H, W, 3) frames) and return (state, forward(frames, centermap))."""
    b, t = calib_frames.shape[:2]
    fe = prepare_int8_frontend(model, calib_frames.reshape(b * t, *calib_frames.shape[2:]))
    return fe, Int8VideoForward(model, fe, dtype)
