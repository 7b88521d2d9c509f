"""UniPose image model: ResNet-101 -> WASP -> decoder -> (B, K+1, H/8, W/8).

Counterpart of ``unipose_tpu/models/unipose.py`` (Reference: model/unipose.py):
  * composition :20-22, forward :27-38;
  * output resized to the input size (align corners) only when stride != 8
    (:31-32);
  * heatmaps are NCHW here, and f32 whatever the compute dtype;
  * ``freeze_bn``: train mode keeps every BatchNorm in eval mode (running
    statistics used, not updated; affine parameters still train), the
    JAX package's ``use_running_average=(not train) or freeze_bn``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from unipose_tpu_torch import resolve_device
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.decoder import Decoder
from unipose_tpu_torch.models.layers import init_weights
from unipose_tpu_torch.models.resnet import ResNet101
from unipose_tpu_torch.models.unipose_lstm import UniPoseLSTM
from unipose_tpu_torch.models.wasp import WASP
from unipose_tpu_torch.ops.resize import bilinear_resize

FULL_DEPTH = (3, 4, 23, 3)


class UniPose(nn.Module):
    def __init__(
        self,
        num_classes: int = 14,
        output_stride: int = 16,
        stride: int = 8,
        wasp_double_conv2: bool = True,
        bbox_head: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        layers: Tuple[int, int, int, int] = FULL_DEPTH,
        freeze_bn: bool = False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.freeze_bn = freeze_bn
        self.stride = stride
        self.bbox_head = bbox_head
        self.compute_dtype = compute_dtype
        self.backbone = ResNet101(output_stride=output_stride, layers=layers)
        self.wasp = WASP(output_stride=output_stride, double_conv2=wasp_double_conv2)
        self.decoder = Decoder(num_classes, bbox_head=bbox_head)

    def train(self, mode: bool = True) -> "UniPose":
        super().train(mode)
        if mode and self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor):
        """(B, 3, H, W) normalised images -> (B, K+1, H/8, W/8) f32 heatmaps
        (and (B, 5, H/8, W/8) box maps with ``bbox_head``)."""
        # channels-last end to end: cuDNN's fast layout, and the NHWC view
        # WASP hands to its kernel costs no copy
        x = x.to(self.compute_dtype, memory_format=torch.channels_last)
        feats, low_level = self.backbone(x)
        y = self.decoder(self.wasp(feats), low_level)
        if self.stride != 8:
            y = bilinear_resize(y, x.shape[2:])
        y = y.float()  # heatmaps stay f32 whatever the compute dtype
        if self.bbox_head:
            k = self.num_classes + 1
            return y[:, :k], y[:, k:]
        return y


def build_model(
    config: ModelConfig, layers: Tuple[int, int, int, int] = FULL_DEPTH
) -> nn.Module:
    """Factory mirroring the reference constructors (model/unipose.py:9,
    model/uniposeLSTM.py:68), by ``config.variant``.  ``layers`` cuts the
    backbone's depth (tests and the golden checks)."""
    if config.variant == "lstm":
        return UniPoseLSTM(
            num_classes=config.num_classes,
            output_stride=config.output_stride,
            stride=config.stride,
            wasp_double_conv2=config.wasp_double_conv2,
            compute_dtype=config.compute_dtype,
            layers=layers,
            freeze_bn=config.freeze_bn,
            head_positive_bias=config.head_positive_bias,
            remat_scan=config.remat_scan,
            remat_tower=config.remat_tower,
        )
    if config.variant != "image":
        raise ValueError(f"unknown variant {config.variant!r}")
    return UniPose(
        num_classes=config.num_classes,
        output_stride=config.output_stride,
        stride=config.stride,
        wasp_double_conv2=config.wasp_double_conv2,
        compute_dtype=config.compute_dtype,
        layers=layers,
        freeze_bn=config.freeze_bn,
    )


def init_model(
    config: ModelConfig,
    seed: int = 0,
    device=None,
    layers: Tuple[int, int, int, int] = FULL_DEPTH,
) -> nn.Module:
    """Build a model of ``config.variant`` with the reference's init drawn
    from ``seed`` (on the CPU, so a seed gives the same weights on every
    device), in eval mode on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    model = build_model(config, layers=layers)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device, memory_format=torch.channels_last).eval()


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """A ``state_dict`` for ``model`` drawn with numpy from ``seed``, so the
    JAX package can load the same weights: He-normal fan_out conv weights,
    small random conv biases (the LSTM's and the head's too), and BN affine parameters and running
    statistics perturbed as tests/test_parity_full.py:47-61 does, so that
    eval-mode BN is a real transform."""
    rng = np.random.RandomState(seed)
    kinds = {name: type(m) for name, m in model.named_modules()}
    out = {}
    for key, t in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            out[key] = np.zeros((), np.int64)
        elif issubclass(kinds[owner], nn.BatchNorm2d):
            out[key] = {
                "weight": lambda: 1.0 + 0.1 * rng.randn(*shape),
                "bias": lambda: 0.05 * rng.randn(*shape),
                "running_mean": lambda: 0.1 * rng.randn(*shape),
                "running_var": lambda: 0.8 + 0.4 * rng.rand(*shape),
            }[leaf]().astype(np.float32)
        elif leaf == "weight":  # conv, OIHW
            fan_out = shape[0] * shape[2] * shape[3]
            out[key] = (rng.randn(*shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        else:  # conv bias
            out[key] = (0.05 * rng.randn(*shape)).astype(np.float32)
    return out


def load_numpy_state_dict(model: nn.Module, state: Dict[str, np.ndarray]) -> nn.Module:
    """``model.load_state_dict(strict=True)`` from numpy arrays, copied to
    wherever the model lives."""
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    return model
