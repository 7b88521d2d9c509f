"""Dilated ResNet-101 backbone with multi-grid layer4, NCHW.

Counterpart of ``unipose_tpu/models/resnet.py``
(Reference: model/modules/backbone/resnet.py):
  * Bottleneck (1x1 -> 3x3(stride, dil) -> 1x1 x4 + residual) :5-42;
  * output_stride 16 => strides [1,2,2,1], dilations [1,1,1,2] :50-53;
  * output_stride 8  => strides [1,2,1,1], dilations [1,1,2,4] :54-56;
  * layer4 is a multi-grid unit, blocks [1,2,4] * dilation :49,:94-111;
  * forward returns (layer4 out, 2048ch; layer1 out at stride 4, 256ch).

Module names are the ``state_dict`` keys: ``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1..3}/bn{1..3}/downsample.{0,1}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from unipose_tpu_torch.models.layers import batch_norm, conv
from unipose_tpu_torch.ops.pooling import max_pool2d


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        has_downsample: bool = False,
    ):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes)
        # the stride sits on the 3x3 conv (resnet.py:13-15)
        self.conv2 = conv(
            planes, planes, 3, stride=stride, dilation=dilation, padding=dilation
        )
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(conv(inplanes, planes * 4, 1, stride=stride), batch_norm(planes * 4))
            if has_downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


def _stage(
    inplanes: int, planes: int, strides: Sequence[int], dilations: Sequence[int]
) -> nn.Sequential:
    """Bottlenecks named '0'..'n-1'; the first carries the stride and the
    downsample (resnet.py:77-92)."""
    blocks = []
    for i, (s, d) in enumerate(zip(strides, dilations)):
        blocks.append(
            Bottleneck(inplanes if i == 0 else planes * 4, planes, s, d, has_downsample=i == 0)
        )
    return nn.Sequential(*blocks)


class ResNet101(nn.Module):
    """Returns (stride-16 features 2048ch, stride-4 low-level features 256ch)."""

    def __init__(
        self,
        output_stride: int = 16,
        layers: Tuple[int, int, int, int] = (3, 4, 23, 3),
        multi_grid: Tuple[int, ...] = (1, 2, 4),
    ):
        super().__init__()
        if output_stride == 16:
            strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
        elif output_stride == 8:
            strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
        else:
            raise NotImplementedError(f"output_stride {output_stride}")

        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)

        def stage(i, inplanes, planes):
            n = layers[i]
            return _stage(
                inplanes, planes, [strides[i]] + [1] * (n - 1), [dilations[i]] * n
            )

        self.layer1 = stage(0, 64, 64)
        self.layer2 = stage(1, 256, 128)
        self.layer3 = stage(2, 512, 256)
        # layer4: multi-grid dilations blocks[i] * dilation (resnet.py:94-111)
        self.layer4 = _stage(
            1024,
            512,
            [strides[3]] + [1] * (len(multi_grid) - 1),
            [m * dilations[3] for m in multi_grid],
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        x = max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        low_level_feat = x
        x = self.layer4(self.layer3(self.layer2(x)))
        return x, low_level_feat
