"""Dilated ResNet-101 backbone with multi-grid layer4, NCHW.

Counterpart of ``unipose_tpu/models/resnet.py``
(Reference: model/modules/backbone/resnet.py):
  * Bottleneck (1x1 -> 3x3(stride, dil) -> 1x1 x4 + residual) :5-42;
  * output_stride 16 => strides [1,2,2,1], dilations [1,1,1,2] :50-53;
  * output_stride 8  => strides [1,2,1,1], dilations [1,1,2,4] :54-56;
  * layer4 is a multi-grid unit, blocks [1,2,4] * dilation :49,:94-111;
  * forward returns (layer4 out, 2048ch; layer1 out at stride 4, 256ch).

Module names are the ``state_dict`` keys: ``conv1`` (or ``conv1_s2d`` with
``stem_s2d``), ``bn1``, ``layer{1..4}.{i}.conv{1..3}/bn{1..3}/downsample.{0,1}``.

In eval mode the stem (conv, BN, ReLU, max pool) is the fused kernel
``fused_stem`` on folded weights; train mode runs the modules.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unipose_tpu_torch.models.layers import batch_norm, conv
from unipose_tpu_torch.ops.kernels.fused_stem import cast_folded, fold_stem_params, fused_stem
from unipose_tpu_torch.ops.pooling import max_pool2d


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """The 7x7/2 stem kernel (7, 7, 3, 64 HWIO) as the exact equivalent 4x4
    stride-1 kernel (4, 4, 12, 64) on space-to-depth(2) input:
    ``w4[ti, tj, (dy, dx, c)] = w7[2ti+dy-1, 2tj+dx-1, c]``, zero where that
    row or column is out of range (JAX resnet.py:37-58)."""
    cin, cout = w7.shape[2], w7.shape[3]
    w4 = w7.new_zeros((4, 4, 4 * cin, cout))
    for ti in range(4):
        for tj in range(4):
            for dy in range(2):
                for dx in range(2):
                    u, v = 2 * ti + dy - 1, 2 * tj + dx - 1
                    if 0 <= u < 7 and 0 <= v < 7:
                        w4[ti, tj, (dy * 2 + dx) * cin : (dy * 2 + dx + 1) * cin] = w7[u, v]
    return w4


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
    """Returns (stride-16 features 2048ch, stride-4 low-level features 256ch).

    ``stem_s2d``: the stem conv is ``conv1_s2d``, a 4x4 stride-1 conv over
    space-to-depth(2) input, padded ((2, 1), (2, 1)): the exact rewrite of
    the 7x7/2 conv (JAX resnet.py:162, :186-196).
    """

    # The eval-mode stem; a test may set it on an instance to the plain
    # version to compare the two inside one model.
    stem = staticmethod(fused_stem)

    def __init__(
        self,
        output_stride: int = 16,
        layers: Tuple[int, int, int, int] = (3, 4, 23, 3),
        multi_grid: Tuple[int, ...] = (1, 2, 4),
        stem_s2d: bool = False,
    ):
        super().__init__()
        if output_stride == 16:
            strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
        elif output_stride == 8:
            strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
        else:
            raise NotImplementedError(f"output_stride {output_stride}")

        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.conv1_s2d = conv(12, 64, 4)
        else:
            self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self._folded = None

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

    def _folded_stem(self, dtype: torch.dtype):
        """Folded stem weights in ``dtype``, rebuilt only when the conv
        weight or a BN tensor changes (version counter or storage; see
        ``Conv2d``) or the dtype does."""
        bn = self.bn1
        w = self.conv1_s2d.weight if self.stem_s2d else self.conv1.weight
        key = (dtype,) + tuple(
            (t.data_ptr(), t._version)
            for t in (w, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        )
        if self._folded is None or self._folded[0] != key:
            self._folded = (key, cast_folded(fold_stem_params(self), dtype))
        return self._folded[1]

    def stem_modules(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_s2d:
            x = space_to_depth(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
            x = self.conv1_s2d(F.pad(x, (2, 1, 2, 1)))
        else:
            x = self.conv1(x)
        return max_pool2d(self.relu(self.bn1(x)), 3, 2, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            x = self.stem_modules(x)
        else:
            y = self.stem(
                x.permute(0, 2, 3, 1).contiguous(),  # free for channels-last input
                self._folded_stem(x.dtype),
            )
            x = y.permute(0, 3, 1, 2)
        x = self.layer1(x)
        low_level_feat = x
        x = self.layer4(self.layer3(self.layer2(x)))
        return x, low_level_feat
