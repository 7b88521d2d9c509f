"""Decoder / heatmap head, NCHW.

Counterpart of ``unipose_tpu/models/decoder.py`` (Reference:
model/modules/decoder.py):
  * low-level features (stride 4, 256ch) -> 1x1 -> 48ch + BN + ReLU, then a
    3x3/2 maxpool to stride 8 (:17-19,:33,:39-41,:47);
  * WASP output resized (align corners) to the pooled low-level size (:49),
    concat -> 304ch (:51);
  * head: [3x3 256 + BN + ReLU + Dropout(0.5), 3x3 256 + BN + ReLU +
    Dropout(0.1), 1x1 -> num_classes+1] (:22-30).

The reference's unused ``conv2/bn2`` (decoder.py:20-21) is left out, as in
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unipose_tpu_torch.models.layers import Dropout, batch_norm, conv
from unipose_tpu_torch.ops.pooling import max_pool2d
from unipose_tpu_torch.ops.resize import bilinear_resize


class Decoder(nn.Module):
    def __init__(self, num_classes: int, bbox_head: bool = False, bn_groups: int = 1):
        super().__init__()
        self.conv1 = conv(256, 48, 1)
        self.bn1 = batch_norm(48, bn_groups)
        # +5 bounding-box channels (center + 4 corners): the reference's
        # commented-out variant (decoder.py:31 ``num_classes+5+1``).
        out_ch = num_classes + 1 + (5 if bbox_head else 0)
        # indices 0, 1, 4, 5, 8 carry the reference's keys (decoder.py:22-30)
        self.last_conv = nn.Sequential(
            conv(304, 256, 3, padding=1),
            batch_norm(256, bn_groups),
            nn.ReLU(),
            Dropout(0.5),
            conv(256, 256, 3, padding=1),
            batch_norm(256, bn_groups),
            nn.ReLU(),
            Dropout(0.1),
            conv(256, out_ch, 1, bias=True),
        )

    def forward(self, x: torch.Tensor, low_level_feat: torch.Tensor) -> torch.Tensor:
        llf = torch.relu(self.bn1(self.conv1(low_level_feat)))
        llf = max_pool2d(llf, 3, 2, 1)
        x = bilinear_resize(x, llf.shape[2:])
        return self.last_conv(torch.cat([x, llf], dim=1))
