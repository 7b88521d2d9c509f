"""Pooling with torch semantics on NCHW tensors.

Counterpart of ``unipose_tpu/ops/pooling.py``:
  * ``max_pool2d``: the ResNet stem (Reference:
    model/modules/backbone/resnet.py:65) and the decoder's low-level
    downsample (Reference: model/modules/decoder.py:33,47).  Padding is
    −inf, so a border window takes the max of its real pixels.
  * ``avg_pool2d``: the centermap pool 9/8/1 (Reference:
    model/uniposeLSTM.py:75,91).  With ``count_include_pad=True`` (torch's
    default) every window divides by kernel², borders included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """NCHW max pool, output size floor((H + 2p - k) / s) + 1."""
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool2d(
    x: torch.Tensor, kernel: int, stride: int, padding: int, *, count_include_pad: bool = True
) -> torch.Tensor:
    """NCHW average pool matching ``nn.AvgPool2d``."""
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=count_include_pad)
