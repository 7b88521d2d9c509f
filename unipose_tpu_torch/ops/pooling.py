"""Max pooling with torch semantics on NCHW tensors.

Counterpart of ``unipose_tpu/ops/pooling.py::max_pool2d``: the ResNet stem
(Reference: model/modules/backbone/resnet.py:65) and the decoder's
low-level downsample (Reference: model/modules/decoder.py:33,47).  Padding
is −inf, so a border window takes the max of its real pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """NCHW max pool, output size floor((H + 2p - k) / s) + 1."""
    return F.max_pool2d(x, kernel, stride, padding)
