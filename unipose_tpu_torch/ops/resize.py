"""``align_corners=True`` bilinear resize on NCHW tensors.

Counterpart of ``unipose_tpu/ops/resize.py``, whose parity target was
``F.interpolate(mode="bilinear", align_corners=True)`` as used at
Reference: model/modules/wasp.py:83, model/modules/decoder.py:49 and
model/unipose.py:32.  Here it is that call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, out_h, out_w), align-corners bilinear."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
