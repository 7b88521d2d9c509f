"""WASP — Waterfall Atrous Spatial Pooling, NCHW.

Counterpart of ``unipose_tpu/models/wasp.py`` (Reference:
model/modules/wasp.py, model/modules/waspVideo.py):
  * ``aspp1`` is a 1x1 conv 2048->256; ``aspp2..4`` are 3x3 atrous convs
    256->256 applied in cascade, dilations [24,18,12,6] at output stride 16
    and [48,36,24,12] at 8 (wasp.py:39-49,66-70);
  * every branch goes through the same 1x1 ``conv2`` twice (wasp.py:72-80);
  * GAP branch: GAP -> 1x1 2048->256 -> BN -> ReLU, resized from 1x1 to the
    branch size, which is a broadcast; the video variant has no BN there
    (``gap_batchnorm=False``);
  * concat 5x256 -> 1x1 ``conv1`` -> BN -> ReLU -> Dropout(0.5) in train mode.

In eval mode the forward is the fused kernel ``wasp_cascade`` on folded
weights; train mode runs the modules above.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unipose_tpu_torch.models.layers import Dropout, batch_norm, conv
from unipose_tpu_torch.ops.kernels.wasp_cascade import (
    cast_folded,
    fold_wasp_params,
    wasp_cascade,
)


class AtrousModule(nn.Module):
    """conv -> BN -> ReLU (Reference: wasp.py:6-20)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int, dilation: int,
                 bn_groups: int = 1):
        super().__init__()
        self.atrous_conv = conv(
            in_ch, out_ch, kernel_size, padding=padding, dilation=dilation
        )
        self.bn = batch_norm(out_ch, bn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.atrous_conv(x)))


class WASP(nn.Module):
    # The eval-mode forward; a test may set it on an instance to the plain
    # version to compare the two inside one model.
    cascade = staticmethod(wasp_cascade)
    _frozen = False  # freeze() has put the folded weights in folded_* buffers

    def __init__(
        self,
        output_stride: int = 16,
        double_conv2: bool = True,
        gap_batchnorm: bool = True,
        dropout_rate: float = 0.5,
        bn_groups: int = 1,
    ):
        super().__init__()
        if output_stride == 16:
            self.dilations = (24, 18, 12, 6)
        elif output_stride == 8:
            self.dilations = (48, 36, 24, 12)
        else:
            raise NotImplementedError(f"output_stride {output_stride}")
        d = self.dilations
        self.double_conv2 = double_conv2
        self.gap_batchnorm = gap_batchnorm
        g = bn_groups
        self.aspp1 = AtrousModule(2048, 256, 1, padding=0, dilation=d[0], bn_groups=g)
        self.aspp2 = AtrousModule(256, 256, 3, padding=d[1], dilation=d[1], bn_groups=g)
        self.aspp3 = AtrousModule(256, 256, 3, padding=d[2], dilation=d[2], bn_groups=g)
        self.aspp4 = AtrousModule(256, 256, 3, padding=d[3], dilation=d[3], bn_groups=g)
        # Sequential indices are the reference's keys (wasp.py:51-54).
        gap = [nn.AdaptiveAvgPool2d(1), conv(2048, 256, 1)]
        if gap_batchnorm:
            gap.append(batch_norm(256, g))
        gap.append(nn.ReLU())
        self.global_avg_pool = nn.Sequential(*gap)
        self.conv2 = conv(256, 256, 1)
        self.conv1 = conv(1280, 256, 1)
        self.bn1 = batch_norm(256, g)
        self.dropout = Dropout(dropout_rate)
        self._folded = None

    def freeze(self, dtype: torch.dtype) -> None:
        """Eval only, for an exported program (``compat/export.py``): fold
        the weights for ``dtype`` once into buffers ``folded_<key>``, which
        the eval forward then reads (no cache, nothing folded at a call),
        and drop the modules folded into them (the train-mode forward goes
        with them)."""
        for k, v in cast_folded(fold_wasp_params(self), dtype).items():
            self.register_buffer(f"folded_{k}", v)
        self._frozen = True
        self._folded = None
        for name in ("aspp1", "aspp2", "aspp3", "aspp4", "global_avg_pool", "conv2", "conv1", "bn1"):
            delattr(self, name)

    def _folded_weights(self, dtype: torch.dtype):
        """Folded weights in ``dtype``, rebuilt only when any weight or BN
        statistic changes (version counter or storage; see ``Conv2d``) or
        the dtype does; after :meth:`freeze`, its buffers."""
        if self._frozen:
            return {k[len("folded_"):]: v for k, v in self.named_buffers() if k.startswith("folded_")}
        key = (dtype,) + tuple(
            (t.data_ptr(), t._version)
            for t in (*self.parameters(), *self.buffers())
        )
        if self._folded is None or self._folded[0] != key:
            self._folded = (key, cast_folded(fold_wasp_params(self), dtype))
        return self._folded[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = self.cascade(
                x.permute(0, 2, 3, 1).contiguous(),  # free for channels-last input
                self._folded_weights(x.dtype),
                self.dilations[1:],
            )
            return y.permute(0, 3, 1, 2)

        x1 = self.aspp1(x)
        x2 = self.aspp2(x1)
        x3 = self.aspp3(x2)
        x4 = self.aspp4(x3)
        branches = [self.conv2(t) for t in (x1, x2, x3, x4)]
        if self.double_conv2:
            branches = [self.conv2(t) for t in branches]
        x5 = self.global_avg_pool(x).expand(-1, -1, *branches[-1].shape[2:])
        y = torch.relu(self.bn1(self.conv1(torch.cat([*branches, x5], dim=1))))
        return self.dropout(y)
