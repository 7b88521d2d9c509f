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

``remat_blocks`` (JAX resnet.py:122-150): in train mode under autograd each
bottleneck is a ``torch.utils.checkpoint`` segment, so the backward keeps
only block boundaries and recomputes one block at a time.  The recompute
runs the block's BatchNorms again in train mode; they normalise with the
batch's moments as the first pass did, but must not update their running
statistics a second time (Flax's functional collections update them once):
``_bn_stats_frozen`` hands them stand-ins for the recompute.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from unipose_tpu_torch.models.layers import batch_norm, conv
from unipose_tpu_torch.ops.kernels.fused_stem import (  # noqa: F401 (space_to_depth: public here)
    cast_folded,
    fold_stem_params,
    fused_stem,
    space_to_depth,
)
from unipose_tpu_torch.ops.pooling import max_pool2d


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
        bn_groups: int = 1,
    ):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes, bn_groups)
        # the stride sits on the 3x3 conv (resnet.py:13-15)
        self.conv2 = conv(
            planes, planes, 3, stride=stride, dilation=dilation, padding=dilation
        )
        self.bn2 = batch_norm(planes, bn_groups)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4, bn_groups)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(conv(inplanes, planes * 4, 1, stride=stride),
                          batch_norm(planes * 4, bn_groups))
            if has_downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


@contextlib.contextmanager
def _bn_stats_frozen(module: nn.Module):
    """Inside the block, ``module``'s BatchNorms update stand-ins for their
    running statistics and ``num_batches_tracked`` (copies, dropped on the
    way out), so the real buffers stay as the first pass left them.  The
    BatchNorms still get running statistics to pass, so the recompute saves
    the same tensors for the backward as the first pass did; in train mode
    they normalise with the batch's moments either way."""
    names = ("running_mean", "running_var", "num_batches_tracked")
    kept = [(m, [getattr(m, n) for n in names])
            for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for m, buffers in kept:
        for n, t in zip(names, buffers):
            setattr(m, n, t.clone())
    try:
        yield
    finally:
        for m, buffers in kept:
            for n, t in zip(names, buffers):
                setattr(m, n, t)


def checkpointed(block: nn.Module, *args):
    """``block(*args)`` as a checkpoint segment: its activations are freed
    after the forward and recomputed, with its BatchNorms' statistics
    frozen, when the backward reaches it.  No random op lies inside a
    bottleneck or a ConvLSTM cell (the decoder's dropout is outside every
    segment), so the RNG state is neither saved nor restored."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _bn_stats_frozen(block)),
    )


class Stage(nn.Sequential):
    """Bottlenecks named '0'..'n-1' (an ``nn.Sequential``, so the keys stay
    ``layer{i}.{j}.*``); with ``remat`` each is a checkpoint segment in
    train mode under autograd."""

    def __init__(self, *blocks: nn.Module, remat: bool = False):
        super().__init__(*blocks)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return super().forward(x)
        for block in self:
            x = checkpointed(block, x)
        return x


def _stage(
    inplanes: int, planes: int, strides: Sequence[int], dilations: Sequence[int],
    remat: bool = False, bn_groups: int = 1,
) -> Stage:
    """Bottlenecks named '0'..'n-1'; the first carries the stride and the
    downsample (resnet.py:77-92)."""
    blocks = []
    for i, (s, d) in enumerate(zip(strides, dilations)):
        blocks.append(
            Bottleneck(inplanes if i == 0 else planes * 4, planes, s, d, has_downsample=i == 0,
                       bn_groups=bn_groups)
        )
    return Stage(*blocks, remat=remat)


class ResNet101(nn.Module):
    """Returns (stride-16 features 2048ch, stride-4 low-level features 256ch).

    ``stem_s2d``: the stem conv is ``conv1_s2d``, a 4x4 stride-1 conv over
    space-to-depth(2) input, padded ((2, 1), (2, 1)): the exact rewrite of
    the 7x7/2 conv (JAX resnet.py:162, :186-196).

    ``remat_blocks``: every bottleneck of the four stages is a checkpoint
    segment in training (JAX resnet.py:170); the stem is not, as in JAX.

    ``bn_groups``: every BatchNorm's ``stat_groups`` (JAX resnet.py:167).
    """

    # The eval-mode stem; a test may set it on an instance to the plain
    # version to compare the two inside one model.
    stem = staticmethod(fused_stem)
    _frozen_stem = ()  # the keys of the stem_* buffers, after freeze()

    def __init__(
        self,
        output_stride: int = 16,
        layers: Tuple[int, int, int, int] = (3, 4, 23, 3),
        multi_grid: Tuple[int, ...] = (1, 2, 4),
        stem_s2d: bool = False,
        remat_blocks: bool = False,
        bn_groups: int = 1,
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
        self.bn1 = batch_norm(64, bn_groups)
        self.relu = nn.ReLU(inplace=True)
        self._folded = None

        def stage(i, inplanes, planes):
            n = layers[i]
            return _stage(
                inplanes, planes, [strides[i]] + [1] * (n - 1), [dilations[i]] * n,
                remat=remat_blocks, bn_groups=bn_groups,
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
            remat=remat_blocks,
            bn_groups=bn_groups,
        )

    def freeze(self, dtype: torch.dtype) -> None:
        """Eval only, for an exported program (``compat/export.py``): fold
        the stem for ``dtype`` once into buffers ``stem_<key>``, which the
        eval forward then reads (no cache, nothing folded at a call), and
        drop the stem's conv and BN, which nothing reads any more (the
        train-mode stem goes with them)."""
        folded = cast_folded(fold_stem_params(self), dtype)
        for k, v in folded.items():
            self.register_buffer(f"stem_{k}", v)
        self._frozen_stem = tuple(folded)
        self._folded = None
        for name in ("conv1", "conv1_s2d", "bn1"):
            if hasattr(self, name):
                delattr(self, name)

    def _folded_stem(self, dtype: torch.dtype):
        """Folded stem weights in ``dtype``, rebuilt only when the conv
        weight or a BN tensor changes (version counter or storage; see
        ``Conv2d``) or the dtype does; after :meth:`freeze`, its buffers."""
        if self._frozen_stem:
            return {k: getattr(self, f"stem_{k}") for k in self._frozen_stem}
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
