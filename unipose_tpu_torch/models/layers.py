"""Shared building blocks: the conv and BatchNorm factories, their init, and
the dtype policy.

Counterpart of ``unipose_tpu/models/layers.py``.  Layout is NCHW with OIHW
weights; module names mirror the reference's ``state_dict`` keys
(Reference: unipose.py:79-90).

dtype policy, as in the JAX package: parameters and BN statistics stay f32;
a conv runs in its input's dtype, with its weight cast once to that dtype
(the JAX ``Conv`` casts its kernel at every call); BatchNorm computes in f32
and returns its input's dtype (``nn.BatchNorm2d`` takes a bf16 input with
f32 parameters and does exactly that).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype.

    With autograd off, the cast weight is kept and rebuilt only when the
    weight changes (its version counter or storage) or the dtype does.  The
    port's optimizer (``train/optim.py``, ``torch.optim.Adam`` in its
    for-loop or foreach form) moves the version counters of the weights it
    updates; ``Adam(fused=True)`` does not, so a step through it would leave
    this cache stale.
    """

    _cast = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        if torch.is_grad_enabled():
            w = self.weight.to(x.dtype)
            b = None if self.bias is None else self.bias.to(x.dtype)
            return self._conv_forward(x, w, b)
        key = (x.dtype, self.weight.data_ptr(), self.weight._version) + (
            () if self.bias is None else (self.bias.data_ptr(), self.bias._version)
        )
        if self._cast is None or self._cast[0] != key:
            b = None if self.bias is None else self.bias.detach().to(x.dtype)
            self._cast = (key, self.weight.detach().to(x.dtype), b)
        return self._conv_forward(x, self._cast[1], self._cast[2])


def conv(
    in_ch: int,
    out_ch: int,
    kernel_size: int,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    bias: bool = False,
) -> Conv2d:
    """The conv factory (torch ``nn.Conv2d`` arguments)."""
    return Conv2d(
        in_ch, out_ch, kernel_size,
        stride=stride, padding=padding, dilation=dilation, bias=bias,
    )


def batch_norm(channels: int) -> nn.BatchNorm2d:
    """Torch-semantics BatchNorm: eps 1e-5, momentum 0.1."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from an explicit generator.

    The JAX step draws its masks from a key per (seed, step)
    (train/steps.py:53-66); here the train state owns a ``torch.Generator``
    on the model's device and hands it to every ``Dropout`` through
    :func:`use_dropout_generator`, so a run's masks follow from its seed and
    not from the global RNG (which a module without a generator uses).
    Holds no parameters: the ``state_dict`` keys do not change.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


def use_dropout_generator(module: nn.Module, generator) -> None:
    """Make every ``Dropout`` under ``module`` draw from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's explicit init for backbone, WASP and decoder convs
    (resnet.py:126-133, wasp.py:92-103): He-normal fan_out weights and zero
    biases.  BatchNorm keeps its default (weight 1, bias 0, mean 0, var 1).
    """
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(
                m.weight, mode="fan_out", nonlinearity="relu", generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
