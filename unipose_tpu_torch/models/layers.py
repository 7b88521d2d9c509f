"""Shared building blocks: the conv and BatchNorm factories, their init, and
the dtype policy.

Counterpart of ``unipose_tpu/models/layers.py``.  Layout is NCHW with OIHW
weights; module names mirror the reference's ``state_dict`` keys
(Reference: unipose.py:79-90).

dtype policy, as in the JAX package: parameters and BN statistics stay f32;
a conv runs in its input's dtype, with its weight cast once to that dtype
(the JAX ``Conv`` casts its kernel at every call); BatchNorm computes in f32
and returns its input's dtype (``nn.BatchNorm2d`` takes a bf16 input with
f32 parameters and does exactly that, and ``TorchBatchNorm``'s own paths
do the same).
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
    torch_default_init: bool = False,
    bias_positive: bool = False,
) -> Conv2d:
    """The conv factory (torch ``nn.Conv2d`` arguments), with the init
    family that :func:`init_weights` gives it (JAX layers.py:138-161):
    He-normal fan_out by default, the reference's explicit init for the
    backbone, WASP and decoder; with ``torch_default_init``, torch's own
    ``nn.Conv2d`` init, U(+-1/sqrt(fan_in)) for weight and bias, which the
    reference's ConvLSTM and 11x11 head keep since it never re-inits them.
    The difference matters to training from scratch: He fan_out weights are
    ~2.5x larger at the head's fan-in, and behind its final ReLU output
    channels die at init.  ``bias_positive`` sets the bias to +1/sqrt(fan_in)
    so that every such channel starts alive."""
    m = Conv2d(
        in_ch, out_ch, kernel_size,
        stride=stride, padding=padding, dilation=dilation, bias=bias,
    )
    m.torch_default_init = torch_default_init
    m.bias_positive = bias_positive
    return m


class TorchBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with the JAX package's two
    train-mode extensions (JAX layers.py:22-120).  A subclass, so the
    ``state_dict`` keys, the kernels' BN folding and the remat stand-in
    buffers (``models/resnet.py::_bn_stats_frozen``) see a BatchNorm2d.

    * Eval, and train mode with neither extension: ``nn.BatchNorm2d``.
    * ``stat_groups = g`` (one process): each contiguous group of B/g rows
      is normalised with its own moments (per-shard, "ghost" BatchNorm);
      the running statistics update from the pooled moments of the whole
      batch, which is the g = 1 update.  A batch that g does not divide
      raises ``ValueError``.
    * ``process_group`` set (training across ranks, each holding its rows
      of the global batch): with ``sync`` the moments are the global
      batch's, taken with two autograd all-reduces (sum and count give the
      mean, then the sum of squared deviations about it gives the
      variance: the two-pass form, not E[x^2] - E[x]^2), so the gradient
      flows across ranks as the global batch's would.  Without ``sync``
      each rank normalises with its own moments, and the running statistics
      update from the pooled moments, all-reduced without a gradient, so
      every rank's buffers stay equal with no broadcast (the
      ``stat_groups`` semantics with one group a rank).

    Statistics are f32 (f64 for an f64 input) whatever the input's dtype;
    the output takes the input's dtype.
    """

    def __init__(self, channels: int, stat_groups: int = 1):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.stat_groups = int(stat_groups)
        self.process_group = None
        self.sync = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or (self.stat_groups == 1 and self.process_group is None):
            return super().forward(x)
        if self.stat_groups > 1 and self.process_group is not None:
            raise ValueError("stat_groups and process_group are mutually exclusive")
        b, c = x.shape[:2]
        g = self.stat_groups
        if b % g:
            raise ValueError(f"batch {b} is not divisible by stat_groups={g}")
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = (0,) + tuple(range(2, x.dim()))
        per_c = (1, c) + (1,) * (x.dim() - 2)
        if g > 1:
            xg = xf.reshape((g, b // g) + tuple(x.shape[1:]))
            gaxes = (1,) + tuple(range(3, xg.dim()))
            d = xg - xg.mean(gaxes, keepdim=True)
            y = (d * torch.rsqrt(d.square().mean(gaxes, keepdim=True) + self.eps)).reshape(xf.shape)
            with torch.no_grad():
                mean, var, n = _pooled_moments(xf.detach(), axes, None)
        elif self.sync:
            mean, var, n = _pooled_moments(xf, axes, self.process_group)
            y = (xf - mean.reshape(per_c)) * torch.rsqrt(var.reshape(per_c) + self.eps)
        else:
            d = xf - xf.mean(axes, keepdim=True)
            y = d * torch.rsqrt(d.square().mean(axes, keepdim=True) + self.eps)
            with torch.no_grad():
                mean, var, n = _pooled_moments(xf.detach(), axes, self.process_group)
        y = y * self.weight.reshape(per_c) + self.bias.reshape(per_c)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            unbiased = var.detach() * n / (n - 1.0).clamp(min=1.0)
            self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def _pooled_moments(xf: torch.Tensor, axes, group):
    """(mean, biased variance, count) per channel of ``xf`` over ``axes``
(the count a 0-dim tensor: no value is read back to the host),
    and over every rank of ``group`` when one is given: two all-reduces,
    the sum and count first, then the squared deviations about the global
    mean.  Under autograd the all-reduces carry the gradient across ranks
    (``torch.distributed.nn.functional.all_reduce``)."""
    total = torch.cat([xf.sum(axes), xf.new_full((1,), xf.numel() / xf.shape[1])])
    if group is not None:
        total = _all_reduce(total, group)
    n = total[-1]
    mean = total[:-1] / n
    shape = (1, -1) + (1,) * (xf.dim() - 2)
    sq = (xf - mean.reshape(shape)).square().sum(axes)
    if group is not None:
        sq = _all_reduce(sq, group)
    return mean, sq / n, n.detach()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of ``group``: through autograd when ``t`` needs a
    gradient (whose backward is the same sum), in place otherwise."""
    import torch.distributed as dist

    if t.requires_grad:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=group)
    dist.all_reduce(t, group=group)
    return t


def batch_norm(channels: int, stat_groups: int = 1) -> TorchBatchNorm:
    """The BatchNorm factory: ``TorchBatchNorm`` (eps 1e-5, momentum 0.1)
    with ``stat_groups`` groups of per-shard statistics in training."""
    return TorchBatchNorm(channels, stat_groups)


def set_bn_process_group(module: nn.Module, group, sync: bool = True) -> None:
    """Every ``TorchBatchNorm`` under ``module`` takes its train-mode
    statistics across the ranks of ``group`` (``sync``: global moments;
    otherwise per-rank moments with pooled running statistics)."""
    for m in module.modules():
        if isinstance(m, TorchBatchNorm):
            m.process_group = group
            m.sync = sync


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
        # (rank, ranks) in data-parallel training, (d, n_data, j, n_time,
        # t_loc) in time-parallel: draw the mask of the global batch and
        # keep this rank's rows, so that the ranks' masks are the one
        # process's (see forward)
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        if self.shard is None:
            mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        else:
            d, n_data, j, n_time, t_loc = self.shard if len(self.shard) == 5 else self.shard + (0, 1, 1)
            b = x.shape[0]
            if b % t_loc:
                raise ValueError(f"{b} rows are not clips of {t_loc} frames")
            # the global batch's tensor laid out as x (rows outermost), so
            # the generator fills it as it fills the one process's mask;
            # its rows are (clip, frame) of B = n_data * b_loc clips of
            # T = n_time * t_loc frames, and this rank's are clips
            # d * b_loc + i, frames j * t_loc + k: global row
            # (d * b_loc + i) * T + j * t_loc + k (with one frame a row and
            # n_time = 1, rows d * b .. (d + 1) * b)
            full = x.new_empty_strided((b * n_data * n_time,) + tuple(x.shape[1:]), x.stride())
            full = full.bernoulli_(keep, generator=self.generator)
            blocks = full.unflatten(0, (n_data, b // t_loc, n_time, t_loc))
            mask = blocks[d, :, j].reshape(x.shape)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


def use_dropout_generator(module: nn.Module, generator, shard=None) -> None:
    """Make every ``Dropout`` under ``module`` draw from ``generator``; with
    ``shard = (rank, ranks)``, the rank's rows of the global batch's mask;
    with ``shard = (d, n_data, j, n_time, t_loc)``, the rank at (d, j) of a
    (data, time) mesh keeps its clips' rows, and of each clip its
    ``t_loc`` frames."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.shard = shard


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Every conv's init from ``generator``, by the family :func:`conv` gave
    it: the reference's explicit init for backbone, WASP and decoder convs
    (resnet.py:126-133, wasp.py:92-103), He-normal fan_out weights and zero
    biases; or torch's default, U(+-1/sqrt(fan_in)) (``bias_positive``: the
    bias at +1/sqrt(fan_in)).  BatchNorm keeps its default (weight 1, bias 0,
    mean 0, var 1)."""
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        if getattr(m, "torch_default_init", False):
            bound = m.weight[0].numel() ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                if m.bias_positive:
                    m.bias.fill_(bound)
                else:
                    m.bias.uniform_(-bound, bound, generator=generator)
        else:
            nn.init.kaiming_normal_(
                m.weight, mode="fan_out", nonlinearity="relu", generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
