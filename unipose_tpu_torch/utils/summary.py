"""Parameter and FLOP audit.

Counterpart of ``unipose_tpu/utils/summary.py`` (Reference:
utils/utils.py:713-829, ``get_model_summary``): parameters counted over
``model.named_parameters()``, grouped by the model's top-level modules,
whose names are the JAX parameter tree's top-level keys (``backbone``,
``wasp``, ``decoder``); FLOPs of a forward counted by
``torch.utils.flop_counter.FlopCounterMode``, where JAX asks XLA's cost
analysis.

The counter sees each operator once and not inside it.  The eval-mode
forward calls the kernels as the registered ops ``unipose::fused_stem``,
``unipose::wasp_cascade`` and ``unipose::conv_i8``, which it counts
through the formulas registered beside them (``ops/kernels``): 2 x the
multiply-adds of the convolutions the op computes (the stem in its
space-to-depth form, WASP with BN folded and conv2 collapsed to
``W2 @ W2``).  So an eval count is not a train count;
:func:`eval_minus_train_flops` gives the difference term by term.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

# the kernel modules register the ops' FLOP formulas when they are imported
from unipose_tpu_torch.ops.kernels import conv_i8  # noqa: F401
from unipose_tpu_torch.ops.kernels.fused_stem import stem_macs
from unipose_tpu_torch.ops.kernels.wasp_cascade import C_MID, active_taps

_log = logging.getLogger(__name__)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def per_module_params(model: nn.Module) -> Dict[str, int]:
    return {name: count_params(sub) for name, sub in model.named_children()}


def compiled_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)`` under ``FlopCounterMode`` (matmuls,
    convolutions, attention and the registered kernel ops); None when the
    call fails."""
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except Exception:  # a report: say why and go on without the number
        name = getattr(fn, "__name__", type(fn).__name__)
        _log.warning("counting the FLOPs of %s failed", name, exc_info=True)
        return None
    return float(counter.get_total_flops())


def eval_minus_train_flops(b: int, h: int, w: int, s: int, dilations: Sequence[int]) -> Dict[str, int]:
    """The eval-mode FLOP count of UniPose's forward on (B, 3, H, W) minus
    the train-mode count, by term, for WASP on S x S features with the
    cascade's three ``dilations`` and the double conv2 (the default):

      * ``stem_s2d_zero_taps``: the op's space-to-depth stem takes 192
        products an output where the 7x7 conv takes 147;
      * ``wasp_w2_collapse``: eval applies ``W2 @ W2`` once to each of the
        four branches, train applies conv2 twice;
      * ``wasp_padding_taps``: eval skips the dilated taps that fall wholly
        in the zero padding, which the train convs count.

    Neither mode counts BatchNorm (folded into the weights in eval), the
    pools or the elementwise ops.  The fold itself (``W2 @ W2``, 2 x 256^3)
    counts at a forward that rebuilds the folded weights, the first."""
    m = b * s * s
    terms = {
        "stem_s2d_zero_taps": 2 * (stem_macs(b, h, w) - stem_macs(b, h, w, products=147)),
        "wasp_w2_collapse": -2 * 4 * m * C_MID * C_MID,
        "wasp_padding_taps": 2 * sum((len(active_taps(d, s)) - 9) * m * C_MID * C_MID for d in dilations),
    }
    terms["total"] = sum(terms.values())
    return terms


def model_summary(model: nn.Module, *sample_args, train: bool = False) -> str:
    """Human-readable parameter and FLOP report (the totals block of
    utils/utils.py:820-829): one line a top-level module, the total, and
    the forward's FLOPs on ``sample_args`` in eval mode, or in train mode
    with ``train=True``.  The model's mode and buffers (BatchNorm's running
    statistics, which a train-mode forward updates) are restored after."""
    lines = ["Model Summary", "-" * 60]
    for name, n in sorted(per_module_params(model).items()):
        lines.append(f"{name:<24} {n:>14,} params")
    lines.append("-" * 60)
    lines.append(f"Total Parameters: {count_params(model):,}")

    was_training = model.training
    saved = {k: b.clone() for k, b in model.named_buffers()} if train else {}
    model.train(train)
    try:
        flops = compiled_flops(model, *sample_args)
    finally:
        model.train(was_training)
        with torch.no_grad():
            for k, b in model.named_buffers():
                if k in saved and not torch.equal(b, saved[k]):
                    b.copy_(saved[k])
    if flops is not None and math.isfinite(flops):
        lines.append(f"Compiled forward FLOPs: {flops:,.0f} ({flops / 1e9:.2f} GFLOP)")
    return "\n".join(lines)
