"""Parameter audit.

Counterpart of the parameter half of ``unipose_tpu/utils/summary.py``
(Reference: utils/utils.py:713-829, ``get_model_summary``): counts over
``model.named_parameters()``, grouped by the model's top-level modules,
whose names are the JAX parameter tree's top-level keys (``backbone``,
``wasp``, ``decoder``).  The compiled-FLOP report (``compiled_flops``,
``model_summary``) waits for the long-tail slice.
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def per_module_params(model: nn.Module) -> Dict[str, int]:
    return {name: count_params(sub) for name, sub in model.named_children()}
