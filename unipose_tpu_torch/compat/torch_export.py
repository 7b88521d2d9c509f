"""This package's models -> a reference-keyed PyTorch checkpoint.

Counterpart of ``unipose_tpu/compat/torch_export.py::export_state_dict``
(:41-91), which turns JAX variables into the reference's ``state_dict``.
The port's modules already carry the reference's keys and OIHW layout (the
LSTM's per-gate convs and its top-level head too), so the export is the
model's own ``state_dict`` on the host, and :func:`save_reference_checkpoint`
writes it in the reference's ``{'state_dict': ...}`` wrapper
(utils/utils.py:53-56), which ``compat/torch_convert.py::
load_torch_checkpoint`` (and the reference) read back.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def export_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The reference-keyed ``state_dict`` of ``model`` (UniPose or
    UniPose-LSTM: JAX's ``variant`` picks a key map, which the port does not
    need), every tensor a host copy."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_reference_checkpoint(model: nn.Module, path: str) -> str:
    """Write ``{'state_dict': export_state_dict(model)}`` to ``path``."""
    torch.save({"state_dict": export_state_dict(model)}, path)
    return path
