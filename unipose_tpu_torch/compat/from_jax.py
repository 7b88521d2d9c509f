"""JAX variables -> this package's ``state_dict`` (image model).

Counterpart of ``unipose_tpu/compat/torch_export.py::export_state_dict``
(:41-91), image variant.  Takes the flax ``{"params", "batch_stats"}`` tree
as numpy arrays (the caller runs ``jax.device_get``; this module never
imports jax) and returns what ``UniPose.load_state_dict(strict=True)``
takes:
  * conv kernels HWIO -> OIHW (4-D ``weight`` leaves);
  * ``running_mean``/``running_var`` merged beside their module's params;
  * ``num_batches_tracked`` set to 0.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(variables.get("params", {})).items():
        if value.ndim == 4 and key.endswith(".weight"):
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[key] = torch.from_numpy(np.array(value, order="C"))
    for key, value in _flatten(variables.get("batch_stats", {})).items():
        out[key] = torch.from_numpy(np.array(value, order="C"))
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64
            )
    return out
