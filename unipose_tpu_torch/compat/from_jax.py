"""JAX variables -> this package's ``state_dict`` (image and video models).

Counterpart of ``unipose_tpu/compat/torch_export.py::export_state_dict``
(:41-91).  Takes the flax ``{"params", "batch_stats"}`` tree as numpy arrays
(the caller runs ``jax.device_get``; this module never imports jax) and
returns what ``UniPose``/``UniPoseLSTM.load_state_dict(strict=True)`` takes:
  * conv kernels HWIO -> OIHW (4-D ``weight`` leaves);
  * ``running_mean``/``running_var`` merged beside their module's params;
  * ``num_batches_tracked`` set to 0;
  * ``variant="lstm"``: the fused ``lstm.conv_{x,h}_gates`` split along O
    into per-gate ``lstm.conv_{g,i,o,f}{x,h}_lstm`` in gate order, and the
    head ``head.convN`` re-rooted to ``convN`` (the inverse of JAX
    torch_convert.py:190-209).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from unipose_tpu_torch.models.unipose_lstm import GATE_ORDER


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def state_dict_from_jax(
    variables: Mapping[str, Any], variant: str = "image"
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(variables.get("params", {})).items():
        if value.ndim == 4 and key.endswith(".weight"):
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        parts = key.split(".")
        if variant == "lstm" and parts[0] == "lstm" and parts[1] in ("conv_x_gates", "conv_h_gates"):
            xh = "x" if parts[1] == "conv_x_gates" else "h"
            for g, gv in zip(GATE_ORDER, np.split(value, len(GATE_ORDER), axis=0)):
                out[f"lstm.conv_{g}{xh}_lstm.{parts[2]}"] = torch.from_numpy(np.array(gv, order="C"))
            continue
        if variant == "lstm" and parts[0] == "head":
            key = ".".join(parts[1:])
        out[key] = torch.from_numpy(np.array(value, order="C"))
    for key, value in _flatten(variables.get("batch_stats", {})).items():
        out[key] = torch.from_numpy(np.array(value, order="C"))
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64
            )
    return out
