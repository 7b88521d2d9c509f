"""Reference PyTorch checkpoints -> this package's models.

Counterpart of ``unipose_tpu/compat/torch_convert.py`` (:61-90, :128-188),
without the layout transforms: this package already uses the reference's
keys and OIHW layout.  What stays is the reference's partial-load
semantics (Reference: unipose.py:79-90): keys the model lacks, or whose
shapes differ, are skipped; parameters the checkpoint lacks keep their
values.  The dead ``decoder.conv2/bn2`` (decoder.py:20-21) fall out here.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn as nn


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``*.pth.tar`` as a flat {key: tensor} dict on the CPU.

    Accepts a raw state_dict or the reference's ``{'state_dict': ...}``
    wrapper (utils/utils.py:53-56) and strips the ``module.`` prefix that
    DataParallel adds.  The file is unpickled, so load only checkpoints from
    a trusted source.
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return out


@torch.no_grad()
def load_state_dict_intersection(
    model: nn.Module, state: Mapping[str, torch.Tensor]
) -> Dict[str, List[str]]:
    """Copy every entry of ``state`` whose key and shape the model has;
    returns the 'loaded' and 'skipped' keys."""
    own = model.state_dict()
    report = {"loaded": [], "skipped": []}
    for key, value in state.items():
        target = own.get(key)
        if target is None or tuple(target.shape) != tuple(value.shape):
            report["skipped"].append(key)
            continue
        target.copy_(value)
        report["loaded"].append(key)
    return report
