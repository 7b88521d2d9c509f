"""Best-only checkpoints of the whole train state, and the warm start from a
reference checkpoint.

Counterpart of the part of ``unipose_tpu/train/checkpoint.py`` that the
trainer calls.  ``save_checkpoint(state, is_best, filename)`` keeps the
reference's best-only semantics (utils/utils.py:53-56; trigger
unipose.py:183-186) but writes the full ``TrainState`` (model, optimizer,
scheduler, dropout generator, step) with ``torch.save``, so that training
resumes exactly from it.
"""

from __future__ import annotations

from typing import Optional

import torch

from unipose_tpu_torch.compat.torch_convert import (
    load_state_dict_intersection,
    load_torch_checkpoint,
)


def save_checkpoint(state, is_best: bool, filename: str = "checkpoint") -> Optional[str]:
    """Write ``state.state_dict()`` to ``<filename>_best`` when ``is_best``;
    returns the path written, else None."""
    if not is_best:
        return None
    path = f"{filename}_best"
    torch.save(state.state_dict(), path)
    return path


def load_checkpoint(state, path: str):
    """Restore a file written by :func:`save_checkpoint` into ``state``
    (tensors go to the devices of the state's own), and return it."""
    device = next(state.model.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return state


def warm_start_from_torch(state, torch_path: str):
    """Key-intersection warm start of ``state.model`` from a reference
    ``*.pth.tar`` (unipose.py:78-90 semantics).  Returns ``state``."""
    report = load_state_dict_intersection(state.model, load_torch_checkpoint(torch_path))
    print(f"warm start: loaded {len(report['loaded'])} tensors, skipped {len(report['skipped'])}")
    return state
