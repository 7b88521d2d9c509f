"""Per-joint accuracy report, format-compatible with the reference's
``printAccuracies`` (Reference: utils/utils.py:354-473) but driven by
DatasetSpec joint names instead of seven hand-unrolled print blocks.

A copy of ``unipose_tpu/eval/report.py``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from unipose_tpu_torch.core.config import DATASETS


def _format_block(title: str, mean: float, values: np.ndarray, names) -> str:
    lines = [f"{title}: {mean * 100:.2f}%"]
    labeled = [f"Void = {values[0] * 100:2.2f}%"]
    labeled += [
        f"{name} = {values[i + 1] * 100:2.2f}%" for i, name in enumerate(names)
    ]
    for start in range(0, len(labeled), 5):
        lines.append("  " + ", ".join(labeled[start : start + 5]))
    return "\n".join(lines)


def format_accuracies(
    mAP: float,
    AP: np.ndarray,
    mPCKh: float,
    PCKh: np.ndarray,
    mPCK: float,
    PCK: np.ndarray,
    dataset: str,
) -> str:
    names: Sequence[str] = DATASETS[dataset].joint_names
    parts = [
        _format_block("\nmAP", mAP, AP, names),
        _format_block("mPCK", mPCK, PCK, names),
        _format_block("mPCKh", mPCKh, PCKh, names),
    ]
    return "\n".join(parts)


def print_accuracies(mAP, AP, mPCKh, PCKh, mPCK, PCK, dataset) -> None:
    print(format_accuracies(mAP, AP, mPCKh, PCKh, mPCK, PCK, dataset))
