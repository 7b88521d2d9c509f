"""Multi-person decoding for the box-head model.

Counterpart of ``unipose_tpu/postproc/multi_person.py`` (Reference:
utils/uniPose.py:14-199, ``uniPose_kpts``).  The box-head model
(``UniPose(bbox_head=True)``) gives K+1 joint channels and 5 box channels
(center and four corners); the peaks of the box channels enumerate the
people, and each person's joints are argmaxed inside their box window.

The peak detector is scipy's ``maximum_filter(x, 3x3) == x`` minus the
eroded zero background (uniPose.py:57-65): on the host in numpy
(:func:`detect_peaks`), and on the tensor's own device in PyTorch
(:func:`detect_peaks_device`), which gives the same peaks in the same
row-major order.  Equality of floats decides a local maximum, so both
compare a pooled value with the map it was pooled from, in its own dtype.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch
import torch.nn.functional as F

# first box channel per dataset = num_joints + 1 (uniPose.py:20-49)
BOX_CHANNEL_START = {"LSP": 15, "MPII": 17, "PoseTrack": 18, "NTID": 20}
BOX_CHANNELS = 5  # center, top-left, bottom-left, top-right, bottom-right


def _windows3(p: np.ndarray, shape) -> List[np.ndarray]:
    """The nine 3x3-shifted views of a map padded by one on each side."""
    return [p[i : i + shape[0], j : j + shape[1]] for i in range(3) for j in range(3)]


def detect_peaks(channel: np.ndarray, threshold: float = 0.0) -> List[List[int]]:
    """(H, W) -> [[row, col], ...] peaks in row-major order
    (uniPose.py:52-71): values below ``threshold`` set to 0, the 3x3 max
    filter with edge replication, the 3x3 erosion of the zero background
    with ``border_value=1``."""
    c = np.asarray(channel, np.float32).copy()
    c[c < threshold] = 0
    local_max = np.max(_windows3(np.pad(c, 1, mode="edge"), c.shape), axis=0) == c
    background = np.pad(c == 0, 1, mode="constant", constant_values=True)
    eroded = np.logical_and.reduce(_windows3(background, c.shape))
    rows, cols = np.nonzero(np.logical_xor(local_max, eroded) * c > 0)
    return [[int(r), int(col)] for r, col in zip(rows, cols)]


def detect_peaks_device(channel: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Device twin of :func:`detect_peaks`: (..., H, W) -> a bool mask of
    the same shape, on the tensor's device, compared in its dtype.  The peaks of
    one map are ``torch.nonzero`` of its mask, in the host function's
    order."""
    shape = channel.shape
    c = channel.reshape(-1, 1, shape[-2], shape[-1])
    c = torch.where(c < threshold, torch.zeros_like(c), c)
    local_max = F.max_pool2d(F.pad(c, (1, 1, 1, 1), mode="replicate"), 3, stride=1) == c
    background = F.pad((c == 0).float(), (1, 1, 1, 1), mode="constant", value=1.0)
    eroded = -F.max_pool2d(-background, 3, stride=1) > 0
    return (torch.logical_xor(local_max, eroded) & (c > 0)).reshape(shape)


def peak_lists(mask: torch.Tensor) -> List[List[List[int]]]:
    """(N, H, W) peak masks -> N lists of [row, col], row-major each: one
    ``nonzero`` for all maps, one copy to the host."""
    idx = torch.nonzero(mask).cpu().numpy()
    out: List[List[List[int]]] = [[] for _ in range(mask.shape[0])]
    for n, r, col in idx:
        out[n].append([int(r), int(col)])
    return out


def box_peaks(
    maps: Union[np.ndarray, torch.Tensor], dataset: str = "LSP", threshold: float = 0.0
) -> List[List[List[int]]]:
    """The peaks of the five box channels of (1, C, H, W) maps: through
    :func:`detect_peaks_device` on a tensor's own device, through
    :func:`detect_peaks` for a numpy array."""
    start = BOX_CHANNEL_START[dataset]
    if isinstance(maps, torch.Tensor):
        return peak_lists(detect_peaks_device(maps[0, start : start + BOX_CHANNELS], threshold))
    mapping = np.asarray(maps)[0]
    return [detect_peaks(mapping[start + i], threshold) for i in range(BOX_CHANNELS)]


def multi_person_kpts(
    maps: Union[np.ndarray, torch.Tensor],
    dataset: str = "LSP",
    num_joints: int = 14,
    threshold: float = 0.0,
) -> List[List[int]]:
    """(1, C, H, W) maps with the box channels at
    ``BOX_CHANNEL_START[dataset]`` -> [[person, x, y], ...]: per person its
    K joints, then its center and four corners (uniPose.py:14-199).  A
    tensor's box peaks are found on its own device; the people are decoded
    on the host.  The box-head model returns ``(heat, box)``: pass
    ``torch.cat([heat, box], 1)``."""
    kc, ktl, kbl, ktr, kbr = box_peaks(maps, dataset, threshold)
    mapping = maps[0].cpu().numpy() if isinstance(maps, torch.Tensor) else np.asarray(maps)[0]
    kpts: List[List[int]] = []
    # the n-th peak of each box channel makes person n (uniPose.py:74-199);
    # each joint is argmaxed in the top-left..bottom-right window (its
    # corner where the window is empty), then the five box points follow
    for idx in range(min(len(kc), len(ktl), len(kbl), len(ktr), len(kbr))):
        (top, left), (bottom, right) = ktl[idx], kbr[idx]
        for m in mapping[1 : num_joints + 1, top:bottom, left:right]:
            if m.size == 0:
                kpts.append([idx, left, top])
                continue
            h, w = np.unravel_index(m.argmax(), m.shape)
            kpts.append([idx, int(w + left), int(h + top)])
        for r, col in (kc[idx], ktl[idx], kbl[idx], ktr[idx], kbr[idx]):
            kpts.append([idx, col, r])
    return kpts
