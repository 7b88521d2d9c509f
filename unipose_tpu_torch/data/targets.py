"""Host-side helpers for auxiliary targets.

Most target rendering is device-side (``unipose_tpu_torch.ops.heatmap``); this
module keeps the small host-side pieces: the 5-point bounding-box coordinate
derivation used by the (optional) bbox-head variant.

Reference: utils/lsp_lspet_data.py:71-113 (``getBoundingBox``) — note the
reference computes the box from x<->y swapped keypoint coords and renders the
five Gaussians at (y, x) grid positions; the derivation below reproduces the
resulting five (row, col) centers exactly.

A copy of ``unipose_tpu/data/targets.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import numpy as np


def bounding_box_coords(kpts: np.ndarray, height: int, width: int, stride: int):
    """Five (row, col) heatmap-grid centers: box center + 4 corners.

    Mirrors getBoundingBox's coordinate math (lsp_lspet_data.py:75-101),
    including its x/y swap (it appends kpt_y into ``x`` and kpt_x into ``y``)
    and per-axis clamping to the grid.
    """
    kpts = np.asarray(kpts, np.float64)
    xs, ys = [], []
    for i in range(len(kpts)):
        if float(kpts[i, 1]) >= 0 or float(kpts[i, 0]) >= 0:
            xs.append(float(kpts[i, 1]))
            ys.append(float(kpts[i, 0]))
    if not xs:
        x_min = x_max = y_min = y_max = 0
    else:
        x_min = int(max(min(xs), 0))
        x_max = int(min(max(xs), width))
        y_min = int(max(min(ys), 0))
        y_max = int(min(max(ys), height))
    cx = (x_min + x_max) / 2
    cy = (y_min + y_max) / 2
    hs, ws = height / stride - 1, width / stride - 1
    coords = [
        (min(int(cy / stride), hs), min(int(cx / stride), ws)),
        (min(int(y_min / stride), hs), min(int(x_min / stride), ws)),
        (min(int(y_min / stride), hs), min(int(x_max / stride), ws)),
        (min(int(y_max / stride), hs), min(int(x_min / stride), ws)),
        (min(int(y_max / stride), hs), min(int(x_max / stride), ws)),
    ]
    return np.asarray(
        [[int(r) * 1.0, int(c) * 1.0] for r, c in coords], np.float32
    )


def bounding_box_maps(kpts: np.ndarray, height: int, width: int, stride: int):
    """(H/stride, W/stride, 5) Gaussian box maps, sigma 3, clamp [0.0099, 1]
    (lsp_lspet_data.py:103-113)."""
    hm_h, hm_w = int(height / stride), int(width / stride)
    coords = bounding_box_coords(kpts, height, width, stride)
    gy, gx = np.mgrid[0:hm_h, 0:hm_w]
    out = np.zeros((hm_h, hm_w, 5), np.float32)
    for i, (r, c) in enumerate(coords):
        # the reference renders with center_x=row, center_y=col (quirk)
        d2 = (gx - r) ** 2 + (gy - c) ** 2
        h = np.exp(-d2 / 2.0 / 9.0)
        h[h > 1] = 1
        h[h < 0.0099] = 0
        out[:, :, i] = h
    return out
