"""Limb (part-affinity-style) segment maps, in numpy.

Counterpart of ``unipose_tpu/ops/limbs.py`` (Reference:
utils/lsp_lspet_data.py:116-177, ``getLimbs``, whose call site :220 is
commented out): per limb, a Gaussian of the perpendicular distance to the
limb's line inside the keypoints' bounding box, clamped to [0.0099, 1].
Vectorised over the box where the reference loops per pixel, with its
quirks kept:

  * keypoints are truncated to integers at the heatmap stride (:141-146);
  * limb 7 ends at the hip midpoint (:140-142);
  * values are written at [x, y] inside the box (:170 writes
    ``limb_maps[idx, x, y]``), and the maps returned HWC (:177).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# LSP limb pairs (lsp_lspet_data.py:205)
LSP_BODY_PARTS = (
    (13, 12), (12, 9), (12, 8), (8, 7), (9, 10), (7, 6), (10, 11),
    (12, 3), (2, 3), (2, 1), (1, 0), (3, 4), (4, 5),
)


def limb_maps(
    kpts: np.ndarray,
    height: int,
    width: int,
    stride: int,
    body_parts: Sequence[Sequence[int]] = LSP_BODY_PARTS,
    sigma: float = 1.0,
) -> np.ndarray:
    """(K, >=2) keypoints -> (H/stride, W/stride, n_limbs) f64 limb maps."""
    kpts = np.asarray(kpts, np.float64)
    hm_h, hm_w = height // stride, width // stride
    maps = np.zeros((len(body_parts), hm_h, hm_w), np.float64)

    for idx, (a, b) in enumerate(body_parts):
        keya = [int(kpts[a][0] / stride), int(kpts[a][1] / stride)]
        if idx == 7:  # the torso limb ends at the hip midpoint (:140-142)
            keyb = [int((kpts[2][0] + kpts[3][0]) / (2 * stride)),
                    int((kpts[2][1] + kpts[3][1]) / (2 * stride))]
        else:
            keyb = [int(kpts[b][0] / stride), int(kpts[b][1] / stride)]

        norm = math.hypot(keya[0] - keyb[0], keya[1] - keyb[1])
        if norm == 0:
            continue
        x_min = int(max(min(keya[1], keyb[1]), 0))
        x_max = int(min(max(keya[1], keyb[1]), hm_w))
        y_min = int(max(min(keya[0], keyb[0]), 0))
        y_max = int(min(max(keya[0], keyb[0]), hm_h))
        if x_min >= x_max or y_min >= y_max:
            continue

        ys, xs = np.mgrid[y_min:y_max, x_min:x_max]
        # the perpendicular distance to the limb's line (:167-168)
        d = np.abs(
            (keyb[0] - keya[0]) * xs - (keyb[1] - keya[1]) * ys
            + keyb[1] * keya[0] - keya[1] * keyb[0]
        ) / norm
        g = np.exp(-(d * d) / (2.0 * sigma * sigma))
        g[g > 1] = 1
        g[g < 0.0099] = 0
        # the reference writes [idx, x, y] inside the box (:170)
        maps[idx, x_min:x_max, y_min:y_max] = np.maximum(maps[idx, x_min:x_max, y_min:y_max], g.T)

    return maps.transpose(1, 2, 0)
