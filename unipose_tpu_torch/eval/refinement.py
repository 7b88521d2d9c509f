"""Hourglass-style prediction refinement and center-scale warps, in numpy.

Counterpart of ``unipose_tpu/eval/refinement.py`` (Reference:
utils/extra_utils/evaluation.py and utils/extra_utils/transforms.py, the
vendored hourglass helpers that utils/__init__.py:3-8 re-exports and the
trainers never call):

  * ``get_preds``: 1-indexed argmax coordinates (evaluation.py:13-30);
  * ``final_preds``: a quarter-pixel step toward the higher neighbour, +0.5,
    then the inverse center-scale warp to image coordinates
    (evaluation.py:75-97);
  * ``get_transform`` / ``transform_point`` / ``transform_preds``: the
    200*scale center-crop affine (transforms.py:79-125);
  * ``fliplr`` / ``flip_back`` / ``shufflelr``: horizontal flips of maps and
    coordinates with the MPII swap pairs (transforms.py:22-76).
"""

from __future__ import annotations

import math

import numpy as np

MPII_MATCHED_PARTS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


def get_preds(scores: np.ndarray) -> np.ndarray:
    """(B, K, H, W) score maps -> (B, K, 2) 1-indexed (x, y), zero where a
    map's maximum is not positive."""
    if scores.ndim != 4:
        raise ValueError(f"score maps must be (B, K, H, W), got {scores.shape}")
    b, k = scores.shape[:2]
    flat = scores.reshape(b, k, -1)
    idx = flat.argmax(axis=2) + 1
    maxval = flat.max(axis=2)
    preds = np.tile(idx[..., None], (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = (preds[:, :, 0] - 1) % scores.shape[3] + 1
    preds[:, :, 1] = np.floor((preds[:, :, 1] - 1) / scores.shape[3]) + 1
    return preds * (maxval > 0)[..., None].astype(np.float32)


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """The (3, 3) affine from a 200*scale box around ``center`` to ``res``,
    rotated by ``rot`` degrees about the output's middle
    (transforms.py:79-106)."""
    h = 200 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot_rad = -rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.zeros((3, 3))
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert: bool = False, rot: float = 0.0):
    """A 1-indexed point through the center-scale affine, truncated to
    integers (transforms.py:109-116)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1, pt[1] - 1, 1.0])
    return new_pt[:2].astype(int) + 1


def transform_preds(coords: np.ndarray, center, scale, res) -> np.ndarray:
    """(K, >=2) heatmap coordinates -> image coordinates (the inverse warp)."""
    coords = np.asarray(coords, np.float32).copy()
    for p in range(coords.shape[0]):
        coords[p, 0:2] = transform_point(coords[p, 0:2], center, scale, res, invert=True)
    return coords


def final_preds(output: np.ndarray, center, scale, res) -> np.ndarray:
    """(B, K, H, W) maps -> (B, K, 2) quarter-pixel-refined predictions in
    image coordinates (evaluation.py:75-97)."""
    output = np.asarray(output)
    coords = get_preds(output)
    for n in range(coords.shape[0]):
        for p in range(coords.shape[1]):
            hm = output[n][p]
            px = int(math.floor(coords[n][p][0]))
            py = int(math.floor(coords[n][p][1]))
            if 1 < px < res[0] and 1 < py < res[1]:
                diff = np.array(
                    [hm[py - 1][px] - hm[py - 1][px - 2], hm[py][px - 1] - hm[py - 2][px - 1]]
                )
                coords[n][p] += np.sign(diff) * 0.25
    coords += 0.5
    preds = coords.copy()
    for i in range(coords.shape[0]):
        preds[i] = transform_preds(coords[i], center[i], scale[i], res)
    return preds


def fliplr(x: np.ndarray) -> np.ndarray:
    """Score maps flipped along the width, as float64 (transforms.py:70-76)."""
    return np.ascontiguousarray(x[..., ::-1]).astype(float)


def flip_back(flip_output: np.ndarray, dataset: str = "mpii") -> np.ndarray:
    """(B, K, H, W) maps of a flipped image flipped back, left and right
    channels swapped (transforms.py:22-43)."""
    if dataset != "mpii":
        raise ValueError(f"Not supported dataset: {dataset}")
    out = fliplr(np.asarray(flip_output).copy())
    for a, b in MPII_MATCHED_PARTS:
        out[:, [a, b]] = out[:, [b, a]]
    return out


def shufflelr(x: np.ndarray, width: int, dataset: str = "mpii") -> np.ndarray:
    """(K, >=2) coordinates flipped across ``width``, left and right joints
    swapped (transforms.py:46-67)."""
    if dataset != "mpii":
        raise ValueError(f"Not supported dataset: {dataset}")
    x = np.asarray(x, np.float32).copy()
    x[:, 0] = width - x[:, 0]
    for a, b in MPII_MATCHED_PARTS:
        x[[a, b]] = x[[b, a]]
    return x
