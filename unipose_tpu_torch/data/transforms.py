"""Joint-aware geometric augmentation on host (numpy + cv2).

Reference: utils/Mytransforms.py.  The host side of the pipeline only does
decode + geometry (this module); photometric normalization and Gaussian
target rendering run on device (``unipose_tpu_torch.ops.heatmap``), so samples
leave the host as raw uint8-range float images plus transformed keypoints.

Keypoints are (K, 3) float arrays of [x, y, visibility]; centers are (2,)
float arrays.  Reference quirks preserved on purpose (they shape training
data distribution and therefore weights):

  * ``resize`` with a (ratio_h, ratio_w) tuple scales x by the H-ratio and y
    by the W-ratio and passes a (h*rh, w*rw) dsize to cv2 (which interprets
    it as (width, height)) — exact for square targets, swapped for
    non-square, matching Mytransforms.py:78-88;
  * images narrower than 64px are right-padded with gray 128
    (Mytransforms.py:64-66);
  * rotation expands the canvas to fit (Mytransforms.py:201-232);
  * flip/crop skip keypoints with visibility 0 where the reference does
    (Mytransforms.py:322-329, 501-520).

A copy of ``unipose_tpu/data/transforms.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import numbers
import random
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in the target image
    cv2 = None

# Horizontal-flip joint swap pairs (Mytransforms.py:513,:533,:554).
SWAP_PAIRS_LSP = ((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9))
SWAP_PAIRS_BBC = ((1, 2), (3, 4), (5, 6))
SWAP_PAIRS_NTID = SWAP_PAIRS_LSP


def _as_kpt(kpt) -> np.ndarray:
    kpt = np.asarray(kpt, np.float64)
    if kpt.ndim == 1:
        kpt = kpt[None]
    return kpt.copy()


def resize(img: np.ndarray, kpt, center, ratio):
    """Scale image + keypoints (Reference: Mytransforms.py:45-88)."""
    kpt = _as_kpt(kpt)
    center = np.asarray(center, np.float64).copy()
    h, w, _ = img.shape
    if w < 64:
        img = cv2.copyMakeBorder(
            img, 0, 0, 0, 64 - w, cv2.BORDER_CONSTANT, value=(128, 128, 128)
        )
        w = 64
    if isinstance(ratio, numbers.Number):
        kpt[:, 0] *= ratio
        kpt[:, 1] *= ratio
        center[0] *= ratio
        center[1] *= ratio
        out = cv2.resize(img, (0, 0), fx=ratio, fy=ratio)
        return np.ascontiguousarray(out), kpt, center
    # tuple ratio: reference applies ratio[0] to x and ratio[1] to y and
    # passes dsize=(h*r0, w*r1) (exact for square outputs).
    kpt[:, 0] *= ratio[0]
    kpt[:, 1] *= ratio[1]
    center[0] *= ratio[0]
    center[1] *= ratio[1]
    out = cv2.resize(
        img,
        (int(img.shape[0] * ratio[0]), int(img.shape[1] * ratio[1])),
        interpolation=cv2.INTER_CUBIC,
    )
    return np.ascontiguousarray(out), kpt, center


def rotate(img: np.ndarray, kpt, center, degree):
    """Rotate with canvas expansion (Reference: Mytransforms.py:186-232)."""
    kpt = _as_kpt(kpt)
    center = np.asarray(center, np.float64).copy()
    height, width, _ = img.shape
    img_center = (width / 2.0, height / 2.0)
    mat = cv2.getRotationMatrix2D(img_center, degree, 1.0)
    cos_val, sin_val = np.abs(mat[0, 0]), np.abs(mat[0, 1])
    new_width = int(height * sin_val + width * cos_val)
    new_height = int(height * cos_val + width * sin_val)
    mat[0, 2] += (new_width / 2.0) - img_center[0]
    mat[1, 2] += (new_height / 2.0) - img_center[1]
    img = cv2.warpAffine(img, mat, (new_width, new_height), borderValue=(128, 128, 128))
    for i in range(len(kpt)):
        if kpt.shape[1] > 2 and kpt[i, 2] == 0:
            continue
        p = mat.dot(np.array([kpt[i, 0], kpt[i, 1], 1.0]))
        kpt[i, 0], kpt[i, 1] = p[0], p[1]
    p = mat.dot(np.array([center[0], center[1], 1.0]))
    center[0], center[1] = p[0], p[1]
    return np.ascontiguousarray(img), kpt, center


def crop(img: np.ndarray, kpt, center, offset_left, offset_up, w, h):
    """Crop with gray-128 out-of-bounds fill (Reference:
    Mytransforms.py:322-363)."""
    kpt = _as_kpt(kpt)
    center = np.asarray(center, np.float64).copy()
    for i in range(len(kpt)):
        if kpt.shape[1] > 2 and kpt[i, 2] == 0:
            continue
        kpt[i, 0] -= offset_left
        kpt[i, 1] -= offset_up
    center[0] -= offset_left
    center[1] -= offset_up

    height, width, _ = img.shape
    new_img = np.full((h, w, 3), 128, dtype=np.float32)
    st_x, ed_x, st_y, ed_y = 0, w, 0, h
    or_st_x, or_ed_x = offset_left, offset_left + w
    or_st_y, or_ed_y = offset_up, offset_up + h
    if offset_left < 0:
        st_x, or_st_x = -offset_left, 0
    if offset_left + w > width:
        ed_x, or_ed_x = width - offset_left, width
    if offset_up < 0:
        st_y, or_st_y = -offset_up, 0
    if offset_up + h > height:
        ed_y, or_ed_y = height - offset_up, height
    new_img[st_y:ed_y, st_x:ed_x, :] = img[or_st_y:or_ed_y, or_st_x:or_ed_x, :]
    return np.ascontiguousarray(new_img), kpt, center


def hflip(img: np.ndarray, kpt, center, swap_pairs=SWAP_PAIRS_LSP, check_vis=True):
    """Horizontal flip with per-skeleton joint swaps (Reference:
    Mytransforms.py:501-561)."""
    kpt = _as_kpt(kpt)
    center = np.asarray(center, np.float64).copy()
    height, width, _ = img.shape
    img = img[:, ::-1, :]
    for i in range(len(kpt)):
        if check_vis and kpt.shape[1] > 2 and kpt[i, 2] != 1:
            continue
        kpt[i, 0] = width - 1 - kpt[i, 0]
    center[0] = width - 1 - center[0]
    for a, b in swap_pairs:
        kpt[[a, b]] = kpt[[b, a]]
    return np.ascontiguousarray(img), kpt, center


# ---------------------------------------------------------------------------
# Composable transform objects (Reference: Mytransforms.py classes)
# ---------------------------------------------------------------------------


class RandomResized:
    """Random scale in [scale_min, scale_max] / sample scale
    (Reference: Mytransforms.py:90-126)."""

    def __init__(self, scale_min=0.3, scale_max=1.1, rng: Optional[random.Random] = None):
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.rng = rng or random

    def __call__(self, img, kpt, center, scale):
        ratio = self.rng.uniform(self.scale_min, self.scale_max) / scale
        return resize(img, kpt, center, ratio)


class TestResized:
    """Deterministic resize to a fixed size (Reference:
    Mytransforms.py:148-184)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, kpt, center):
        height, width, _ = img.shape
        ratio = (self.size[0] / height, self.size[1] / width)
        return resize(img, kpt, center, ratio)


class RandomRotate:
    """Uniform rotation in [-max_degree, max_degree] (Reference:
    Mytransforms.py:266-303)."""

    def __init__(self, max_degree, rng: Optional[random.Random] = None):
        self.max_degree = max_degree
        self.rng = rng or random

    def __call__(self, img, kpt, center):
        degree = self.rng.uniform(-self.max_degree, self.max_degree)
        return rotate(img, kpt, center, degree)


class RandomCrop:
    """Center-perturbed square crop (Reference: Mytransforms.py:408-458)."""

    def __init__(self, size, center_perturb_max=5, rng: Optional[random.Random] = None):
        self.size = (int(size), int(size))
        self.center_perturb_max = center_perturb_max
        self.rng = rng or random

    def __call__(self, img, kpt, center):
        x_off = int((self.rng.uniform(0, 1) - 0.5) * 2 * self.center_perturb_max)
        y_off = int((self.rng.uniform(0, 1) - 0.5) * 2 * self.center_perturb_max)
        offset_left = int(round(center[0] + x_off - self.size[0] / 2))
        offset_up = int(round(center[1] + y_off - self.size[1] / 2))
        return crop(img, kpt, center, offset_left, offset_up, *self.size)


class SinglePersonCrop:
    """Deterministic person-centered crop (Reference:
    Mytransforms.py:484-498)."""

    def __init__(self, size, center_perturb_max=5):
        self.size = (int(size), int(size))

    def __call__(self, img, kpt, center):
        offset_left = int(round(center[0] - self.size[0] / 2))
        offset_up = int(round(center[1] - self.size[1] / 2))
        return crop(img, kpt, center, offset_left, offset_up, *self.size)


class RandomHorizontalFlip:
    """Probabilistic flip with dataset-specific swap pairs (Reference:
    Mytransforms.py:564-639; pairs per skeleton at :513/:533/:554)."""

    def __init__(
        self,
        prob=0.5,
        swap_pairs: Sequence[Tuple[int, int]] = SWAP_PAIRS_LSP,
        check_vis: bool = True,
        rng: Optional[random.Random] = None,
    ):
        self.prob = prob
        self.swap_pairs = tuple(swap_pairs)
        self.check_vis = check_vis
        self.rng = rng or random

    def __call__(self, img, kpt, center):
        if self.rng.random() < self.prob:
            return hflip(img, kpt, center, self.swap_pairs, self.check_vis)
        return img, _as_kpt(kpt), np.asarray(center, np.float64).copy()


def RandomHorizontalFlip_BBC(prob=0.5, rng=None):
    """BBC variant: different swap pairs, no visibility gate
    (Reference: Mytransforms.py:522-540,590-613)."""
    return RandomHorizontalFlip(prob, SWAP_PAIRS_BBC, check_vis=False, rng=rng)


def RandomHorizontalFlip_NTID(prob=0.5, rng=None):
    """NTID variant (Reference: Mytransforms.py:543-561,616-639)."""
    return RandomHorizontalFlip(prob, SWAP_PAIRS_NTID, check_vis=False, rng=rng)


class Compose:
    """Apply transforms in order; ``scale`` is forwarded only to
    RandomResized (Reference: Mytransforms.py:642-668)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img, kpt, center, scale=None):
        for t in self.transforms:
            if isinstance(t, RandomResized):
                img, kpt, center = t(img, kpt, center, scale)
            else:
                img, kpt, center = t(img, kpt, center)
        return img, kpt, center


def normalize(img: np.ndarray, mean=128.0, std=256.0) -> np.ndarray:
    """Host-side normalization helper for parity tests; production paths
    normalize on device (Reference: Mytransforms.py:10-25 with mean 128 /
    std 256, utils/lsp_lspet_data.py:242-243)."""
    return (np.asarray(img, np.float32) - mean) / std
