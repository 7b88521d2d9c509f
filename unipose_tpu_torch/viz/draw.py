"""Visualization: keypoint extraction, skeleton rendering, heatmap overlays.

Counterpart of ``unipose_tpu/viz/draw.py`` (Reference: utils/utils.py):
  * ``get_kpts``: per-channel argmax (channels 1..K; 0 is the background),
    scaled to image coordinates (:94-106);
  * ``draw_paint``: per-dataset limb sequences and colours, line overlays
    blended in (:109-197);
  * ``draw_bbox``: a (center_x, center_y, w, h) box, its center, and
    optionally the skeleton of a heatmap set (``draw_BBox``, :502-580);
  * ``heatmap_overlays``: per-channel JET overlays at the image's
    resolution (``getOutImages``, :477-498).

A copy of the JAX module's functions, with the upsample through
``ops/resize.py``.  Everything here runs on the host, in numpy and OpenCV.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from unipose_tpu_torch.ops.resize import bilinear_resize

LIMB_SEQ = {
    "LSP": [
        [13, 12], [12, 9], [12, 8], [9, 10], [8, 7], [10, 11], [7, 6],
        [12, 3], [12, 2], [2, 1], [1, 0], [3, 4], [4, 5],
    ],
    "MPII": [
        [8, 9], [7, 12], [12, 11], [11, 10], [7, 13], [13, 14], [14, 15],
        [7, 6], [6, 2], [2, 1], [1, 0], [6, 3], [3, 4], [4, 5], [7, 8],
    ],
    "Penn_Action": [
        [0, 1], [0, 2], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6],
        [1, 7], [2, 8], [7, 8], [7, 9], [8, 10], [9, 11], [10, 12],
    ],
    "BBC": [[1, 3], [2, 4], [3, 5], [4, 6], [5, 6]],
}

COLORS = [
    [0, 0, 255], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 255, 0],
    [255, 0, 255], [0, 255, 0], [255, 0, 0], [255, 255, 0], [255, 0, 255],
    [0, 255, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 0],
]


def get_kpts(heatmaps: np.ndarray, img_h: float = 368.0, img_w: float = 368.0):
    """(1, H, W, K+1) or (1, K+1, H, W) heatmaps -> [[x, y], ...] for the K
    joint channels (channel 0, the background, skipped)."""
    maps = np.asarray(heatmaps)[0]
    if maps.shape[0] < maps.shape[-1]:  # NCHW slice (C, H, W)
        chw = maps
    else:
        chw = np.moveaxis(maps, -1, 0)
    kpts = []
    for m in chw[1:]:
        h, w = np.unravel_index(m.argmax(), m.shape)
        kpts.append([int(w * img_w / m.shape[1]), int(h * img_h / m.shape[0])])
    return kpts


def _image(image) -> np.ndarray:
    """A BGR uint8 array: ``image`` itself, or the file it names resized to
    368x368 (the reference's demo size)."""
    if isinstance(image, str):
        image = cv2.resize(cv2.imread(image), (368, 368))
    return np.ascontiguousarray(image).astype(np.uint8)


def draw_paint(
    image,
    kpts: Sequence[Sequence[int]],
    dataset: str,
    out_path: Optional[str] = None,
):
    """Render the skeleton over an image (a path or a BGR array).  Returns
    the rendered array; writes it to ``out_path`` when given."""
    im = _image(image)
    limb_seq = LIMB_SEQ.get(dataset, [])

    for k in kpts:
        cv2.circle(im, (int(k[0]), int(k[1])), radius=3, thickness=-1, color=(0, 0, 255))

    for i, limb in enumerate(limb_seq):
        if max(limb) >= len(kpts):
            continue
        cur = im.copy()
        y0, x0 = kpts[limb[0]]
        y1, x1 = kpts[limb[1]]
        if x0 != 0 and y0 != 0 and x1 != 0 and y1 != 0:
            cv2.line(cur, (y0, x0), (y1, x1), COLORS[i % len(COLORS)], 5)
        im = cv2.addWeighted(im, 0.2, cur, 0.8, 0)

    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        cv2.imwrite(out_path, im)
    return im


def draw_bbox(
    box,
    image,
    heatmaps: Optional[np.ndarray] = None,
    dataset: str = "LSP",
    out_path: Optional[str] = None,
):
    """Render a (center_x, center_y, w, h) box in red, a dot at its center,
    and with ``heatmaps`` the skeleton of their keypoints (:func:`get_kpts`,
    :func:`draw_paint`) over an image (a path or a BGR array).  Returns the
    rendered array; writes it to ``out_path`` when given."""
    im = _image(image)
    cx, cy, bw, bh = [float(v) for v in np.asarray(box).reshape(-1)[:4]]
    p1 = (int(cx - bw / 2), int(cy - bh / 2))
    p2 = (int(cx + bw / 2), int(cy + bh / 2))
    cv2.rectangle(im, p1, p2, (0, 0, 255), 2)
    cv2.circle(im, (int(cx), int(cy)), radius=2, thickness=-1, color=(0, 0, 255))
    if heatmaps is not None:
        im = draw_paint(im, get_kpts(heatmaps), dataset)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        cv2.imwrite(out_path, im)
    return im


def heatmap_overlays(
    heat: np.ndarray,
    image,
    out_dir: Optional[str] = None,
    prefix: str = "unipose",
) -> List[np.ndarray]:
    """Per-channel JET overlays (utils/utils.py:477-498, unipose.py:240-246).

    ``heat``: (1, h, w, C) NHWC heatmaps at any resolution, upsampled to
    the image's size with the model's align-corners resize (a no-op when
    they are at that size already, as ``Trainer.test`` hands them over).
    """
    im = _image(image)
    h, w = im.shape[:2]
    nchw = torch.from_numpy(np.asarray(heat, np.float32)).permute(0, 3, 1, 2)
    heat = bilinear_resize(nchw, (h, w)).permute(0, 2, 3, 1).numpy()[0]
    heat = np.clip(heat, 0.0, None)

    outs = []
    for c in range(heat.shape[-1]):
        cmap = cv2.applyColorMap(np.uint8(255 * heat[:, :, c]), cv2.COLORMAP_JET)
        blended = cv2.addWeighted(im, 0.6, cmap, 0.4, 0)
        outs.append(blended)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            cv2.imwrite(os.path.join(out_dir, f"{prefix}{c}.png"), blended)
    return outs
