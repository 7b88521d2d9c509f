"""Small video dataset roots written to disk from a seed, in the layouts
that ``penn_action.py`` and ``bbc.py`` read: random JPGs with joints drawn
inside each frame.  The video tests and ``chip_smoke.py`` train and
evaluate from them.

Usage::

    write_penn_root("penn/", "train", n_clips=8, n_frames=7, seed=1)
    write_bbc_root("bbc/", n_frames=40, seed=2)
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _write_jpg(path: str, rng: np.random.RandomState, h: int, w: int) -> None:
    import cv2

    cv2.imwrite(path, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def write_penn_root(root: str, split: str, n_clips: int, n_frames: int, seed: int,
                    first: int = 1, sides: Tuple[int, int] = (70, 90)) -> str:
    """Penn Action clips ``first .. first + n_clips - 1``: label dicts
    ``<root>/<split>/NNNN.npy`` (nframes, framepath, dimensions, x, y,
    visibility of 13 joints) and ``n_frames`` JPGs a clip,
    ``<root>/frames/NNNN/%06d.jpg`` (1-indexed), each clip's height and
    width drawn from ``sides`` (inclusive).  Returns ``root``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    for c in range(first, first + n_clips):
        clip = f"{c:04d}"
        h, w = (int(v) for v in rng.randint(sides[0], sides[1] + 1, 2))
        os.makedirs(os.path.join(root, "frames", clip), exist_ok=True)
        for f in range(n_frames):
            _write_jpg(os.path.join(root, "frames", clip, f"{f + 1:06d}.jpg"), rng, h, w)
        np.save(os.path.join(root, split, f"{clip}.npy"), {
            "nframes": n_frames, "framepath": f"frames/{clip}", "dimensions": [h, w],
            "x": rng.uniform(1, w - 1, (n_frames, 13)),
            "y": rng.uniform(1, h - 1, (n_frames, 13)),
            "visibility": rng.randint(0, 2, (n_frames, 13)),
        }, allow_pickle=True)
    return root


def write_bbc_root(root: str, n_frames: int, seed: int, vid: int = 11) -> str:
    """A BBC Pose root holding one val video ``vid`` of ``n_frames``
    800x800 JPGs ``BBCpose/<vid>/<n>.jpg``, its frame list
    (``labels/val/imageFiles``) and 7 joints a frame
    (``labels/val/joints``).  Returns ``root`` with a trailing slash, as
    ``BBCDataset`` joins paths."""
    import scipy.io

    rng = np.random.RandomState(seed)
    for sub in ("imageFiles", "joints"):
        os.makedirs(os.path.join(root, "labels", "val", sub), exist_ok=True)
    scipy.io.savemat(os.path.join(root, "labels", "val", "imageFiles", f"{vid}_imageFiles.mat"),
                     {"imageFile": np.arange(1, n_frames + 1, dtype=np.float64)})
    scipy.io.savemat(os.path.join(root, "labels", "val", "joints", f"{vid}_jointFiles.mat"),
                     {"joints": rng.uniform(450, 780, (n_frames, 7, 2))})
    os.makedirs(os.path.join(root, "BBCpose", str(vid)), exist_ok=True)
    for f in range(n_frames):
        _write_jpg(os.path.join(root, "BBCpose", str(vid), f"{f + 1}.jpg"), rng, 800, 800)
    return root + "/"
