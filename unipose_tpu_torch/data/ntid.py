"""NTID (sign-language upper-body) dataset loader.

The reference factory dispatches to ``ntid_data.NTID(dir, sigma, split,
transforms)`` (Reference: utils/utils.py:299-316) but the module — like the
dataset itself — was never published (SURVEY §2.4.3).  The joint set IS
pinned by the reference's per-joint report printer (utils/utils.py:429-459):
19 Kinect-v2-style upper-body joints, and by the PCK norms
(utils/evaluate.py NTID branches): head ``2*|Head - Neck|``, torso
``|Neck - Spine Base|`` — both reproduced in eval/metrics.py.

Since no annotation format exists to match, this loader defines one and
documents it (same spirit as the repaired Penn Action loader, SURVEY
§2.4.7):

    <root>/ntid_annotations.json: list of
        {"img_path": str (relative to root),
         "joints":  [[x, y, v] * 19],
         "center":  [x, y],            # optional; image center if absent
         "split":   "Train" | "Val" | "Test"}

Images are resized to 368 with keypoint rescale, matching every other image
loader (utils/mpii_data.py:159-162 semantics).

A copy of ``unipose_tpu/data/ntid.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import json
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

JOINT_NAMES = (
    "Spine Base", "Spine Mid", "Neck", "Head",
    "Shoulder Left", "Elbow Left", "Wrist Left", "Hand Tip Left",
    "Shoulder Right", "Elbow Right", "Wrist Right", "Hand Tip Right",
    "Hip Left", "Hip Right", "Spine Shoulder",
    "Hand Left", "Thumb Left", "Hand Right", "Thumb Right",
)


class NTIDDataset:
    num_joints = 19
    center_at_stride = False

    def __init__(self, root_dir: str, sigma: float, split: str, transformer=None):
        if cv2 is None:  # pragma: no cover
            raise ImportError("NTIDDataset requires cv2")
        self.root_dir = root_dir
        self.sigma = sigma
        self.stride = 8
        self.transformer = transformer

        with open(os.path.join(root_dir, "ntid_annotations.json")) as f:
            anno = json.load(f)
        self.samples = [a for a in anno if a.get("split", "Train") == split]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        s = self.samples[index]
        img_path = os.path.join(self.root_dir, s["img_path"])
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(f"unreadable image: {img_path}")
        kpt = np.asarray(s["joints"], np.float32).reshape(-1, 3)
        if "center" in s:
            center = np.asarray(s["center"], np.float32)
        else:
            center = np.asarray(
                [img.shape[1] / 2.0, img.shape[0] / 2.0], np.float32
            )

        if img.shape[0] != 368 or img.shape[1] != 368:
            sx, sy = 368.0 / img.shape[1], 368.0 / img.shape[0]
            kpt[:, 0] *= sx
            kpt[:, 1] *= sy
            center[0] *= sx
            center[1] *= sy
            img = cv2.resize(img, (368, 368))
        img = np.asarray(img, np.float32)

        if self.transformer is not None:
            img, kpt, center = self.transformer(img, kpt, center)

        return {
            "image": img,
            "kpts": np.asarray(kpt, np.float32),
            "center": np.asarray(center, np.float32),
            "path": img_path,
        }
