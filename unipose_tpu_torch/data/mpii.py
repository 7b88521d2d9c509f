"""MPII single-person dataset loader.

Reference: utils/mpii_data.py —
  * annotations from ``<root>/mpii_annotations.json`` (:87), train/val split
    by the ``isValidation`` flag (:93-97);
  * walk backwards past entries whose label ``.png`` is missing (:114-116) —
    the reference's skip-missing semantics, kept;
  * center y-shift ``+15*scale`` and ``scale *= 1.25`` when a center exists
    (:129-131);
  * direct resize to 368 with keypoint rescale (:159-162);
  * centermap at stride-8 resolution from the truncated center (:177-181) —
    note this differs from LSP's full-resolution centermap; the
    ``center_at_stride`` flag records it for the device-side renderer.

A copy of ``unipose_tpu/data/mpii.py`` with its imports re-rooted onto
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


class MPIIDataset:
    num_joints = 16
    center_at_stride = True  # centermap rendered at heatmap resolution

    def __init__(
        self,
        root_dir: str,
        sigma: float,
        is_train: str,
        transformer=None,
        require_label_png: bool = True,
    ):
        self.root_dir = root_dir
        self.images_dir = os.path.join(root_dir, "images")
        self.sigma = sigma
        self.stride = 8
        self.transformer = transformer
        self.require_label_png = require_label_png

        with open(os.path.join(root_dir, "mpii_annotations.json")) as f:
            self.anno = json.load(f)

        self.img_list = [
            i
            for i, val in enumerate(self.anno)
            if bool(val["isValidation"]) == (is_train == "Val")
        ]

    def __len__(self):
        return len(self.img_list)

    def _label_exists(self, variable) -> bool:
        if not self.require_label_png:
            return True
        return os.path.isfile(
            os.path.join(self.root_dir, variable["img_paths"][:-4] + ".png")
        )

    def __getitem__(self, index: int):
        variable = self.anno[self.img_list[index]]
        while not self._label_exists(variable):
            index -= 1
            variable = self.anno[self.img_list[index]]

        img_path = os.path.join(self.images_dir, variable["img_paths"])
        points = np.asarray(variable["joint_self"], np.float32)  # (16, 3)
        center = np.asarray(variable["objpos"], np.float32)
        scale = float(variable["scale_provided"])

        if center[0] != -1:
            center[1] = center[1] + 15 * scale
            scale = scale * 1.25

        img = cv2.imread(img_path)
        kpt = points.copy()
        if img.shape[0] != 368 or img.shape[1] != 368:
            kpt[:, 0] *= 368.0 / img.shape[1]
            kpt[:, 1] *= 368.0 / img.shape[0]
            img = cv2.resize(img, (368, 368))
        img = np.asarray(img, np.float32)

        if self.transformer is not None:
            img, kpt, center = self.transformer(img, kpt, center)

        return {
            "image": img,
            "kpts": np.asarray(kpt, np.float32),
            "center": np.asarray(center, np.float32),
            "scale": np.float32(scale),
            "path": img_path,
        }
