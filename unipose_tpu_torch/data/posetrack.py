"""PoseTrack (2018) single-person dataset loader.

The reference factory dispatches to ``posetrack_data.PoseTrack_Data(is_train,
dir, sigma, stride, transforms)`` (Reference: utils/utils.py:318-329) but the
module itself is absent from the repo (SURVEY §2.4.3), so this loader is
designed against the *public* PoseTrack18 release layout instead:

    <root>/annotations/{train,val}/*.json   COCO-style per-sequence files:
        images:      [{"id", "file_name", "is_labeled", ...}]
        annotations: [{"image_id", "keypoints": [x,y,v]*17, "bbox", ...}]
    <root>/images/...                        frames referenced by file_name

UniPose is a single-person network, so each *annotation* (one person in one
labeled frame) is a sample: the person bbox is padded by 25% and cropped,
keypoints shifted/rescaled into the crop, then resized to 368 like the other
image loaders (utils/mpii_data.py:159-162 semantics).  The 17-keypoint order
(nose, head_bottom, head_top, ears, shoulders, elbows, wrists, hips, knees,
ankles) is what the reference's PCK norms index into: head length
``2*|nose - head_bottom|`` and torso ``|mid_shoulder - mid_hip|``
(Reference: utils/evaluate.py PoseTrack branches; eval/metrics.py here).

A copy of ``unipose_tpu/data/posetrack.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

JOINT_NAMES = (
    "Nose", "Head Bottom", "Head Top", "Left Ear", "Right Ear",
    "Left Shoulder", "Right Shoulder", "Left Elbow", "Right Elbow",
    "Left Wrist", "Right Wrist", "Left Hip", "Right Hip",
    "Left Knee", "Right Knee", "Left Ankle", "Right Ankle",
)


class PoseTrackDataset:
    num_joints = 17
    center_at_stride = False

    def __init__(
        self,
        is_train: bool,
        root_dir: str,
        sigma: float,
        stride: int = 8,
        transformer=None,
        bbox_pad: float = 0.25,
        min_vis_joints: int = 4,
    ):
        if cv2 is None:  # pragma: no cover
            raise ImportError("PoseTrackDataset requires cv2")
        self.root_dir = root_dir
        self.sigma = sigma
        self.stride = stride
        self.transformer = transformer
        self.bbox_pad = float(bbox_pad)

        split = "train" if is_train else "val"
        ann_dir = os.path.join(root_dir, "annotations", split)
        self.samples: List[dict] = []
        for path in sorted(glob.glob(os.path.join(ann_dir, "*.json"))):
            with open(path) as f:
                seq = json.load(f)
            images = {im["id"]: im for im in seq.get("images", [])}
            for ann in seq.get("annotations", []):
                im = images.get(ann["image_id"])
                if im is None or not im.get("is_labeled", True):
                    continue
                kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
                if (kpts[:, 2] > 0).sum() < min_vis_joints:
                    continue
                self.samples.append(
                    {
                        "file_name": im["file_name"],
                        "keypoints": kpts,
                        "bbox": ann.get("bbox"),
                    }
                )

    def __len__(self):
        return len(self.samples)

    def _crop_box(self, kpts: np.ndarray, bbox: Optional[list], shape):
        h, w = shape[:2]
        if bbox is not None and len(bbox) == 4 and bbox[2] > 0 and bbox[3] > 0:
            x0, y0, bw, bh = [float(v) for v in bbox]
        else:  # derive from visible keypoints
            vis = kpts[kpts[:, 2] > 0]
            x0, y0 = vis[:, 0].min(), vis[:, 1].min()
            bw, bh = vis[:, 0].max() - x0, vis[:, 1].max() - y0
        px, py = bw * self.bbox_pad, bh * self.bbox_pad
        # far edge from the *unclamped* padded box, so a bbox hugging the
        # left/top edge doesn't silently grow the crop on the far side
        x1 = min(w, int(x0 + bw + px))
        y1 = min(h, int(y0 + bh + py))
        x0 = min(max(0, int(x0 - px)), w - 1)
        y0 = min(max(0, int(y0 - py)), h - 1)
        return x0, y0, max(x1, x0 + 1), max(y1, y0 + 1)

    def __getitem__(self, index: int):
        s = self.samples[index]
        img_path = os.path.join(self.root_dir, s["file_name"])
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(f"unreadable image: {img_path}")
        kpt = s["keypoints"].copy()

        x0, y0, x1, y1 = self._crop_box(kpt, s["bbox"], img.shape)
        img = img[y0:y1, x0:x1]
        kpt[:, 0] -= x0
        kpt[:, 1] -= y0

        if img.shape[0] != 368 or img.shape[1] != 368:
            kpt[:, 0] *= 368.0 / img.shape[1]
            kpt[:, 1] *= 368.0 / img.shape[0]
            img = cv2.resize(img, (368, 368))
        img = np.asarray(img, np.float32)
        center = np.asarray(
            [img.shape[1] / 2.0, img.shape[0] / 2.0], np.float32
        )

        if self.transformer is not None:
            img, kpt, center = self.transformer(img, kpt, center)

        return {
            "image": img,
            "kpts": np.asarray(kpt, np.float32),
            "center": np.asarray(center, np.float32),
            "path": img_path,
        }
