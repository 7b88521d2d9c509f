"""Penn Action video dataset loader.

Reference: utils/penn_action_data.py.  That file is heavily bit-rotted
(SURVEY §2.4.7: undefined names, 368x368 labels vs a 46x46 model, hardcoded
home-dir paths); this loader implements the *intended* behavior:

  * per-index ``.npy`` dicts with nframes / framepath / dimensions / x / y /
    visibility (:49-56);
  * a random ``seq_len``-frame window per access in train mode (:60),
    deterministic window start in eval;
  * joints off the frame get visibility -1 (:96-99 ``isNotOnPlane``);
  * per-frame resize to 368 with keypoint rescale (repairing the reference's
    TestResized x/y-ratio quirk is NOT needed here — we apply the same
    TestResized transform when one is supplied);
  * fixed clip center (184, 184) (:105-115), full-res centermap sigma 3
    rendered on device;
  * targets at stride-8 resolution (repair of the 368x368 label_size, per
    SURVEY §2.4.7 the trainers require 46x46).

Frame paths resolve as ``<root>/frames/<clip_id>/NNNNNN.jpg`` where clip_id
is the label file stem — replacing the reference's hardcoded
``/home/bm3768/...`` prefix surgery (:76-77).

A copy of ``unipose_tpu/data/penn_action.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class PennActionDataset:
    num_joints = 13

    def __init__(
        self,
        root_dir: str,
        sigma: float,
        frame_memory: int,
        is_train: bool,
        transformer=None,
        rng: Optional[np.random.RandomState] = None,
        input_size: int = 368,
    ):
        """``input_size`` generalizes the reference's hardcoded 368
        (penn_action_data.py:28-29 height=width=368); non-default values are
        a this-framework extension (reduced-size smoke runs)."""
        self.root_dir = root_dir
        self.sigma = sigma
        self.seq_len = int(frame_memory)
        self.is_train = bool(is_train)
        self.transformer = transformer
        self.rng = rng or np.random
        self.input_size = int(input_size)
        self.data_dir = os.path.join(root_dir, "train" if is_train else "val")
        self.frame_dir = os.path.join(root_dir, "frames")
        self.frames_data = sorted(os.listdir(self.data_dir))

    def __len__(self):
        return len(self.frames_data)

    def _resolve_frame(self, clip_stem: str, framepath: str, frame_idx: int) -> str:
        name = "%06d.jpg" % frame_idx
        local = os.path.join(self.frame_dir, clip_stem, name)
        if os.path.exists(local):
            return local
        # fall back to the recorded framepath's basename under frames/
        return os.path.join(self.frame_dir, os.path.basename(str(framepath)), name)

    def __getitem__(self, index: int):
        label_file = self.frames_data[index]
        clip_stem = os.path.splitext(label_file)[0]
        data = np.load(
            os.path.join(self.data_dir, label_file), allow_pickle=True
        ).item()

        nframes = int(data["nframes"])
        dim = data["dimensions"]
        xs, ys = np.asarray(data["x"]), np.asarray(data["y"])
        vis = np.asarray(data["visibility"])

        max_start = max(nframes - self.seq_len, 0)
        if self.is_train:
            start = int(self.rng.randint(0, max_start + 1))
        else:
            start = 0

        size = self.input_size
        frames = np.zeros((self.seq_len, size, size, 3), np.float32)
        kpts = np.zeros((self.seq_len, self.num_joints, 3), np.float32)
        centers = np.full((self.seq_len, 2), size / 2.0, np.float32)
        paths = []

        for i in range(self.seq_len):
            fidx = min(start + i, nframes - 1)
            path = self._resolve_frame(clip_stem, data.get("framepath", clip_stem), fidx + 1)
            paths.append(path)
            img = cv2.imread(path)
            kp = np.stack([xs[fidx], ys[fidx], vis[fidx].astype(np.float64)], axis=1)
            # joints off the frame -> visibility -1 (isNotOnPlane, :173-175)
            off = (
                (kp[:, 0] < 0.001)
                | (kp[:, 1] < 0.001)
                | (kp[:, 0] > dim[1])
                | (kp[:, 1] > dim[0])
            )
            kp[off, 2] = -1

            if self.transformer is not None:
                img = np.asarray(img, np.float32)
                img, kp, center = self.transformer(img, kp, centers[i].copy())
                centers[i] = center
            else:
                h0, w0 = img.shape[:2]
                kp[:, 0] *= float(size) / w0
                kp[:, 1] *= float(size) / h0
                img = cv2.resize(img, (size, size))
            if img.shape[:2] != (size, size):
                img = cv2.resize(img, (size, size))
            frames[i] = np.asarray(img, np.float32)
            kpts[i] = kp

        return {
            "frames": frames,
            "kpts": kpts,
            "centers": centers,
            "paths": paths,
        }
