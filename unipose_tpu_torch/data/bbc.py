"""BBC Pose video dataset loader.

Reference: utils/bbc_data.py —
  * split -> video ids: train 1-10, val 11-15, test 16-20; per-video
    ``<i>_imageFiles.mat`` frame index and ``<i>_jointFiles.mat`` joints
    (:92-148);
  * each frame: bottom-right 368x368 crop of the 800x800 broadcast frame,
    keypoints shifted by the crop offset and clamped at 0 (:168-174,:193);
  * fixed center (184, 184), full-res centermap sigma 3 (:211-215);
  * unreadable frames fall back to the previous frame (:162-165) — the
    reference's failure-tolerance semantics, kept.

The reference returns single frames even though the video trainer needs
clips (SURVEY §2.4); ``seq_len > 1`` groups consecutive frames of the same
video into LSTM windows (BASELINE config 4: long sequences through the LSTM
scan).  ``seq_len=1`` reproduces the per-frame reference behavior.

A copy of ``unipose_tpu/data/bbc.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import os
import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

_SPLIT_BASE = {"Train": 1, "Val": 11, "Test": 16}


class BBCDataset:
    num_joints = 7

    def __init__(
        self,
        root_dir: str,
        sigma: float,
        is_train: str,
        transformer=None,
        seq_len: int = 1,
    ):
        import scipy.io

        self.labels_dir = os.path.join(root_dir, "labels")
        self.images_dir = os.path.join(root_dir, "BBCpose")
        self.sigma = sigma
        self.transformer = transformer
        self.seq_len = int(seq_len)

        split = is_train.lower()
        base = _SPLIT_BASE[is_train]
        split_dir = os.path.join(self.labels_dir, split)
        videos = sorted(os.listdir(os.path.join(split_dir, "imageFiles")))

        self.img_list = []
        self.video_of = []
        kps_all = None
        for i in range(len(videos)):
            vid = base + i
            frames = scipy.io.loadmat(
                os.path.join(split_dir, "imageFiles", f"{vid}_imageFiles.mat")
            )["imageFile"]
            joints = scipy.io.loadmat(
                os.path.join(split_dir, "joints", f"{vid}_jointFiles.mat")
            )["joints"]
            frames = np.asarray(frames).reshape(-1)
            for j in range(frames.shape[0]):
                self.img_list.append(
                    os.path.join(self.images_dir, str(vid), f"{int(frames[j])}.jpg")
                )
                self.video_of.append(vid)
            kps_all = joints if kps_all is None else np.append(kps_all, joints, axis=0)
        self.kps = np.asarray(kps_all, np.float64)

        # clip windows: consecutive frames within one video
        self.windows = []
        n = len(self.img_list)
        i = 0
        while i + self.seq_len <= n:
            if self.video_of[i] == self.video_of[i + self.seq_len - 1]:
                self.windows.append(i)
                i += self.seq_len
            else:
                i += 1

    def __len__(self):
        return len(self.windows)

    def _load_frame(self, index: int):
        im = cv2.imread(self.img_list[index])
        if im is None and index > 0:  # previous-frame fallback (:162-165)
            im = cv2.imread(self.img_list[index - 1])
        img = np.asarray(im, np.float32)
        kps = self.kps[index].copy()
        shift = [img.shape[1] - 368, img.shape[0] - 368]
        img = img[-368:, -368:, :]
        kps[:, 0] -= shift[0]
        kps[:, 1] -= shift[1]
        kps[kps < 0] = 0
        center = np.array([184.0, 184.0], np.float32)
        if self.transformer is not None:
            img, kps, center = self.transformer(img, kps, center)
        if kps.shape[1] == 2:  # ensure [x, y, vis]
            kps = np.concatenate([kps, np.ones((len(kps), 1))], axis=1)
        return (
            np.ascontiguousarray(img, np.float32),
            np.asarray(kps, np.float32),
            center,
        )

    def __getitem__(self, index: int):
        start = self.windows[index]
        frames = np.zeros((self.seq_len, 368, 368, 3), np.float32)
        kpts = np.zeros((self.seq_len, self.num_joints, 3), np.float32)
        centers = np.zeros((self.seq_len, 2), np.float32)
        paths = []
        for i in range(self.seq_len):
            img, kp, center = self._load_frame(start + i)
            frames[i], kpts[i], centers[i] = img, kp, center
            paths.append(self.img_list[start + i])
        if self.seq_len == 1:
            return {
                "image": frames[0],
                "kpts": kpts[0],
                "center": centers[0],
                "scale": np.float32(1.0),
                "path": paths[0],
            }
        return {"frames": frames, "kpts": kpts, "centers": centers, "paths": paths}
