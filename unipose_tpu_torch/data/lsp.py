"""LSP / LSPET dataset loader.

Reference: utils/lsp_lspet_data.py —
  * images globbed from ``<root>/images/*.jpg``, sorted by the numeric part
    of the filename (:15-22);
  * ``joints.mat``: lspet layout (14, 3, 10000) vs lsp layout (3, 14, 2000)
    with inverted visibility (:24-43);
  * centers/scales derived from keypoint extents against the image size
    (:45-62);
  * per item: cv2.imread + resize to 368 (:211) — the reference does NOT
    rescale keypoints for this resize (quirk preserved; see
    ``rescale_kpts``);
  * geometric transform applied to (img, kpt, center, scale) (:218).

Host emits raw image + transformed keypoints; normalization ((x-128)/256,
:242-243) and Gaussian targets (:224-240) are rendered on device.

A copy of ``unipose_tpu/data/lsp.py`` with its imports re-rooted onto
``unipose_tpu_torch``.
"""

from __future__ import annotations

import glob
import os
import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def read_data_file(root_dir: str):
    image_arr = np.array(glob.glob(os.path.join(root_dir, "images/*.jpg")))
    image_nums = np.array([float(s.rsplit("/")[-1][2:-4]) for s in image_arr])
    return image_arr[np.argsort(image_nums)].tolist()


def read_mat_file(mode: str, root_dir: str, img_list):
    """Returns (kpts (N, K, 3), centers (N, 2), scales (N,))."""
    import scipy.io
    from PIL import Image

    mat_arr = scipy.io.loadmat(os.path.join(root_dir, "joints.mat"))["joints"]
    if mode == "lspet":  # (14, 3, 10000)
        lms = mat_arr.transpose([2, 1, 0])
        kpts = mat_arr.transpose([2, 0, 1])
    elif mode == "lsp":  # (3, 14, 2000), visibility inverted
        mat_arr[2] = np.logical_not(mat_arr[2])
        lms = mat_arr.transpose([2, 0, 1])
        kpts = mat_arr.transpose([2, 1, 0])
    else:
        raise ValueError(f"mode must be 'lsp' or 'lspet', got {mode!r}")

    centers, scales = [], []
    for idx in range(lms.shape[0]):
        with Image.open(img_list[idx]) as im:
            w, h = im.size
        xs, ys = lms[idx][0], lms[idx][1]
        center_x = (xs[xs < w].max() + xs[xs > 0].min()) / 2
        center_y = (ys[ys < h].max() + ys[ys > 0].min()) / 2
        centers.append([center_x, center_y])
        scales.append((ys[ys < h].max() - ys[ys > 0].min() + 4) / 368.0)
    return (
        np.asarray(kpts, np.float32),
        np.asarray(centers, np.float32),
        np.asarray(scales, np.float32),
    )


class LSPDataset:
    """Yields dict samples:
      image  (368, 368, 3) f32 BGR 0..255 (pre-normalization)
      kpts   (14, 3) f32 [x, y, vis] post-transform
      center (2,) f32
      scale  f32
      path   str
    """

    num_joints = 14

    def __init__(
        self,
        mode: str,
        root_dir: str,
        sigma: float,
        stride: int,
        transformer=None,
        rescale_kpts: bool = False,
        input_size: int = 368,
    ):
        """``rescale_kpts=False`` reproduces the reference exactly (keypoints
        stay at original-image scale after the 368 resize,
        lsp_lspet_data.py:211-218); True applies the geometrically correct
        rescale."""
        self.img_list = read_data_file(root_dir)
        self.kpt_list, self.center_list, self.scale_list = read_mat_file(
            mode, root_dir, self.img_list
        )
        self.stride = stride
        self.sigma = sigma
        self.transformer = transformer
        self.rescale_kpts = rescale_kpts
        self.input_size = int(input_size)

    def __len__(self):
        return len(self.img_list)

    def __getitem__(self, index: int):
        path = self.img_list[index]
        raw = cv2.imread(path)
        size = self.input_size
        img = np.array(cv2.resize(raw, (size, size)), dtype=np.float32)
        kpt = self.kpt_list[index].copy()
        center = self.center_list[index].copy()
        scale = float(self.scale_list[index])

        if self.rescale_kpts:
            h0, w0 = raw.shape[:2]
            kpt[:, 0] *= size / w0
            kpt[:, 1] *= size / h0
            center[0] *= size / w0
            center[1] *= size / h0

        if self.transformer is not None:
            img, kpt, center = self.transformer(img, kpt, center, scale)

        return {
            "image": np.asarray(img, np.float32),
            "kpts": np.asarray(kpt, np.float32),
            "center": np.asarray(center, np.float32),
            "scale": np.float32(scale),
            "path": path,
        }
