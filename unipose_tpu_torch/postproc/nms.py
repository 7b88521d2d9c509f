"""Detection NMS and IoU, on the host in numpy.

Counterpart of ``unipose_tpu/postproc/nms.py`` (Reference: utils/utils.py:
583-710, ``non_max_suppression``, ``bbox_iou``): the same +1 box-area
convention and thresholds, numpy in and numpy out.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _corners(boxes: np.ndarray) -> np.ndarray:
    """(N, >=4) center-format (cx, cy, w, h) -> (N, 4) (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


def bbox_iou(box1: np.ndarray, box2: np.ndarray, x1y1x2y2: bool = True) -> np.ndarray:
    """IoU with the reference's +1 area convention (utils/utils.py:680-710);
    ``x1y1x2y2=False`` takes center-format boxes."""
    b1 = np.atleast_2d(np.asarray(box1, np.float64))
    b2 = np.atleast_2d(np.asarray(box2, np.float64))
    if not x1y1x2y2:
        b1, b2 = _corners(b1), _corners(b2)
    ix1 = np.maximum(b1[:, 0], b2[:, 0])
    iy1 = np.maximum(b1[:, 1], b2[:, 1])
    ix2 = np.minimum(b1[:, 2], b2[:, 2])
    iy2 = np.minimum(b1[:, 3], b2[:, 3])
    inter = np.clip(ix2 - ix1 + 1, 0, None) * np.clip(iy2 - iy1 + 1, 0, None)
    a1 = (b1[:, 2] - b1[:, 0] + 1) * (b1[:, 3] - b1[:, 1] + 1)
    a2 = (b2[:, 2] - b2[:, 0] + 1) * (b2[:, 3] - b2[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def non_max_suppression(
    prediction: np.ndarray,
    num_classes: int,
    conf_thres: float = 0.5,
    nms_thres: float = 0.4,
) -> List[Optional[np.ndarray]]:
    """(B, N, 5 + num_classes) center-format predictions -> per image an
    array of (x1, y1, x2, y2, obj_conf, class_conf, class_pred) rows, or
    None where no box passes ``conf_thres`` (utils/utils.py:583-642).
    Within a class, boxes go in descending ``obj_conf`` (a stable sort) and
    each kept box drops the later ones with IoU >= ``nms_thres``."""
    prediction = np.asarray(prediction, np.float64).copy()
    prediction[:, :, :4] = _corners(prediction.reshape(-1, prediction.shape[2])).reshape(
        prediction.shape[:2] + (4,)
    )
    output: List[Optional[np.ndarray]] = [None] * len(prediction)
    for i, image_pred in enumerate(prediction):
        image_pred = image_pred[image_pred[:, 4] >= conf_thres]
        if image_pred.shape[0] == 0:
            continue
        scores = image_pred[:, 5 : 5 + num_classes]
        detections = np.concatenate(
            [image_pred[:, :5], scores.max(axis=1, keepdims=True),
             scores.argmax(axis=1)[:, None].astype(np.float64)],
            axis=1,
        )
        for c in np.unique(detections[:, -1]):
            dc = detections[detections[:, -1] == c]
            dc = dc[np.argsort(-dc[:, 4], kind="stable")]
            keep = []
            while dc.shape[0]:
                keep.append(dc[0:1])
                if dc.shape[0] == 1:
                    break
                dc = dc[1:][bbox_iou(dc[0:1, :4], dc[1:, :4]) < nms_thres]
            kept = np.concatenate(keep, axis=0)
            output[i] = kept if output[i] is None else np.concatenate([output[i], kept], axis=0)
    return output
