"""PCK / PCKh / AP metrics with the reference's exact semantics.

Reference: utils/evaluate.py —
  * ``get_max_preds`` — per-channel argmax over the flattened heatmap,
    first-occurrence tie-breaking, (x, y) = (idx % W, floor(idx / W)),
    zeroed where the max value is <= 0 (:32-54);
  * ``calc_dists`` — joints whose *target* lands within 1px of the border
    (coord <= 1) are masked out with -1 (:5-19);
  * ``dist_acc`` — fraction of unmasked dists below threshold, -1 when no
    joint is measurable (:22-29);
  * "AP" — dist_acc at threshold 0.5 of dists normalized by heatmap
    size / 10 (:66-78);
  * PCKh — threshold x head-segment length, per-dataset head definition
    (:95-110); PCK — threshold x torso length, per-dataset torso definition
    (:130-156), including the reference's quirky BBC/MPII scalar norms which
    are deterministic and therefore reproduced;
  * slot 0 of each returned array is overwritten with the average over
    measurable joints (:88-89,:122-123,:168-169).

Counterpart of ``unipose_tpu/eval/metrics.py``: the numpy functions are
copied as they are.  Inputs are numpy arrays.  Layout is ``NCHW`` by
default (reference layout); pass ``layout="NHWC"`` for the JAX layout.  A
torch ``get_max_preds_device`` takes the argmax on the device (identical
first-max semantics) so eval loops only pull (K, 2) coords to host.
"""

from __future__ import annotations

import numpy as np
import torch


def get_max_preds(batch_heatmaps: np.ndarray):
    """(B, K, H, W) -> preds (B, K, 2) in (x, y), maxvals (B, K, 1)."""
    batch_size, num_joints = batch_heatmaps.shape[0], batch_heatmaps.shape[1]
    width = batch_heatmaps.shape[3]

    flat = batch_heatmaps.reshape((batch_size, num_joints, -1))
    idx = np.argmax(flat, 2).reshape((batch_size, num_joints, 1))
    maxvals = np.amax(flat, 2).reshape((batch_size, num_joints, 1))

    preds = np.tile(idx, (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = preds[:, :, 0] % width
    preds[:, :, 1] = np.floor(preds[:, :, 1] / width)

    pred_mask = np.tile(np.greater(maxvals, 0.0), (1, 1, 2)).astype(np.float32)
    return preds * pred_mask, maxvals


def get_max_preds_device(batch_heatmaps: torch.Tensor):
    """Device-side twin of :func:`get_max_preds` on NHWC input
    (B, H, W, K) -> ((B, K, 2) f32, (B, K, 1) f32), on the input's device.

    ``torch.argmax`` returns the first maximum in row-major order, as
    ``np.argmax`` does.
    """
    b, h, w, k = batch_heatmaps.shape
    flat = batch_heatmaps.movedim(-1, 1).reshape(b, k, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None].float()
    x = (idx % w).float()
    # integer division: exact, where a float division by w may be taken as
    # a product with 1/w on the card and land just below a whole row
    y = torch.div(idx, w, rounding_mode="floor").float()
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0), maxvals


def calc_dists(preds: np.ndarray, target: np.ndarray, normalize: np.ndarray):
    preds = preds.astype(np.float32)
    target = target.astype(np.float32)
    dists = np.zeros((preds.shape[1], preds.shape[0]))
    for n in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            if target[n, c, 0] > 1 and target[n, c, 1] > 1:
                normed_preds = preds[n, c, :] / normalize[n]
                normed_targets = target[n, c, :] / normalize[n]
                dists[c, n] = np.linalg.norm(normed_preds - normed_targets)
            else:
                dists[c, n] = -1
    return dists


def calc_dists_vectorized(
    preds: np.ndarray, target: np.ndarray, normalize: np.ndarray
) -> np.ndarray:
    """Vectorized twin of :func:`calc_dists` (bit-identical: the same
    divide-then-subtract order in f32, widened to f64 on store)."""
    preds = preds.astype(np.float32)
    target = target.astype(np.float32)
    measurable = (target[:, :, 0] > 1) & (target[:, :, 1] > 1)  # (N, K)
    diff = preds / normalize[:, None, :] - target / normalize[:, None, :]
    d = np.linalg.norm(diff, axis=-1)  # (N, K) f32
    return np.where(measurable, d.astype(np.float64), -1.0).T  # (K, N)


def dist_acc(dists: np.ndarray, threshold: float = 0.5):
    dist_cal = np.not_equal(dists, -1)
    num_dist_cal = dist_cal.sum()
    if num_dist_cal > 0:
        return np.less(dists[dist_cal], threshold).sum() * 1.0 / num_dist_cal
    return -1


def _head_length(target: np.ndarray, dataset: str) -> float:
    """Per-dataset head-segment length (Reference: evaluate.py:95-110).
    ``target`` are argmax coords including the background channel at 0."""
    if dataset == "LSP":
        return np.linalg.norm(target[0, 14, :] - target[0, 13, :])
    if dataset == "COCO":
        return np.linalg.norm(target[0, 4, :] - target[0, 5, :])
    if dataset == "Penn_Action":
        neck = [
            (target[0, 1, 0] + target[0, 2, 0]) / 2,
            (target[0, 1, 1] + target[0, 2, 1]) / 2,
        ]
        return np.linalg.norm(target[0, 0, :] - neck)
    if dataset == "NTID":
        return 2 * np.linalg.norm(target[0, 4, :] - target[0, 3, :])
    if dataset == "PoseTrack":
        return 2 * np.linalg.norm(target[0, 1, :] - target[0, 2, :])
    if dataset == "BBC":
        neck = [
            (target[0, 6, 0] + target[0, 7, 0]) / 2,
            (target[0, 6, 1] + target[0, 7, 1]) / 2,
        ]
        return np.linalg.norm(target[0, 1, :] - neck)
    if dataset == "MPII":
        return np.linalg.norm(target[0, 9, :] - target[0, 10, :])
    raise ValueError(f"unknown dataset {dataset!r}")


def _torso_length(target: np.ndarray, dataset: str) -> float:
    """Per-dataset torso length (Reference: evaluate.py:130-156), quirks and
    all (BBC mixes an x-coordinate with a 2-vector; MPII uses a scalar x
    difference — both deterministic, both reproduced)."""
    if dataset == "COCO":
        pelvis = [
            (target[0, 12, 0] + target[0, 13, 0]) / 2,
            (target[0, 12, 1] + target[0, 13, 1]) / 2,
        ]
        return np.linalg.norm(target[0, 13, :] - pelvis)
    if dataset == "Penn_Action":
        neck = (target[0, 1, :] + target[0, 2, :]) / 2
        pelvis = (target[0, 7, :] + target[0, 8, :]) / 2
        return np.linalg.norm(neck - pelvis)
    if dataset == "NTID":
        return np.linalg.norm(target[0, 3, :] - target[0, 1, :])
    if dataset == "PoseTrack":
        pelvis = (target[0, 6, :] + target[0, 7, :]) / 2
        neck = (target[0, 12, :] + target[0, 13, :]) / 2
        return np.linalg.norm(neck - pelvis)
    if dataset == "BBC":
        neck = [
            (target[0, 6, 0] + target[0, 7, 0]) / 2,
            (target[0, 6, 1] + target[0, 7, 1]) / 2,
        ]
        return np.linalg.norm(3 * (target[0, 1, 0] - neck))
    if dataset == "LSP":
        pelvis = [
            (target[0, 3, 0] + target[0, 4, 0]) / 2,
            (target[0, 3, 1] + target[0, 4, 1]) / 2,
        ]
        return np.linalg.norm(target[0, 13, :] - pelvis)
    if dataset == "MPII":
        return np.linalg.norm(target[0, 7, 0] - target[0, 8, 0])
    raise ValueError(f"unknown dataset {dataset!r}")


def accuracy(
    output: np.ndarray,
    target: np.ndarray,
    thr_PCK: float,
    thr_PCKh: float,
    dataset: str,
    hm_type: str = "gaussian",
    threshold: float = 0.5,
    layout: str = "NCHW",
):
    """Reference-compatible metric computation (evaluate.py:58-172).

    Returns (acc, PCK, PCKh, cnt, pred, visible); slot 0 of the per-joint
    arrays holds the mean over measurable joints.
    """
    output = np.asarray(output)
    target = np.asarray(target)
    if layout == "NHWC":
        output = np.moveaxis(output, -1, 1)
        target = np.moveaxis(target, -1, 1)

    if hm_type != "gaussian":
        raise ValueError(f"unknown hm_type {hm_type!r}")
    pred, _ = get_max_preds(output)
    target_pts, _ = get_max_preds(target)
    h, w = output.shape[2], output.shape[3]
    return accuracy_from_coords(
        pred, target_pts, h, w, thr_PCK, thr_PCKh, dataset, threshold=threshold
    )


def accuracy_from_coords(
    pred: np.ndarray,
    target_pts: np.ndarray,
    h: int,
    w: int,
    thr_PCK: float,
    thr_PCKh: float,
    dataset: str,
    threshold: float = 0.5,
):
    """Metric core on argmax coordinates — the TPU-first validation path
    (argmax runs on device via :func:`get_max_preds_device`, so only
    (B, K, 2) coords cross to host).  ``accuracy`` routes through this
    function after its host-side argmax, so the two paths agree by
    construction on everything past the argmax; argmax parity device vs
    numpy is pinned separately (tests/test_metrics.py)."""
    pred = np.asarray(pred)
    target_pts = np.asarray(target_pts)
    idx = list(range(pred.shape[1]))
    norm = np.ones((pred.shape[0], 2)) * np.array([h, w]) / 10

    dists = calc_dists_vectorized(pred, target_pts, norm)

    acc = np.zeros((len(idx)))
    avg_acc = 0.0
    cnt = 0
    visible = np.zeros((len(idx)))
    for i in range(len(idx)):
        acc[i] = dist_acc(dists[idx[i]], threshold)
        if acc[i] >= 0:
            avg_acc += acc[i]
            cnt += 1
            visible[i] = 1
        else:
            acc[i] = 0
    avg_acc = avg_acc / cnt if cnt != 0 else 0
    if cnt != 0:
        acc[0] = avg_acc

    head_len = _head_length(target_pts, dataset)
    PCKh = np.zeros((len(idx)))
    avg_PCKh = 0.0
    for i in range(len(idx)):
        PCKh[i] = dist_acc(dists[idx[i]], thr_PCKh * head_len)
        if PCKh[i] >= 0:
            avg_PCKh += PCKh[i]
        else:
            PCKh[i] = 0
    avg_PCKh = avg_PCKh / cnt if cnt != 0 else 0
    if cnt != 0:
        PCKh[0] = avg_PCKh

    torso_len = _torso_length(target_pts, dataset)
    PCK = np.zeros((len(idx)))
    avg_PCK = 0.0
    for i in range(len(idx)):
        PCK[i] = dist_acc(dists[idx[i]], thr_PCK * torso_len)
        if PCK[i] >= 0:
            avg_PCK += PCK[i]
        else:
            PCK[i] = 0
    avg_PCK = avg_PCK / cnt if cnt != 0 else 0
    if cnt != 0:
        PCK[0] = avg_PCK

    return acc, PCK, PCKh, cnt, pred, visible
