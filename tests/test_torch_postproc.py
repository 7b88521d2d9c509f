"""The port's multi-person decoding and NMS (``unipose_tpu_torch/postproc``)
against the JAX package's (``unipose_tpu/postproc``) on the same seeded
inputs: peak lists, people lists and NMS keeps exactly equal, IoUs within
1e-6.  The device peak detector runs here on CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import two_threads_for_the_module  # noqa: F401
from unipose_tpu.postproc import multi_person as jax_mp
from unipose_tpu.postproc import nms as jax_nms
from unipose_tpu_torch.postproc import multi_person as mp
from unipose_tpu_torch.postproc import nms


def gaussian_at(h, w, cy, cx, sigma=2.0):
    gy, gx = np.mgrid[0:h, 0:w]
    return np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / (2 * sigma**2))


def _two_gaussians():
    x = gaussian_at(46, 46, 10, 12) + gaussian_at(46, 46, 30, 35)
    x[x < 0.01] = 0
    return x


def _edges():
    x = gaussian_at(46, 46, 0, 45) + gaussian_at(46, 46, 45, 0) + gaussian_at(46, 46, 22, 7)
    x[x < 0.01] = 0
    return x


def _ties():
    """Two equal maxima side by side and a diagonal pair: a local maximum
    by float equality, so both of a pair are peaks."""
    x = np.zeros((20, 24), np.float32)
    x[5, 5] = x[5, 6] = 0.8
    x[12, 14] = x[13, 15] = 0.5
    x[4:7, 4] = 0.3
    return x


def _plateau():
    """A flat positive square (every pixel a local maximum, the interior
    eroded away only where it is background) beside a zero field."""
    x = np.zeros((16, 16), np.float32)
    x[3:9, 3:9] = 0.25
    x[12, 2] = 0.7
    return x


def _full_plateau():
    return np.full((9, 11), 0.5, np.float32)


def _zeros():
    return np.zeros((12, 10), np.float32)


def _noise():
    return np.random.RandomState(3).randn(46, 46).astype(np.float32)


def _quantised():
    """Values on a coarse grid: many equal neighbours."""
    return (np.random.RandomState(4).randint(0, 4, (30, 30)) / 4.0).astype(np.float32)


MAPS = {
    "two_gaussians": (_two_gaussians, 0.0),
    "edges": (_edges, 0.0),
    "ties": (_ties, 0.0),
    "plateau": (_plateau, 0.0),
    "full_plateau": (_full_plateau, 0.0),
    "all_zero": (_zeros, 0.0),
    "noise": (_noise, 0.0),
    "noise_threshold": (_noise, 0.6),
    "noise_negative_threshold": (_noise, -0.5),
    "quantised": (_quantised, 0.0),
    "quantised_threshold": (_quantised, 0.5),
    "gaussians_threshold": (_two_gaussians, 0.3),
}


def test_detect_peaks_matches_scipy():
    scipy_nd = pytest.importorskip("scipy.ndimage")
    x = _two_gaussians()
    got = mp.detect_peaks(x)
    # the scipy oracle (uniPose.py:57-65)
    structure = scipy_nd.generate_binary_structure(2, 2)
    local_max = scipy_nd.maximum_filter(x, footprint=structure) == x
    eroded = scipy_nd.binary_erosion(x == 0, structure=structure, border_value=1)
    want = [[int(r), int(c)] for r, c in zip(*np.nonzero(np.logical_xor(local_max, eroded) * x > 0))]
    assert got == want and len(got) == 2


@pytest.mark.parametrize("case", sorted(MAPS))
def test_detect_peaks_against_jax(case):
    """The host detector, the port's device detector on a CPU tensor and
    JAX's device detector: the same mask and the same peak list."""
    make, threshold = MAPS[case]
    x = make().astype(np.float32)
    host = mp.detect_peaks(x, threshold)
    assert host == jax_mp.detect_peaks(x, threshold)
    mask = mp.detect_peaks_device(torch.from_numpy(x), threshold)
    assert mask.dtype == torch.bool and mask.shape == x.shape
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_mp.detect_peaks_device(jnp.asarray(x), threshold))
    )
    assert [[int(r), int(c)] for r, c in torch.nonzero(mask).tolist()] == host


def test_detect_peaks_device_batched():
    """(N, C, H, W) maps in one call: each map's mask as alone."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 23, 17).astype(np.float32)
    x[0, 1] = 0
    mask = mp.detect_peaks_device(torch.from_numpy(x), 0.1)
    assert mask.shape == x.shape
    for b in range(2):
        for c in range(5):
            np.testing.assert_array_equal(
                mask[b, c].numpy(), mp.detect_peaks_device(torch.from_numpy(x[b, c]), 0.1).numpy()
            )
            assert [list(p) for p in torch.nonzero(mask[b, c]).tolist()] == mp.detect_peaks(x[b, c], 0.1)


def two_person_maps():
    """20 channels: background, 14 joints, 5 box channels (LSP), two
    people (tests/test_postproc_viz.py:50)."""
    maps = np.zeros((1, 20, 46, 46), np.float32)
    people = [((10, 10), (4, 4), (16, 4), (4, 16), (16, 16)),
              ((32, 32), (26, 26), (38, 26), (26, 38), (38, 38))]
    for center, tl, bl, tr, br in people:
        for ch, (r, c) in zip(range(15, 20), (center, tl, bl, tr, br)):
            maps[0, ch] += gaussian_at(46, 46, r, c, 1.5)
    maps[0, 1] += gaussian_at(46, 46, 8, 9, 1.0) + gaussian_at(46, 46, 30, 31, 1.0)
    for ch in range(15, 20):
        maps[0, ch][maps[0, ch] < 0.01] = 0
    return maps


def _random_box_maps(seed, c=20):
    rng = np.random.RandomState(seed)
    maps = rng.rand(1, c, 30, 30).astype(np.float32)
    maps[0, 15:] = np.where(maps[0, 15:] > 0.9, maps[0, 15:], 0)
    return maps


@pytest.mark.parametrize("case", ["two_people", "random_0", "random_1", "threshold", "mpii"])
def test_multi_person_kpts_against_jax(case):
    """numpy maps and the same maps as a tensor (device peaks) give JAX's
    people list."""
    dataset, num_joints, threshold = "LSP", 14, 0.0
    if case == "two_people":
        maps = two_person_maps()
    elif case == "mpii":
        maps, dataset, num_joints = _random_box_maps(7, c=22), "MPII", 16
    else:
        maps = _random_box_maps(int(case[-1]) if case[-1].isdigit() else 2)
        threshold = 0.95 if case == "threshold" else 0.0
    want = jax_mp.multi_person_kpts(maps, dataset, num_joints=num_joints, threshold=threshold)
    assert mp.multi_person_kpts(maps, dataset, num_joints, threshold) == want
    assert mp.multi_person_kpts(torch.from_numpy(maps), dataset, num_joints, threshold) == want
    if case == "two_people":
        assert len(want) == 2 * (14 + 5) and want[-1][0] == 1


def test_box_channel_starts_match():
    assert mp.BOX_CHANNEL_START == jax_mp.BOX_CHANNEL_START


def _boxes(rng, n, center=False):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([xy, wh], 1) if center else np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("x1y1x2y2", [True, False])
def test_bbox_iou_against_jax(x1y1x2y2):
    rng = np.random.RandomState(11)
    a, b = _boxes(rng, 1, not x1y1x2y2), _boxes(rng, 40, not x1y1x2y2)
    got = nms.bbox_iou(a, b, x1y1x2y2)
    want = jax_nms.bbox_iou(a, b, x1y1x2y2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nms.bbox_iou(b, b, x1y1x2y2), jax_nms.bbox_iou(b, b, x1y1x2y2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nms.bbox_iou(a[0], a[0], x1y1x2y2), [1.0])


@pytest.mark.parametrize("seed,num_classes,conf,iou", [(0, 1, 0.5, 0.4), (1, 3, 0.3, 0.5), (2, 4, 0.9, 0.2)])
def test_non_max_suppression_against_jax(seed, num_classes, conf, iou):
    """Clustered boxes over several classes and images; an image with no
    box above the confidence threshold gives None in both."""
    rng = np.random.RandomState(seed)
    b, n = 3, 60
    centers = rng.uniform(10, 90, (4, 2))[rng.randint(0, 4, b * n)] + rng.randn(b * n, 2) * 3
    pred = np.concatenate(
        [centers, rng.uniform(6, 20, (b * n, 2)), rng.rand(b * n, 1), rng.rand(b * n, num_classes)], 1
    ).reshape(b, n, 5 + num_classes)
    pred[2, :, 4] = conf / 2  # nothing passes
    got = nms.non_max_suppression(pred, num_classes, conf, iou)
    want = jax_nms.non_max_suppression(pred, num_classes, conf, iou)
    assert len(got) == len(want) == b and got[2] is None and want[2] is None
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.shape[0] >= 1
        np.testing.assert_array_equal(g[:, 4:], w[:, 4:])  # which boxes were kept, in order
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-6)
