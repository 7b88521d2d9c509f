"""Synthetic pose data with consistent geometry — the learning-validation
dataset (VERDICT r3 next-round #1).

The reference's only end-to-end correctness evidence is that its training
recipe (Reference: unipose.py:100-193) produces models that hit the paper's
PCK numbers on real data.  Real datasets and released checkpoints cannot be
fetched in this environment, so this module provides the strongest
in-environment substitute: a procedurally rendered stick-figure dataset
whose joints are visually identifiable (each joint carries a unique color
marker) and geometrically consistent (one articulated body model with
random placement/scale/rotation/pose jitter).  A correct implementation of
the COMPOSED training system — loader semantics, device-side Gaussian
targets, LR schedule, BN/EMA-vs-donation interaction, dropout keys, loss,
eval argmax — must drive held-out PCK@0.2 to ~1.0 on this data; silent bugs
in any of those parts hold it down.  Scored by the same metric path as real
data (eval/metrics.py, oracle-pinned against the reference evaluate.py).

Everything is deterministic from (seed, epoch): epoch e of the train split
regenerates the same batches, and the val split is fixed.

A copy of ``unipose_tpu/data/synthetic.py`` (numpy only): batches are
numpy arrays, and the trainer moves them to the device.

Layout matches the production loaders: LSP joint order (14 joints,
utils/lsp_lspet_data.py), images raw BGR-ish uint8 0..255 channel-last,
``kpts`` (K, 3) with visibility in [:, 2]; the video variant emits
(B, T, ...) clips with per-frame centers like data/penn_action.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Skeleton registry: one articulated body model per supported metric family,
# in unit body coordinates (x right, y down, origin near the pelvis).  Each
# carries its dataset's JOINT ORDER (core/config.py joint_names), limb set,
# unique per-joint marker colors, and the left/right joint sets used for the
# side-distinct limb strokes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    points: np.ndarray          # (K, 2) unit body coords
    limbs: tuple                # joint-index pairs
    colors: np.ndarray          # (K, 3) BGR marker colors
    right: frozenset            # right-side joint indices
    left: frozenset             # left-side joint indices

    @property
    def num_joints(self) -> int:
        return len(self.points)


# Base palette of saturated, mutually distinct BGR marker colors.
_PALETTE = np.array(
    [
        (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
        (255, 0, 255), (0, 255, 255), (128, 255, 0), (255, 128, 0),
        (0, 128, 255), (128, 0, 255), (255, 0, 128), (0, 255, 128),
        (255, 255, 255), (128, 128, 255), (64, 192, 255), (255, 192, 64),
        (192, 64, 128), (64, 128, 64), (200, 200, 80),
    ],
    np.float32,
)

# LSP order (utils/lsp_lspet_data.py): 0 R ankle .. 13 head top.
_LSP_SKELETON = Skeleton(
    name="LSP",
    points=np.array(
        [
            (-0.16, 0.95),   # 0  right ankle
            (-0.14, 0.55),   # 1  right knee
            (-0.12, 0.10),   # 2  right hip
            (0.12, 0.10),    # 3  left hip
            (0.14, 0.55),    # 4  left knee
            (0.16, 0.95),    # 5  left ankle
            (-0.42, 0.05),   # 6  right wrist
            (-0.33, -0.30),  # 7  right elbow
            (-0.20, -0.60),  # 8  right shoulder
            (0.20, -0.60),   # 9  left shoulder
            (0.33, -0.30),   # 10 left elbow
            (0.42, 0.05),    # 11 left wrist
            (0.0, -0.68),    # 12 neck
            (0.0, -0.95),    # 13 head top
        ],
        np.float32,
    ),
    limbs=(
        (0, 1), (1, 2), (2, 3), (3, 4), (4, 5),
        (6, 7), (7, 8), (8, 12), (12, 9), (9, 10), (10, 11),
        (2, 12), (3, 12), (12, 13),
    ),
    colors=_PALETTE[:14],
    right=frozenset((0, 1, 2, 6, 7, 8)),
    left=frozenset((3, 4, 5, 9, 10, 11)),
)

# MPII order (core/config.py MPII.joint_names): adds pelvis/thorax/upper-neck
# midline joints; its PCKh head segment is upper-neck..head-top (channels
# 9/10 in evaluate.py:125) and its PCK "torso" is the reference's scalar-x
# quirk |pelvis_x - thorax_x| (evaluate.py:156) — near zero on upright
# figures, which is why MPII learning validation targets PCKh (MPII's
# standard metric anyway).
_MPII_SKELETON = Skeleton(
    name="MPII",
    points=np.array(
        [
            (-0.16, 0.95), (-0.14, 0.55), (-0.12, 0.10),   # R leg
            (0.12, 0.10), (0.14, 0.55), (0.16, 0.95),      # L leg
            (0.0, 0.10),    # 6  pelvis
            (0.0, -0.45),   # 7  thorax
            (0.0, -0.68),   # 8  upper neck
            (0.0, -0.95),   # 9  head top
            (-0.42, 0.05), (-0.33, -0.30), (-0.20, -0.60),  # R arm
            (0.20, -0.60), (0.33, -0.30), (0.42, 0.05),     # L arm
        ],
        np.float32,
    ),
    limbs=(
        (0, 1), (1, 2), (2, 6), (6, 3), (3, 4), (4, 5),
        (6, 7), (7, 8), (8, 9),
        (10, 11), (11, 12), (12, 7), (7, 13), (13, 14), (14, 15),
    ),
    colors=_PALETTE[:16],
    right=frozenset((0, 1, 2, 10, 11, 12)),
    left=frozenset((3, 4, 5, 13, 14, 15)),
)

# BBC order (core/config.py BBC.joint_names): 7 upper-body joints; the
# metric's "neck" is the shoulder midpoint (evaluate.py:144-149).
_BBC_SKELETON = Skeleton(
    name="BBC",
    points=np.array(
        [
            (0.0, -0.90),    # 0 head
            (0.45, 0.30),    # 1 left hand
            (-0.45, 0.30),   # 2 right hand
            (0.33, -0.10),   # 3 left elbow
            (-0.33, -0.10),  # 4 right elbow
            (0.20, -0.55),   # 5 left shoulder
            (-0.20, -0.55),  # 6 right shoulder
        ],
        np.float32,
    ),
    limbs=((1, 3), (3, 5), (2, 4), (4, 6), (5, 6), (0, 5), (0, 6)),
    colors=_PALETTE[:7],
    right=frozenset((2, 4, 6)),
    left=frozenset((1, 3, 5)),
)

# Penn Action order (core/config.py PENN_ACTION.joint_names): 13 joints,
# head first, then alternating R/L shoulder..ankle; its PCKh "head" segment
# is head..shoulder-midpoint and torso is shoulder-mid..hip-mid
# (evaluate.py:99-104, 141-143 via eval/metrics.py).
_PENN_SKELETON = Skeleton(
    name="Penn_Action",
    points=np.array(
        [
            (0.0, -0.95),    # 0  head
            (-0.20, -0.60),  # 1  right shoulder
            (0.20, -0.60),   # 2  left shoulder
            (-0.33, -0.30),  # 3  right elbow
            (0.33, -0.30),   # 4  left elbow
            (-0.42, 0.05),   # 5  right wrist
            (0.42, 0.05),    # 6  left wrist
            (-0.12, 0.10),   # 7  right hip
            (0.12, 0.10),    # 8  left hip
            (-0.14, 0.55),   # 9  right knee
            (0.14, 0.55),    # 10 left knee
            (-0.16, 0.95),   # 11 right ankle
            (0.16, 0.95),    # 12 left ankle
        ],
        np.float32,
    ),
    limbs=(
        (0, 1), (0, 2), (1, 2),
        (1, 3), (3, 5), (2, 4), (4, 6),
        (1, 7), (2, 8), (7, 8),
        (7, 9), (9, 11), (8, 10), (10, 12),
    ),
    colors=_PALETTE[:13],
    right=frozenset((1, 3, 5, 7, 9, 11)),
    left=frozenset((2, 4, 6, 8, 10, 12)),
)

SKELETONS = {
    s.name: s
    for s in (_LSP_SKELETON, _MPII_SKELETON, _BBC_SKELETON, _PENN_SKELETON)
}

# Backwards-compatible module constants (LSP is the default skeleton).
_SKELETON = _LSP_SKELETON.points
_LIMBS = _LSP_SKELETON.limbs
_COLORS = _LSP_SKELETON.colors
_RIGHT_JOINTS = _LSP_SKELETON.right
_LEFT_JOINTS = _LSP_SKELETON.left
NUM_JOINTS = 14

# Side-distinct limb strokes (BGR).  Right-side limbs, left-side limbs and
# the midline get different colors: without this the figure is bilaterally
# symmetric up to the small joint markers, and the VIDEO variant — whose
# supervision is squeezed through the ConvLSTM bottleneck — can fall into a
# mirror local minimum (measured before side colors landed: PCK pinned at
# exactly 8/14 with a binary per-joint pattern).  Real datasets break this
# symmetry with appearance; synthetic data must break it explicitly.


def _limb_color(a: int, b: int, skel: Skeleton = _LSP_SKELETON) -> np.ndarray:
    if a in skel.right and b in skel.right:
        return np.array((60.0, 60.0, 190.0), np.float32)  # right: red-ish
    if a in skel.left and b in skel.left:
        return np.array((190.0, 90.0, 40.0), np.float32)  # left: blue-ish
    return np.array((90.0, 90.0, 90.0), np.float32)       # midline: gray


def _render_sample(rng: np.random.RandomState, size: int,
                   skel: Skeleton = _LSP_SKELETON):
    """One figure: returns (image (size, size, 3) float32 0..255,
    kpts (K, 3) float32 pixel coords + visibility=1, center (2,))."""
    # placement: keep every joint well inside the border (border-adjacent
    # targets are masked by the metric's visibility gate, evaluate.py:12-17)
    scale = size * rng.uniform(0.30, 0.42)
    theta = np.deg2rad(rng.uniform(-18.0, 18.0))
    rot = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
        np.float32,
    )
    pts = skel.points + rng.normal(0.0, 0.015, skel.points.shape).astype(np.float32)
    pts = pts @ rot.T * scale
    lo, hi = pts.min(0), pts.max(0)
    margin = 0.08 * size
    cx = rng.uniform(margin - lo[0], size - margin - hi[0])
    cy = rng.uniform(margin - lo[1], size - margin - hi[1])
    pts = pts + np.array([cx, cy], np.float32)

    img = _render_from_kpts(pts, size, rng, skel)
    kpts = np.concatenate(
        [pts, np.ones((skel.num_joints, 1), np.float32)], axis=1
    )
    center = np.array([cx, cy], np.float32)
    return img, kpts, center


@dataclasses.dataclass
class SyntheticPoseLoader:
    """Image-variant loader with the Trainer's loader protocol
    (__len__/set_epoch/__iter__ yielding dict batches; ``batch_size``
    attribute for the padded validation path).

    Each sample is a fixed function of (seed, index), rendered once and
    cached — epochs only reshuffle batch composition (``fixed=True``, the
    val split, keeps dataset order).  Rendering is host numpy; caching
    keeps the 1-vCPU host out of the training loop's critical path."""

    num_samples: int = 256
    batch_size: int = 8
    input_size: int = 184
    seed: int = 0
    fixed: bool = False  # val split: identical order every epoch
    dataset: str = "LSP"  # skeleton / joint order (SKELETONS)

    def __post_init__(self):
        self._epoch = 0
        self._cache = {}
        self._skel = SKELETONS[self.dataset]

    def __len__(self) -> int:
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _sample(self, index: int):
        if index not in self._cache:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + index) % (2**31 - 1)
            )
            img, kp, _ = _render_sample(rng, self.input_size, self._skel)
            self._cache[index] = (img, kp)
        return self._cache[index]

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(self.num_samples)
        if not self.fixed:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        for start in range(0, self.num_samples, self.batch_size):
            idx = order[start : start + self.batch_size]
            samples = [self._sample(int(i)) for i in idx]
            yield {
                "image": np.stack([s[0] for s in samples]),
                "kpts": np.stack([s[1] for s in samples]),
            }


@dataclasses.dataclass
class SyntheticVideoLoader:
    """Video-variant loader: T-frame clips of one figure translating with
    constant velocity (joint positions fully predictable from appearance;
    motion exercises the ConvLSTM carry)."""

    num_clips: int = 64
    batch_size: int = 2
    frame_memory: int = 5
    input_size: int = 184
    seed: int = 0
    fixed: bool = False
    dataset: str = "LSP"  # skeleton / joint order (SKELETONS)

    def __post_init__(self):
        self._epoch = 0
        self._cache = {}
        self._skel = SKELETONS[self.dataset]

    def __len__(self) -> int:
        return (self.num_clips + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _render_clip(self, index: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + index) % (2**31 - 1)
        )
        size, t = self.input_size, self.frame_memory
        img0, kp0, c0 = _render_sample(rng, size, self._skel)
        vel = rng.uniform(-0.015 * size, 0.015 * size, 2).astype(np.float32)
        frames, kpts, centers = [img0], [kp0], [c0]
        for _ in range(1, t):
            prev_k = kpts[-1]
            shift = vel
            # keep in bounds: reflect when the figure would leave the margin
            nk = prev_k[:, :2] + shift
            if nk.min() < 0.04 * size or nk.max() > 0.96 * size:
                vel = -vel
                nk = prev_k[:, :2] + vel
            k = np.concatenate(
                [nk, np.ones((self._skel.num_joints, 1), np.float32)], 1
            )
            frames.append(_render_from_kpts(nk, size, rng, self._skel))
            kpts.append(k)
            centers.append(centers[-1] + vel)
        return np.stack(frames), np.stack(kpts), np.stack(centers)

    def _clip(self, index: int):
        if index not in self._cache:
            self._cache[index] = self._render_clip(index)
        return self._cache[index]

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(self.num_clips)
        if not self.fixed:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        for start in range(0, self.num_clips, self.batch_size):
            idx = order[start : start + self.batch_size]
            clips = [self._clip(int(i)) for i in idx]
            yield {
                "frames": np.stack([c[0] for c in clips]),
                "kpts": np.stack([c[1] for c in clips]),
                "centers": np.stack([c[2] for c in clips]),
            }


def _render_from_kpts(
    pts: np.ndarray, size: int, rng: np.random.RandomState,
    skel: Skeleton = _LSP_SKELETON,
) -> np.ndarray:
    """Render one frame for given joint pixel positions: background clutter,
    side-colored limb strokes, unique per-joint color markers."""
    img = np.full((size, size, 3), 32.0, np.float32)
    # light background clutter so the net cannot key on raw brightness
    for _ in range(6):
        x0, y0 = rng.randint(0, size, 2)
        w, h = rng.randint(2, max(3, size // 8), 2)
        img[y0 : y0 + h, x0 : x0 + w] += rng.uniform(0, 40)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for a, b in skel.limbs:
        pa, pb = pts[a], pts[b]
        d = pb - pa
        L2 = float(d @ d) + 1e-6
        t = np.clip(((xx - pa[0]) * d[0] + (yy - pa[1]) * d[1]) / L2, 0.0, 1.0)
        dist2 = (xx - (pa[0] + t * d[0])) ** 2 + (yy - (pa[1] + t * d[1])) ** 2
        img[dist2 < (0.012 * size) ** 2] = _limb_color(a, b, skel)
    r2 = (0.022 * size) ** 2
    for j in range(skel.num_joints):
        mask = (xx - pts[j, 0]) ** 2 + (yy - pts[j, 1]) ** 2 < r2
        img[mask] = skel.colors[j]
    return np.clip(img + rng.normal(0, 4.0, img.shape), 0, 255).astype(np.float32)


def make_loaders(
    variant: str = "image",
    *,
    input_size: int = 184,
    train_samples: int = 256,
    val_samples: int = 64,
    batch_size: int = 8,
    val_batch_size: Optional[int] = None,
    frame_memory: int = 5,
    seed: int = 0,
    dataset: str = "LSP",
):
    """(train_loader, val_loader, None) for Trainer(loaders=...).
    ``dataset`` selects the skeleton / joint order (SKELETONS: LSP, MPII,
    BBC) so the learning validation can exercise each metric family."""
    vb = val_batch_size or batch_size
    if variant == "lstm":
        return (
            SyntheticVideoLoader(
                num_clips=train_samples,
                batch_size=batch_size,
                frame_memory=frame_memory,
                input_size=input_size,
                seed=seed,
                dataset=dataset,
            ),
            SyntheticVideoLoader(
                num_clips=val_samples,
                batch_size=vb,
                frame_memory=frame_memory,
                input_size=input_size,
                seed=seed + 777,
                fixed=True,
                dataset=dataset,
            ),
            None,
        )
    return (
        SyntheticPoseLoader(
            num_samples=train_samples,
            batch_size=batch_size,
            input_size=input_size,
            seed=seed,
            dataset=dataset,
        ),
        SyntheticPoseLoader(
            num_samples=val_samples,
            batch_size=vb,
            input_size=input_size,
            seed=seed + 777,
            fixed=True,
            dataset=dataset,
        ),
        None,
    )
