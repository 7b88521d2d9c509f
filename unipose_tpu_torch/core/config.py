"""Configuration layer: dataset specs, the model config and the image
training recipe.

Counterpart of ``unipose_tpu/core/config.py``.  The dataset specs are copied
as they are; ``ModelConfig`` holds the image and video models' fields, with
``compute_dtype`` a ``torch.dtype``; ``TrainConfig`` holds the image
training fields.  The video-training, parallelism and checkpoint-manager
fields arrive with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Dataset specifications
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static description of one supported dataset.

    ``swap_pairs`` are the horizontal-flip joint exchanges
    (Reference: utils/Mytransforms.py:513 (LSP), :533 (BBC), :554 (NTID)).
    ``joint_names`` follow the per-joint report printer
    (Reference: utils/utils.py:354-473).
    """

    name: str
    num_joints: int
    sigma: float = 3.0
    stride: int = 8
    input_size: int = 368
    is_video: bool = False
    frame_memory: int = 1
    swap_pairs: Tuple[Tuple[int, int], ...] = ()
    joint_names: Tuple[str, ...] = ()

    @property
    def num_channels(self) -> int:
        """Heatmap channels = joints + 1 background channel
        (Reference: utils/lsp_lspet_data.py:224,234)."""
        return self.num_joints + 1

    @property
    def heatmap_size(self) -> int:
        return self.input_size // self.stride


LSP = DatasetSpec(
    name="LSP",
    num_joints=14,
    sigma=3.0,
    swap_pairs=((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9)),
    joint_names=(
        "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
        "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
        "Left Shoulder", "Left Elbow", "Left Wrist", "Neck", "Head Top",
    ),
)

MPII = DatasetSpec(
    name="MPII",
    num_joints=16,
    sigma=3.0,
    joint_names=(
        "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
        "Left Ankle", "Pelvis", "Thorax", "Upper Neck", "Head Top",
        "Right Wrist", "Right Elbow", "Right Shoulder", "Left Shoulder",
        "Left Elbow", "Left Wrist",
    ),
)

PENN_ACTION = DatasetSpec(
    name="Penn_Action",
    num_joints=13,
    sigma=1.0,
    is_video=True,
    frame_memory=5,
    joint_names=(
        "Head", "Right Shoulder", "Left Shoulder", "Right Elbow",
        "Left Elbow", "Right Wrist", "Left Wrist", "Right Hip", "Left Hip",
        "Right Knee", "Left Knee", "Right Ankle", "Left Ankle",
    ),
)

BBC = DatasetSpec(
    name="BBC",
    num_joints=7,
    sigma=1.0,
    is_video=True,
    frame_memory=5,
    swap_pairs=((1, 2), (3, 4), (5, 6)),
    joint_names=(
        "Head", "Left Hand", "Right Hand", "Left Elbow", "Right Elbow",
        "Left Shoulder", "Right Shoulder",
    ),
)

NTID = DatasetSpec(
    name="NTID",
    num_joints=19,
    sigma=3.0,
    # The reference's NTID flip reuses the LSP swap pairs
    # (Mytransforms.py:616-639 via RandomHorizontalFlip_NTID).
    swap_pairs=((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9)),
    joint_names=(
        "Spine Base", "Spine Mid", "Neck", "Head",
        "Shoulder Left", "Elbow Left", "Wrist Left", "Hand Tip Left",
        "Shoulder Right", "Elbow Right", "Wrist Right", "Hand Tip Right",
        "Hip Left", "Hip Right", "Spine Shoulder",
        "Hand Left", "Thumb Left", "Hand Right", "Thumb Right",
    ),  # per-joint printer (Reference: utils/utils.py:429-459)
)

POSETRACK = DatasetSpec(
    name="PoseTrack",
    num_joints=17,
    sigma=3.0,
    swap_pairs=((3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)),
    joint_names=(
        "Nose", "Head Bottom", "Head Top", "Left Ear", "Right Ear",
        "Left Shoulder", "Right Shoulder", "Left Elbow", "Right Elbow",
        "Left Wrist", "Right Wrist", "Left Hip", "Right Hip",
        "Left Knee", "Right Knee", "Left Ankle", "Right Ankle",
    ),  # public PoseTrack18 order; matches evaluate.py's norm indices
)

DATASETS = {d.name: d for d in (LSP, MPII, PENN_ACTION, BBC, NTID, POSETRACK)}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters.

    Defaults mirror the reference model constructors
    (Reference: model/unipose.py:9-10, model/uniposeLSTM.py:68-69).
    """

    dataset: str = "LSP"
    num_classes: int = 14
    output_stride: int = 16
    stride: int = 8
    variant: str = "image"  # "image" | "lstm"
    # dtype policy: the f32 weights are cast once to the compute dtype;
    # BN statistics and heatmaps stay f32.
    compute_dtype: torch.dtype = torch.float32
    # Replicate the reference's double application of wasp.conv2
    # (Reference: model/modules/wasp.py:72-80) for pretrained-weight parity.
    wasp_double_conv2: bool = True
    # Fine-tune with BN frozen to its running statistics: in train mode every
    # BatchNorm normalises with (and does not update) its running stats; its
    # affine parameters still train (Reference: model/unipose.py:24-25,40-45).
    freeze_bn: bool = False
    # Video variant: initialise the 11x11 head's conv biases at the positive
    # torch bound (+1/sqrt(fan_in)) instead of U(+-bound), so every channel
    # behind the head's final ReLU starts alive (``models.layers.conv``'s
    # ``bias_positive``).
    head_positive_bias: bool = False
    # Video variant only: number of ConvLSTM rollout frames (a chunk).
    frame_memory: int = 5


# ---------------------------------------------------------------------------
# Train config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Image training recipe (Reference: unipose.py:46-56).  The batch
    size is the loaders' (``make_loaders(batch_size=)``); the epoch count
    and validation batch arrive with ``cli/train.py``, which reads them."""

    lr: float = 1e-4
    gamma: float = 0.333
    step_size: int = 13275
    # Target-rendering overrides; None means the dataset spec's value (see
    # ``effective_spec``).
    sigma: Optional[float] = None
    stride: Optional[int] = None
    seed: int = 0
    # Linear LR warmup over the first N updates (0 = off, the reference).
    warmup_steps: int = 0
    # ``<model_name>_best`` is the best-mAP checkpoint; "" writes none.
    model_name: str = "unipose"


def effective_spec(spec: DatasetSpec, train: TrainConfig) -> DatasetSpec:
    """The dataset spec with ``TrainConfig.sigma``/``stride`` applied when
    set: the one source of truth for target rendering, read by the loaders
    and the steps (never ``TrainConfig.sigma``/``stride`` directly)."""
    overrides = {}
    if train.sigma is not None:
        overrides["sigma"] = float(train.sigma)
    if train.stride is not None:
        overrides["stride"] = int(train.stride)
    return dataclasses.replace(spec, **overrides) if overrides else spec
