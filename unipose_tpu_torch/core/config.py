"""Configuration layer: dataset specs, the model config and the image
training recipe, the presets and the YAML loader.

Counterpart of ``unipose_tpu/core/config.py``.  The dataset specs are copied
as they are; ``ModelConfig`` holds the image and video models' fields, with
``compute_dtype`` a ``torch.dtype``; ``TrainConfig`` holds the training
fields that the port reads.  Data parallelism is here: ``ModelConfig.
sync_bn`` and ``TrainConfig.mesh_shape``/``mesh_axes``, whose axes are
ranks (processes, one card each; ``parallel/mesh.py``), and so is time
parallelism: ``ModelConfig.spmd_axes`` with a ("data", "time") mesh
(``parallel/cp.py``).  ``donate_state`` has no PyTorch meaning (a step
updates the state in place) and is left out.
The presets carry every field the port's configs have.
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
    # Video training only: recompute the ConvLSTM cell of each frame in the
    # backward instead of keeping its activations (a checkpoint a frame).
    remat_scan: bool = False
    # Video training only: recompute each bottleneck of the per-frame
    # backbone in the backward (``ResNet101(remat_blocks=True)``): its
    # activations, which grow with B*T, are what long rollouts run out of.
    remat_tower: bool = False
    # Data-parallel BatchNorm (the reference accepts the flag and ignores
    # it, model/unipose.py:14).  True: train-mode statistics over the
    # global batch, all-reduced across the ranks (TorchBatchNorm with a
    # process group).  False: per-rank statistics; the Trainer builds the
    # model with one statistics group per data-parallel shard, and the
    # running statistics update from the pooled moments so the ranks'
    # buffers stay equal.
    sync_bn: bool = True
    # Video variant only: time (sequence) parallelism, the mesh axis names
    # (data_axis, time_axis).  When set, a train step under
    # ``parallel.cp.under_mesh`` runs the tower and the head on the rank's
    # frames of its clips and the ConvLSTM over every frame of each clip
    # (its features gathered over the time axis); ``cli/train.py
    # --time_parallel`` sets it with a ("data", "time") mesh.
    spmd_axes: Optional[Tuple[Optional[str], Optional[str]]] = None


# ---------------------------------------------------------------------------
# Train config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Image training recipe (Reference: unipose.py:46-56)."""

    batch_size: int = 8
    lr: float = 1e-4
    gamma: float = 0.333
    step_size: int = 13275
    epochs: int = 100
    # Loader threads of the Python data route (data/loader.py).
    workers: int = 1
    # Target-rendering overrides; None means the dataset spec's value (see
    # ``effective_spec``).
    sigma: Optional[float] = None
    stride: Optional[int] = None
    seed: int = 0
    # Linear LR warmup over the first N updates (0 = off, the reference).
    warmup_steps: int = 0
    # Periodic checkpoints (one an epoch) and auto-resume from the newest
    # (train/checkpoint.py::CheckpointManager); None writes none.
    checkpoint_dir: Optional[str] = None
    # ``<model_name>_best`` is the best-mAP checkpoint; "" writes none.
    model_name: str = "unipose"
    # Validation forward batch size.  The reference validates at batch 1
    # (unipose.py:64); the metrics stay per frame whatever it is.
    val_batch_size: int = 8
    # The ranks as a mesh (parallel/mesh.py::make_mesh): one -1 takes the
    # world size; ``batch_size`` is the global batch, split over "data".
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)


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


# ---------------------------------------------------------------------------
# The five BASELINE.json presets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    model: ModelConfig
    train: TrainConfig


PRESETS = {
    # 1. UniPose ResNet-101+WASP single-image inference on LSP
    "lsp_infer": Preset(
        name="lsp_infer",
        description="UniPose single-image inference on LSP (368x368, batch 1, 14 joints)",
        model=ModelConfig(dataset="LSP", num_classes=14),
        train=TrainConfig(batch_size=1, sigma=3.0),
    ),
    # 2. MPII single-person training recipe
    "mpii_train": Preset(
        name="mpii_train",
        description="MPII single-person training (16 joints, Gaussian targets, aug)",
        model=ModelConfig(dataset="MPII", num_classes=16),
        train=TrainConfig(batch_size=8, sigma=3.0, model_name="unipose_mpii"),
    ),
    # 3. UniPose-LSTM on Penn Action
    "penn_lstm": Preset(
        name="penn_lstm",
        description="UniPose-LSTM on Penn Action (5-frame ConvLSTM rollout)",
        model=ModelConfig(
            dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=5
        ),
        train=TrainConfig(batch_size=1, sigma=1.0, model_name="uniposeLSTM_penn"),
    ),
    # 4. BBC Pose video eval
    "bbc_lstm": Preset(
        name="bbc_lstm",
        description="BBC Pose video eval (7 joints, long sequences through the LSTM scan)",
        model=ModelConfig(dataset="BBC", num_classes=7, variant="lstm", frame_memory=5),
        train=TrainConfig(batch_size=1, sigma=1.0, model_name="uniposeLSTM_bbc"),
    ),
    # 5. Batched multi-clip data-parallel training, bf16
    "multichip_video": Preset(
        name="multichip_video",
        description="Multi-clip video training, GSPMD data-parallel, bf16",
        model=ModelConfig(
            dataset="Penn_Action",
            num_classes=13,
            variant="lstm",
            frame_memory=5,
            sync_bn=True,
            compute_dtype=torch.bfloat16,
        ),
        train=TrainConfig(
            batch_size=32, sigma=1.0, mesh_shape=(-1,), model_name="uniposeLSTM_multichip"
        ),
    ),
}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"Unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None


def load_yaml_config(path: str) -> Preset:
    """YAML -> (ModelConfig, TrainConfig) preset: top-level keys ``preset``
    (optional base), ``model`` and ``train`` override preset fields.  A key
    that the port's dataclasses lack raises (``dataclasses.replace``).
    PyYAML is imported here only: nothing on the card's path reads YAML."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    base = get_preset(raw["preset"]) if "preset" in raw else PRESETS["lsp_infer"]
    model = dataclasses.replace(base.model, **raw.get("model", {}))
    train = dataclasses.replace(base.train, **raw.get("train", {}))
    return Preset(
        name=raw.get("name", base.name),
        description=raw.get("description", base.description),
        model=model,
        train=train,
    )
