"""The port's time parallelism in one process (``parallel/cp.py``,
``cli/train.py::apply_time_parallel``, the ``Trainer``'s checks, the
dropout rows of a (clip, frame) block), against the JAX package's
``unipose_tpu/parallel/cp.py`` on conftest's 8-device CPU mesh.  Nothing
here joins a process group: the ranks run in tests/test_torch_cp_ranks.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from unipose_tpu.cli.train import apply_time_parallel as jax_apply_time_parallel
from unipose_tpu.core.config import ModelConfig as JaxModelConfig
from unipose_tpu.core.config import TrainConfig as JaxTrainConfig
from unipose_tpu.parallel import cp as jax_cp
from unipose_tpu_torch.cli.train import apply_time_parallel
from unipose_tpu_torch.core.config import ModelConfig, TrainConfig
from unipose_tpu_torch.models.layers import Dropout
from unipose_tpu_torch.models.unipose import init_model
from unipose_tpu_torch.parallel import cp
from unipose_tpu_torch.parallel.mesh import make_mesh
from unipose_tpu_torch.train.trainer import Trainer

B, T, SIZE, K = 2, 4, 16, 13
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
VIDEO = dict(dataset="Penn_Action", num_classes=K, variant="lstm", frame_memory=T)


def _batch():
    """Every leaf kind: the three per-frame clip leaves, per-clip leaves of
    ndim 1, 2 and 3 (a (B, K, 3) leaf's K is not time), a list and a
    scalar, nested one level."""
    rng = np.random.RandomState(0)
    return {
        "frames": rng.rand(B, T, SIZE, SIZE, 3).astype(np.float32),
        "kpts": rng.rand(B, T, K, 3).astype(np.float32),
        "centers": rng.rand(B, T, 2).astype(np.float32),
        "clip_id": np.arange(B, dtype=np.int32),
        "clip_label": rng.rand(B, 6).astype(np.float32),
        "meta": {"joints": rng.rand(B, K, 3).astype(np.float32), "frames": rng.rand(B, T, 2).astype(np.float32)},
        "paths": ["a", "b"],
        "scale": np.float32(2.0),
    }


LEAVES = {"frames": ("frames",), "kpts": ("kpts",), "centers": ("centers",), "clip_id": ("clip_id",),
          "clip_label": ("clip_label",), "per_clip_kx3": ("meta", "joints"),
          "nested_clip_leaf": ("meta", "frames")}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,n_time,world", [(2, 2, 4), (1, -1, 4), (2, -1, 8), (-1, 2, 8), (1, 1, 1)],
                         ids=["2x2", "1x-1", "2x-1", "-1x2", "1x1"])
def test_video_mesh_matches_jax(n_data, n_time, world, eight_devices):
    """Shape and every rank's (data, time) coordinate: the position of
    device r in JAX's mesh over the first ``world`` devices; time minor."""
    want = jax_cp.make_video_mesh(n_data, n_time, devices=eight_devices[:world])
    for r in range(world):
        mesh = cp.make_video_mesh(n_data, n_time, world=world, rank=r)
        assert mesh.shape == want.devices.shape and mesh.axis_names == ("data", "time")
        (pos,) = np.argwhere(want.devices == eight_devices[r])
        assert (mesh.coordinate("data"), mesh.coordinate("time")) == tuple(pos) == divmod(r, mesh.shape[1])
        assert cp.time_group(mesh) is None  # no process group here


def test_video_mesh_refuses_what_jax_refuses(eight_devices):
    for n_data, n_time, match in ((1, 3, "stranding 1"), (5, -1, "at least 5"), (2, 4, "needs 8 devices")):
        with pytest.raises(ValueError, match=match):
            jax_cp.make_video_mesh(n_data, n_time, devices=eight_devices[:4])
        with pytest.raises(ValueError, match=match):
            cp.make_video_mesh(n_data, n_time, world=4)


def test_time_group_needs_the_groups_of_make_video_mesh():
    mesh = dataclasses.replace(make_mesh((2, 2), ("data", "time"), world=4), distributed=True)
    with pytest.raises(ValueError, match="make_video_mesh"):
        cp.time_group(mesh)


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", list(LEAVES), ids=list(LEAVES))
@pytest.mark.parametrize("mesh_name", list(MESHES), ids=list(MESHES))
def test_shard_clip_batch_matches_jax_shards(mesh_name, leaf, eight_devices):
    """Every rank's block of the leaf equals JAX's addressable shard on the
    device at the same mesh position; numpy in, numpy out, and torch
    tensors give the same block."""
    n_data, n_time = MESHES[mesh_name]
    batch = _batch()
    jmesh = jax_cp.make_video_mesh(n_data, n_time, devices=eight_devices[:n_data * n_time])
    jleaf = _leaf(jax_cp.shard_clip_batch(batch, jmesh), LEAVES[leaf])
    torch_batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items() if k != "meta"}
    for r in range(n_data * n_time):
        mesh = cp.make_video_mesh(n_data, n_time, world=n_data * n_time, rank=r)
        dev = jmesh.devices[mesh.coordinate("data"), mesh.coordinate("time")]
        (want,) = [np.asarray(s.data) for s in jleaf.addressable_shards if s.device == dev]
        out = cp.shard_clip_batch(batch, mesh)
        got = _leaf(out, LEAVES[leaf])
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        if LEAVES[leaf][0] in torch_batch:
            np.testing.assert_array_equal(cp.shard_clip_batch(torch_batch, mesh)[leaf].numpy(), want)
        assert out["paths"] == ["a", "b"] and out["scale"] == np.float32(2.0)


def test_clip_sharding_refuses_uneven_blocks():
    mesh = cp.make_video_mesh(2, 2, world=4, rank=3)
    assert cp.clip_sharding(mesh, 4, 6) == (slice(2, 4), slice(3, 6))
    with pytest.raises(ValueError, match="clip count 3"):
        cp.shard_clip_batch({"frames": np.zeros((3, 4, 2))}, mesh)
    with pytest.raises(ValueError, match="frame count 5"):
        cp.shard_clip_batch({"frames": np.zeros((2, 5, 2))}, mesh)


# ---------------------------------------------------------------------------
# --time_parallel and the Trainer's checks
# ---------------------------------------------------------------------------


def test_apply_time_parallel_configs():
    """The configs JAX's sets (tests/test_cp.py:399); 1 leaves them."""
    mc = ModelConfig(**VIDEO)
    tc = TrainConfig(batch_size=1)
    mc2, tc2 = apply_time_parallel(mc, tc, 4, world=8)
    jmc, jtc = jax_apply_time_parallel(JaxModelConfig(**VIDEO), JaxTrainConfig(batch_size=1), 4)
    assert mc2.spmd_axes == jmc.spmd_axes == ("data", "time")
    assert tc2.mesh_shape == jtc.mesh_shape == (-1, 4)
    assert tc2.mesh_axes == jtc.mesh_axes == ("data", "time")
    assert dataclasses.replace(mc2, spmd_axes=None) == mc and apply_time_parallel(mc, tc, 1, 8) == (mc, tc)


@pytest.mark.parametrize("variant,frame_memory,n_time", [("image", 4, 2), ("lstm", 5, 3), ("lstm", 5, 4)],
                         ids=["image_model", "world", "frame_memory"])
def test_apply_time_parallel_refuses_as_jax(variant, frame_memory, n_time, eight_devices):
    """The same three refusals, word for word (tests/test_cp.py:399, :525;
    JAX's device count is conftest's 8, the port's world 8 ranks)."""
    fields = dict(VIDEO, variant=variant, frame_memory=frame_memory)
    with pytest.raises(SystemExit) as want:
        jax_apply_time_parallel(JaxModelConfig(**fields), JaxTrainConfig(batch_size=1), n_time)
    with pytest.raises(SystemExit) as got:
        apply_time_parallel(ModelConfig(**fields), TrainConfig(batch_size=1), n_time, world=8)
    assert str(got.value) == str(want.value)


def test_trainer_refuses_what_jax_refuses():
    """sync_bn=False with a time axis (JAX trainer.py:111-115); spmd_axes
    without the mesh's axes (tests/test_cp.py:470); and, the port's own,
    a mesh that leaves ranks out, a frame_memory the time axis does not
    divide.  Each before the model is built."""
    cp_config = ModelConfig(**VIDEO, spmd_axes=("data", "time"))
    grid = cp.make_video_mesh(2, 2, world=4)
    with pytest.raises(ValueError, match="context parallelism"):
        Trainer(dataclasses.replace(cp_config, sync_bn=False), TrainConfig(batch_size=2),
                loaders=(None, None), device="cpu", mesh=grid)
    with pytest.raises(ValueError, match="spmd_axes"):
        Trainer(cp_config, TrainConfig(batch_size=1), loaders=(None, None), device="cpu")
    with pytest.raises(ValueError, match="every rank must train"):
        with pytest.warns(UserWarning, match="2 idle"):
            Trainer(cp_config, TrainConfig(batch_size=2), loaders=(None, None), device="cpu",
                    mesh=make_mesh((1, 2), ("data", "time"), world=4))
    with pytest.raises(ValueError, match="frame_memory 5"):
        Trainer(dataclasses.replace(cp_config, frame_memory=5), TrainConfig(batch_size=2),
                loaders=(None, None), device="cpu", mesh=grid)


# ---------------------------------------------------------------------------
# dropout masks and the model under a mesh of one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mesh_name", list(MESHES), ids=list(MESHES))
def test_dropout_blocks_stitch_into_the_one_process_mask(mesh_name, dtype):
    """Each rank keeps the global mask's rows (d*b_loc + i)*T + j*t_loc + k;
    put back at those rows, the ranks' masks are one process's mask."""
    n_data, n_time = MESHES[mesh_name]
    b_loc, t_loc = B // n_data, T // n_time
    shape = (B * T, 8, 3, 5)
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(7)
    want = drop(torch.ones(shape, dtype=dtype).contiguous(memory_format=torch.channels_last))
    got = torch.full(shape, -1.0, dtype=dtype)
    for d in range(n_data):
        for j in range(n_time):
            drop.generator = torch.Generator().manual_seed(7)
            drop.shard = (d, n_data, j, n_time, t_loc)
            x = torch.ones((b_loc * t_loc,) + shape[1:], dtype=dtype).contiguous(memory_format=torch.channels_last)
            rows = [(d * b_loc + i) * T + j * t_loc + k for i in range(b_loc) for k in range(t_loc)]
            got[rows] = drop(x)
    assert torch.equal(got, want)


def test_dropout_data_only_shard_is_the_five_field_form():
    """(rank, ranks), data parallelism's form, is (rank, ranks, 0, 1, 1):
    contiguous rows, bit for bit."""
    drop = Dropout(0.1).train()
    x = torch.rand(3, 4, 5, 5)
    out = []
    for shard in ((1, 4), (1, 4, 0, 1, 1)):
        drop.generator, drop.shard = torch.Generator().manual_seed(3), shard
        out.append(drop(x))
    drop.generator, drop.shard = torch.Generator().manual_seed(3), None
    full = drop(torch.cat([x] * 4))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], full[3:6])


def test_model_under_a_one_rank_mesh_is_the_plain_model():
    """spmd_axes under a (1, 1) mesh: no group, the gather is the identity,
    the heatmaps and the final state bit for bit the model without it; in
    train mode outside under_mesh the model refuses to run."""
    torch.manual_seed(0)
    frames, cm = torch.rand(1, T, 3, SIZE, SIZE), torch.rand(1, T, 1, SIZE, SIZE)
    plain = init_model(ModelConfig(**VIDEO), seed=2, device="cpu", layers=(1, 1, 1, 1))
    model = init_model(ModelConfig(**VIDEO, spmd_axes=("data", "time")), seed=2, device="cpu",
                       layers=(1, 1, 1, 1))
    mesh = cp.make_video_mesh(1, 1)
    with torch.no_grad():
        want = plain(frames, cm)
        got = cp.under_mesh(mesh, model)(frames, cm)
        assert cp.bound_mesh() is None
        assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        assert torch.equal(model(frames, cm)[0], want[0])  # eval outside the mesh: whole clips
    with pytest.raises(RuntimeError, match="under_mesh"):
        model.train()(frames, cm)
    z = torch.rand(1, 2, 3)
    assert cp.gather_frames(z, None) is z


def test_model_config_carries_spmd_axes_as_jax():
    """ModelConfig.spmd_axes defaults to None, as JAX's; build_model hands
    it to the video model."""
    assert ModelConfig().spmd_axes is None and JaxModelConfig().spmd_axes is None
    model = init_model(ModelConfig(**VIDEO, spmd_axes=("data", "time")), seed=0, device="cpu",
                       layers=(1, 1, 1, 1))
    assert model.spmd_axes == ("data", "time")
