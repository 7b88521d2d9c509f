"""Time-parallel UniPose-LSTM (``parallel/cp.py``, ``ModelConfig.spmd_axes``)
across gloo ranks on the CPU, against the JAX package and against one
process of the port.  Three rank launches (tests/torch_ddp_worker.py,
child processes: nothing in this process joins a process group):

1. ``step`` under mesh (1, 2), two ranks, one clip: the eval forward.
2. ``step`` under mesh (2, 2), four ranks, two clips, four modes: the eval
   forward and its chunked pair; an f32 step, dropout off; an f64 step,
   dropout on; the same f64 step with ``remat_tower`` and ``remat_scan``.
3. ``cli/train.py --model_arch uniposeLSTM --time_parallel 2`` over four
   ranks under ``torch.distributed.run`` on Penn Action files: each data
   index's loader decodes its clips, and every rank validates its (clip,
   frame) block of the padded validation batch under the mesh.

Reduced depth (1, 1, 1, 1), 32x32, T = 4 (2 frames a rank), K = 13; the
weights are JAX's (seed SEED, BN statistics randomised, carried across by
``state_dict_from_jax``), the clips tests/test_torch_video_train.py's
picture-like frames (seed 11).  Tolerances, each checked below: the eval
heatmaps put together from the ranks against JAX's unsharded forward,
max-norm relative 1e-4 (the parity bar); the f32 step's loss against JAX's
time-parallel step (``make_video_mesh(2, 2)``, ``under_mesh``,
``shard_clip_batch``) 1e-4 relative, dropout off on both sides (JAX's keys
and the port's generator draw different masks); the f64 step's gradients
(the ranks' average, before Adam) against one process of the port 1e-8 a
tensor, its BN statistics 1e-12, the ranks bit-equal after the step; remat
against no remat 1e-8 a tensor, the statistics updated once.

Conditioning (tests/torch_conditioning.py --video --size 32 --batch 2
--frames 4): see SEED.  The f64 leg holds the gradients: the ConvLSTM's
gates and carry run in f64 in an f64 network, and there the ranks lie
~1e-13 from one process (with the gates in f32 they lay ~1e-7 apart, the
reassociated f32 rounding of the scan's backward).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train import _jax_state  # noqa: E402
from test_torch_video_train import (  # noqa: E402,F401
    REDUCED, _reduced_jax_depth, clip_batch, jax_variables, specs,
)
from torch_parity import WORKER, max_rel_err, run_ranks, run_torchrun, two_threads_for_the_module  # noqa: E402,F401
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM  # noqa: E402
from unipose_tpu.parallel.cp import make_video_mesh, shard_clip_batch, under_mesh  # noqa: E402
from unipose_tpu.parallel.mesh import replicate  # noqa: E402
from unipose_tpu.train import steps as jax_steps  # noqa: E402
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax  # noqa: E402

SIZE = 32
T = 4
# Weights seed, tests/test_torch_video_train.py's held case, here at T = 4.
# Read with tests/torch_conditioning.py --video --size 32 --batch 2
# --frames 4 --seeds 13 (one process, dropout off): the port's and JAX's
# f32 gradients lie 8.8e-5 apart, every BN statistic within 1e-5, but both
# lie 0.063 from the f64 twin in conv1.weight (a ReLU input near zero that
# rounding flips), so no f32 gradient is held here: the f32 leg holds the
# loss (the ranks read JAX's time-parallel loss exactly) and the eval
# heatmaps (7.9e-8 and 1.6e-7 from JAX's); the f64 leg holds the gradients
# (6.6e-14 from one process, statistics 9.4e-15; remat 0.0 from plain).
SEED = 13
CLIPS = 11  # clip_batch's seed
GRID = (2, 2)  # launch 2's (data, time) mesh
GRAD_TOL = 1e-8  # f64 gradients, max-norm relative a tensor
STAT_TOL = 1e-12  # f64 BN statistics, max-norm relative
LOSS_TOL = 1e-4  # f32 loss against JAX's time-parallel step, relative
PARITY = 1e-4  # f32 eval heatmaps against JAX, max-norm relative
GRID_MODES = [
    {"name": "eval", "kind": "eval"},
    {"name": "f32", "kind": "step", "dtype": "float32", "dropout": False, "grads": False},
    {"name": "f64", "kind": "step", "dtype": "float64", "dropout": True},
    {"name": "f64_remat", "kind": "step", "dtype": "float64", "dropout": True, "remat": True},
]


def _jax_forward(variables, batch, jspec):
    """JAX's unsharded eval forward (tests/test_cp.py:98-106), NHWC."""
    model = JaxUniPoseLSTM(num_classes=13)
    x = jax_steps.preprocess_images(jnp.asarray(batch["frames"]))
    cm = jax_steps.make_centermaps(jnp.asarray(batch["centers"]), jspec)
    return np.asarray(jax.jit(lambda v, x, cm: model.apply(v, x, cm, train=False))(variables, x, cm))


def _launch(tmp_path, mesh, b, modes):
    """The ranks of ``mesh`` on b clips of T frames: (the JAX variables,
    the batch, each rank's results, the weights' .npz)."""
    _, variables = jax_variables(SEED)
    batch = clip_batch(CLIPS, b, T, SIZE)
    np.savez(tmp_path / "weights.npz",
             **{k: v.numpy() for k, v in state_dict_from_jax(variables, variant="lstm").items()})
    np.savez(tmp_path / "batch.npz", **batch)
    # rank 0 alone writes its gradients (DDP's average, every rank's; the
    # ranks' fingerprints show them equal): ~200 MB a mode in f64
    run = {"batch": str(tmp_path / "batch.npz"), "weights": str(tmp_path / "weights.npz"),
           "variant": "lstm", "layers": list(REDUCED), "size": SIZE, "mesh": list(mesh),
           "modes": modes, "device": "cpu", "tensor_ranks": [0]}
    ranks = run_ranks("step", run, tmp_path, world=mesh[0] * mesh[1])
    for path in tmp_path.glob("step.rank*.pt"):  # read: the disk need not keep them
        path.unlink()
    return variables, batch, ranks, run["weights"]


def _stitch(blocks, mesh):
    """Each rank's (b_loc, t_loc, ...) block put back at its (clip, frame)
    place: rank r at (r // n_time, r % n_time)."""
    n_data, n_time = mesh
    rows = [np.concatenate([blocks[d * n_time + j] for j in range(n_time)], axis=1) for d in range(n_data)]
    return np.concatenate(rows, axis=0)


def _assert_eval_matches_jax(ranks, mesh, variables, batch):
    _, jspec = specs(SIZE)
    want = _jax_forward(variables, batch, jspec)
    got = _stitch([r["eval"]["heat"].numpy() for r in ranks], mesh)
    assert got.shape == want.shape == (batch["frames"].shape[0], T, SIZE // 8, SIZE // 8, 14)
    assert max_rel_err(got, want) < PARITY
    # the clip in two halves, the ConvLSTM state carried across them
    chunks = [_stitch([r["eval"]["chunks"][c].numpy() for r in ranks], mesh) for c in (0, 1)]
    assert max_rel_err(np.concatenate(chunks, axis=1), want) < PARITY


def test_eval_forward_over_two_time_ranks_matches_jax(tmp_path):
    """Launch 1: one clip's 4 frames over a time axis of 2 ranks."""
    variables, batch, ranks, _ = _launch(tmp_path, (1, 2), 1, [{"name": "eval", "kind": "eval"}])
    _assert_eval_matches_jax(ranks, (1, 2), variables, batch)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Launch 2: two clips over the (2, 2) mesh, every mode."""
    return _launch(tmp_path_factory.mktemp("grid"), GRID, 2, GRID_MODES)


def test_eval_forward_over_the_grid_matches_jax(grid):
    variables, batch, ranks, _ = grid
    _assert_eval_matches_jax(ranks, GRID, variables, batch)


def test_f32_step_loss_matches_the_jax_time_parallel_step(grid, monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
    variables, batch, ranks, _ = grid
    _, jspec = specs(SIZE)
    model = JaxUniPoseLSTM(num_classes=13, spmd_axes=("data", "time"))
    mesh = make_video_mesh(*GRID, devices=jax.devices()[:4])
    tx, state = _jax_state(variables)
    step = under_mesh(mesh, jax_steps.make_train_step(model, tx, jspec, video=True, donate=False))
    _, metrics = step(replicate(state, mesh), shard_clip_batch(batch, mesh))
    losses = {r["f32"]["loss"] for r in ranks}
    assert len(losses) == 1  # every rank reports the global batch's loss
    np.testing.assert_allclose(losses.pop(), float(metrics["loss"]), rtol=LOSS_TOL)


def _one_process_f64_step(batch, weights, monkeypatch):
    """The port's one-process f64 step (dropout on, the ranks' seed and
    generator) through the worker's own Trainer builder."""
    import torch_ddp_worker
    from unipose_tpu_torch.train import state as train_state

    monkeypatch.setattr(train_state, "init_model", train_state.init_model)  # restored after
    spec = {"variant": "lstm", "layers": list(REDUCED), "size": SIZE, "weights": weights}
    trainer = torch_ddp_worker._trainer(spec, batch, True, torch.float64, torch.device("cpu"))
    loss = trainer.training(0)
    model = trainer.model
    return (loss, {n: p.grad for n, p in model.named_parameters()},
            {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))})


def test_f64_step_matches_one_process(grid, monkeypatch):
    """Gradients, statistics and loss of the f64 step against one process;
    the ranks bit-equal; a step a rank: one heatmap_mse each way and one
    gather of the features."""
    _, batch, ranks, weights = grid
    loss, grads, stats = _one_process_f64_step(batch, weights, monkeypatch)
    got = [r["f64"] for r in ranks]
    assert len({g["fingerprint"] for g in got}) == 1
    assert all(g["launches"]["heatmap_mse"] == 0 for g in got)  # the CPU runs the plain version
    assert [g["gathers"] for g in got] == [1] * len(got)
    # the loss stays f32 (heatmap_mse), the mean of the ranks' f32 losses
    np.testing.assert_allclose(got[0]["loss"], loss, rtol=1e-6)
    assert sorted(got[0]["grads"]) == sorted(grads)
    for name, g in grads.items():
        assert max_rel_err(got[0]["grads"][name].numpy(), g.numpy()) < GRAD_TOL, name
    for name, v in stats.items():
        assert max_rel_err(got[0]["stats"][name].numpy(), v.numpy()) < STAT_TOL, name


def test_remat_step_matches_the_plain_step(grid):
    """remat_tower and remat_scan across ranks: the same gradients, and the
    BN statistics updated once."""
    _, _, ranks, _ = grid
    plain, remat = ranks[0]["f64"], ranks[0]["f64_remat"]
    for name, g in plain["grads"].items():
        assert max_rel_err(remat["grads"][name].numpy(), g.numpy()) < GRAD_TOL, name
    for r in ranks:
        plain, remat = r["f64"], r["f64_remat"]
        for name, v in remat["stats"].items():
            if name.endswith("num_batches_tracked"):
                assert int(v) == 1, name
            else:
                assert max_rel_err(v.numpy(), plain["stats"][name].numpy()) < STAT_TOL, name
    assert len({r["f64_remat"]["fingerprint"] for r in ranks}) == 1


def _summary(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("train summary ")]
    assert len(lines) == 1, out  # rank 0 alone prints it
    return json.loads(lines[0][len("train summary "):])


def test_cli_trains_on_a_data_by_time_grid(tmp_path):
    """Launch 3: four CPU ranks, --time_parallel 2 (a (2, 2) mesh), two
    epochs of two steps (4 clips of 4 frames, clip batch 2, a data index
    loading its clip of each); every rank validates its block of the one
    validation clip padded to 8 clips (data index 1 holds padding only),
    under the mesh; rank 0 writes a checkpoint an epoch; every rank ends
    with the same parameters and buffers; the loss is finite."""
    from unipose_tpu_torch.data.fixtures import write_penn_root

    root = write_penn_root(str(tmp_path / "penn"), "train", n_clips=4, n_frames=T, seed=2)
    write_penn_root(root, "val", n_clips=1, n_frames=T, seed=3, first=5)
    ckpt = tmp_path / "ckpt"
    argv = ["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM", "--time_parallel", "2",
            "--frame_memory", str(T), "--batch_size", "2", "--train_dir", root, "--val_dir", root,
            "--checkpoint_dir", str(ckpt), "--model_name", "", "--epochs", "2",
            "--input_size", str(SIZE), "--device", "cpu"]
    out = run_torchrun([WORKER, "cli", "--layers", ",".join(map(str, REDUCED)), "--"] + argv,
                       tmp_path, nproc=4, tag="cp_cli")
    summary = _summary(out)
    assert summary["step"] == 4 and np.isfinite(summary["loss"]) and 0.0 <= summary["mAP"] <= 1.0
    assert out.count("Epoch 0:") == 1 and out.count("Epoch 1:") == 1  # rank 0 logs
    assert sorted(os.listdir(ckpt), key=int) == ["2", "4"]
    prints = [ln.split() for ln in out.splitlines() if ln.startswith("FINGERPRINT ")]
    assert sorted(int(p[1]) for p in prints) == [0, 1, 2, 3] and len({p[2] for p in prints}) == 1
    shutil.rmtree(ckpt)  # ~300 MB a checkpoint (Adam's moments), checked: the disk need not keep them
