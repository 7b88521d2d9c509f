"""``cli/train.py`` under ``torch.distributed.run`` on the CPU: two gloo
ranks (``--device cpu``) train UniPose from LSP files written by the test
(reduced depth through tests/torch_ddp_worker.py's ``cli`` mode, 64x64,
global batch 4), each rank's loaders decoding only its rows; every rank
validates its rows of the 5 validation images (one global batch of 8,
padded: rank 1's rows hold one image and three padding rows) and rank 0
scores the gathered coordinates; rank 0 alone writes the checkpoint and
logs, a second launch resumes from it on both ranks, and the checkpoint
loads into one process key for key, where ``cli/eval.py`` gives the
ranks' mAP."""

import json
import os

import pytest
import torch

pytest.importorskip("cv2")

from test_torch_cli import _assert_states_equal, make_lsp_root  # noqa: E402
from torch_parity import WORKER, run_torchrun  # noqa: E402

SIZE = 64
REDUCED = (1, 1, 1, 1)


def _summary(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("train summary ")]
    assert len(lines) == 1, out  # rank 0 alone prints it
    return json.loads(lines[0][len("train summary "):])


def _fingerprints(out: str) -> set:
    return {ln.split()[2] for ln in out.splitlines() if ln.startswith("FINGERPRINT ")}


@pytest.fixture
def reduced_depth(monkeypatch):
    import functools

    from unipose_tpu_torch.models.unipose import init_model
    from unipose_tpu_torch.train import state as train_state

    monkeypatch.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))


def test_two_rank_cli_checkpoints_resumes_and_matches_one_process(tmp_path, reduced_depth):
    from unipose_tpu_torch.cli import eval as eval_cli
    from unipose_tpu_torch.cli import train

    train_dir = make_lsp_root(str(tmp_path / "lspet"), "lspet", 8, seed=1)
    val_dir = make_lsp_root(str(tmp_path / "lsp"), "lsp", 5, seed=2)
    ckpt = tmp_path / "ckpt"
    argv = ["--dataset", "LSP", "--train_dir", train_dir, "--val_dir", val_dir, "--batch_size", "4",
            "--input_size", str(SIZE), "--checkpoint_dir", str(ckpt), "--model_name", "",
            "--epochs", "1", "--device", "cpu"]
    launch = [WORKER, "cli", "--layers", ",".join(map(str, REDUCED)), "--"] + argv

    out = run_torchrun(launch, tmp_path, nproc=2, tag="first")
    first = _summary(out)
    assert first["step"] == 2 and out.count("Epoch 0:") == 1  # 8 images at batch 4; rank 0 logs
    assert len(_fingerprints(out)) == 1  # both ranks: the same parameters and buffers, bit for bit
    assert sorted(os.listdir(ckpt)) == ["2"]  # one file, committed, written once
    saved = torch.load(ckpt / "2", map_location="cpu", weights_only=True)
    assert not [k for k in saved["model"] if k.startswith("module.")]

    # one process restores the two ranks' checkpoint key for key (strict)
    one = train.make_trainer(train.build_argparser().parse_args(argv))
    assert one.mesh.world == 1 and one.state.step == 2
    _assert_states_equal(one.state.state_dict(), saved)
    del one

    out = run_torchrun(launch, tmp_path, nproc=2, tag="resume")
    second = _summary(out)
    assert out.count("resumed from step 2") == 1 and second["step"] == 4
    assert len(_fingerprints(out)) == 1
    assert sorted(os.listdir(ckpt), key=int) == ["2", "4"]

    # the ranks validated their rows, rank 0 scored them as one process does
    mAP = eval_cli.main(["--dataset", "LSP", "--val_dir", val_dir, "--checkpoint_dir", str(ckpt),
                         "--input_size", str(SIZE), "--device", "cpu"])
    assert mAP == second["mAP"] and 0.0 <= mAP <= 1.0
