"""A reduced twin of tests/test_integration_video.py::
test_video_cli_e2e_disk_path, on the CPU: the port's ``cli/train.main
--model_arch uniposeLSTM`` and ``cli/eval.main`` with ``--device cpu`` on a
Penn Action root on disk (tests/test_torch_video_trainer.py writes it), a
checkpoint an epoch, a resume bit-identical to the saved step, the eval
CLI's mAP equal to the trainer's.
"""

import os

import pytest
import torch

from test_torch_cli import _assert_states_equal
from test_torch_video_trainer import SIZE, T
from torch_parity import two_threads  # noqa: F401
from unipose_tpu_torch.cli import eval as eval_cli
from unipose_tpu_torch.cli import train
from unipose_tpu_torch.data.fixtures import write_penn_root

pytestmark = pytest.mark.usefixtures("two_threads")


def test_video_cli_end_to_end(tmp_path, capsys):
    """Full depth at 64x64: two epochs of two 2-frame clips (clip batch 1),
    a checkpoint an epoch; a second run resumes from step 4 with the saved
    state bit for bit and takes two more; the eval CLI restores step 6 and
    gives the mAP the trainer validated."""
    root = write_penn_root(str(tmp_path / "penn"), "train", n_clips=2, n_frames=4, seed=2)
    write_penn_root(root, "val", n_clips=1, n_frames=4, seed=3, first=3)
    ckpt = str(tmp_path / "ckpt")
    argv = ["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM", "--frame_memory", str(T),
            "--train_dir", root, "--val_dir", root, "--checkpoint_dir", ckpt,
            "--model_name", str(tmp_path / "uniposeLSTM"), "--lr", "1e-3",
            "--input_size", str(SIZE), "--device", "cpu"]
    first = train.main(argv + ["--epochs", "2"])
    assert first.video and first.train_config.batch_size == 1 and first.spec.sigma == 1.0
    assert first.state.step == 4 and sorted(os.listdir(ckpt)) == ["2", "4"]
    saved = torch.load(os.path.join(ckpt, "4"), weights_only=True)
    _assert_states_equal(saved, first.state.state_dict())

    args = train.build_argparser().parse_args(argv + ["--epochs", "1"])
    second = train.make_trainer(args)
    assert "resumed from step 4" in capsys.readouterr().out
    _assert_states_equal(second.state.state_dict(), saved)
    train.run(second, args)
    assert second.state.step == 6
    mAP = second.validation(1)

    got = eval_cli.main(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM",
                         "--frame_memory", str(T), "--val_dir", root, "--checkpoint_dir", ckpt,
                         "--input_size", str(SIZE), "--device", "cpu"])
    assert 0.0 <= got <= 1.0 and got == mAP
