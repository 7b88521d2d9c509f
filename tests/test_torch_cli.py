"""The port's training and eval CLIs against the JAX package's, on the CPU:
the argument plumbing (twins of tests/test_cli.py), the presets and the YAML
loader, and the end-to-end path: ``cli/train.main`` on LSP files written by
the test (full depth, 64x64, ``--device cpu``), a checkpoint an epoch, a
resume whose state equals the saved one bit for bit, ``cli/eval.main`` with
the trainer's mAP, the TSV log and parameter summary (twins of
tests/test_integration.py::test_trainer_end_to_end and
::test_trainer_logger_and_summary), and the first train loss on the first
disk batch against the JAX ``Trainer``'s."""

import dataclasses
import os
import random

import flax.linen
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
import scipy.io  # noqa: E402

from unipose_tpu.cli import train as jax_train  # noqa: E402
from unipose_tpu.core import config as jax_config  # noqa: E402
from unipose_tpu_torch.cli import eval as eval_cli  # noqa: E402
from unipose_tpu_torch.cli import train  # noqa: E402
from unipose_tpu_torch.core import config  # noqa: E402

SIZE = 64
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _assert_port_fields_equal(ours, theirs):
    """Every field of the port's dataclass equals the JAX one's, with the
    compute dtype mapped; the JAX fields the port lacks are the ones that
    wait for later slices."""
    names = [f.name for f in dataclasses.fields(ours)]
    assert set(names) <= {f.name for f in dataclasses.fields(theirs)}
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (DTYPES[a] if isinstance(a, torch.dtype) else a) == b, name


def _configs(argv):
    ours = train.configs_from_args(train.build_argparser().parse_args(argv))
    theirs = jax_train.configs_from_args(jax_train.build_argparser().parse_args(argv))
    return ours, theirs


ARGVS = {
    "image_defaults": ["--dataset", "LSP"],
    "video_defaults": ["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM"],
    "bf16": ["--dataset", "MPII", "--bf16"],
    "freeze_bn": ["--dataset", "LSP", "--freeze_bn"],
    "sigma_stride": ["--dataset", "LSP", "--sigma", "1.5", "--stride", "4"],
    "everything": ["--dataset", "NTID", "--epochs", "7", "--batch_size", "3", "--lr", "0.01",
                   "--seed", "4", "--warmup_steps", "9", "--model_name", "m",
                   "--head_positive_bias", "--frame_memory", "3"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_configs_from_args_match_jax(case):
    (mc, tc), (jmc, jtc) = _configs(ARGVS[case])
    _assert_port_fields_equal(mc, jmc)
    _assert_port_fields_equal(tc, jtc)


def test_image_defaults():
    (mc, tc), _ = _configs(["--dataset", "LSP"])
    assert mc.variant == "image" and mc.num_classes == 14
    assert tc.batch_size == 8 and tc.sigma == 3.0  # unipose.py:49,53


def test_video_defaults():
    (mc, tc), _ = _configs(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM"])
    assert mc.variant == "lstm" and mc.num_classes == 13
    assert tc.batch_size == 1 and tc.sigma == 1.0  # uniposeLSTM.py:51,55


def test_bf16_flag():
    (mc, _), _ = _configs(["--dataset", "MPII", "--bf16"])
    assert mc.compute_dtype == torch.bfloat16 and mc.num_classes == 16


def test_freeze_bn_flag():
    (mc, _), _ = _configs(["--dataset", "LSP", "--freeze_bn"])
    assert mc.freeze_bn is True


def test_sigma_stride_flags():
    (_, tc), _ = _configs(["--dataset", "LSP", "--sigma", "1.5", "--stride", "4"])
    assert tc.sigma == 1.5 and tc.stride == 4
    (_, tc), _ = _configs(["--dataset", "LSP"])
    assert tc.sigma == 3.0 and tc.stride is None
    (_, tc), _ = _configs(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM"])
    assert tc.sigma == 1.0


def test_yaml_config_flag(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("preset: penn_lstm\ntrain:\n  batch_size: 2\n")
    args = train.build_argparser().parse_args(["--config", str(cfg)])
    preset = config.load_yaml_config(args.config)
    assert preset.model.variant == "lstm" and preset.train.batch_size == 2
    theirs = jax_config.load_yaml_config(args.config)
    _assert_port_fields_equal(preset.model, theirs.model)
    _assert_port_fields_equal(preset.train, theirs.train)


def test_yaml_key_the_port_lacks_raises(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("train:\n  mesh_shape: [2]\n")
    with pytest.raises(TypeError):
        config.load_yaml_config(str(cfg))


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_match_jax(name):
    ours, theirs = config.get_preset(name), jax_config.get_preset(name)
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    assert (ours.name, ours.description) == (theirs.name, theirs.description)
    _assert_port_fields_equal(ours.model, theirs.model)
    _assert_port_fields_equal(ours.train, theirs.train)


def test_eval_missing_pretrained_fails_fast(tmp_path, monkeypatch):
    """Fails before any model is built, with the runbook's pointer."""
    from unipose_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Trainer, "__init__", lambda *a, **k: pytest.fail("built a Trainer"))
    with pytest.raises(SystemExit) as exc:
        eval_cli.main(["--dataset", "LSP", "--val_dir", str(tmp_path),
                       "--pretrained", str(tmp_path / "UniPose_LSP.tar")])
    msg = str(exc.value)
    assert "not found" in msg and "runbook" in msg


def test_what_waits_for_later_slices_says_so(tmp_path):
    with pytest.raises(SystemExit, match="Queue 1 item 6"):
        train.main(["--dataset", "Penn_Action", "--model_arch", "uniposeLSTM",
                    "--time_parallel", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="only the LSP and Penn Action loaders"):
        train.main(["--dataset", "MPII", "--input_size", "64", "--device", "cpu"])


def test_clis_need_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--dataset", "LSP", "--epochs", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--dataset", "LSP", "--val_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# End to end, on LSP files
# ---------------------------------------------------------------------------


def make_lsp_root(root, mode, n, seed):
    """An LSP (``mode="lsp"``) or LSPET root of ``n`` JPGs of varying size
    with their ``joints.mat``, as tests/test_integration.py writes them."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    hs, ws = rng.randint(60, 120, n), rng.randint(60, 120, n)
    for i in range(n):
        cv2.imwrite(os.path.join(root, "images", f"im{i + 1:05d}.jpg"),
                    rng.randint(0, 255, (hs[i], ws[i], 3), np.uint8))
    xs, ys = rng.uniform(3, ws - 3, (14, n)), rng.uniform(3, hs - 3, (14, n))
    vis = rng.randint(0, 2, (14, n))
    joints = np.stack([xs, ys, vis]) if mode == "lsp" else np.stack([xs, ys, vis], axis=1)
    scipy.io.savemat(os.path.join(root, "joints.mat"), {"joints": joints})
    return root


def _assert_states_equal(got, want):
    assert got["step"] == want["step"] and got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])
    assert sorted(got["model"]) == sorted(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    for k, v in want["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(got["optimizer"]["state"][k][name], t), (k, name)


def test_train_cli_end_to_end(tmp_path, capsys):
    """Two epochs of one step each (2 LSPET images, batch 2), a checkpoint
    an epoch, the best-mAP file; a second run over the same directory starts
    at step 2 with the saved state bit for bit and takes step 3; the eval
    CLI restores step 3 and gives the mAP the trainer validated; the TSV log
    has a row an epoch."""
    train_dir = make_lsp_root(str(tmp_path / "lspet"), "lspet", 2, 0)
    val_dir = make_lsp_root(str(tmp_path / "lsp"), "lsp", 3, 1)  # a ragged val batch of 8
    ckpt = str(tmp_path / "ckpt")
    argv = ["--dataset", "LSP", "--train_dir", train_dir, "--val_dir", val_dir,
            "--checkpoint_dir", ckpt, "--model_name", str(tmp_path / "unipose"),
            "--batch_size", "2", "--lr", "1e-3", "--input_size", str(SIZE), "--device", "cpu"]

    first = train.main(argv + ["--epochs", "2"])
    assert first.state.step == 2 and sorted(os.listdir(ckpt)) == ["1", "2"]
    assert first.spec.input_size == SIZE and first.device == torch.device("cpu")
    saved = torch.load(os.path.join(ckpt, "2"), weights_only=True)
    _assert_states_equal(saved, first.state.state_dict())

    args = train.build_argparser().parse_args(argv + ["--epochs", "1"])
    second = train.make_trainer(args)
    assert "resumed from step 2" in capsys.readouterr().out
    _assert_states_equal(second.state.state_dict(), saved)
    train.run(second, args)
    assert second.state.step == 3 and sorted(os.listdir(ckpt)) == ["1", "2", "3"]
    mAP = second.validation(1)

    got = eval_cli.main(["--dataset", "LSP", "--val_dir", val_dir, "--checkpoint_dir", ckpt,
                         "--input_size", str(SIZE), "--device", "cpu"])
    assert 0.0 <= got <= 1.0 and got == mAP


def test_trainer_logger_and_summary(tmp_path, capsys):
    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch.train.trainer import Trainer
    from unipose_tpu_torch.utils.logger import Logger

    train_dir = make_lsp_root(str(tmp_path / "lspet"), "lspet", 2, 2)
    val_dir = make_lsp_root(str(tmp_path / "lsp"), "lsp", 1, 3)
    log_path = str(tmp_path / "train_log.tsv")
    trainer = Trainer(
        ModelConfig(), TrainConfig(batch_size=2, lr=1e-3, model_name=str(tmp_path / "unipose")),
        train_dir, val_dir, spec=dataclasses.replace(DATASETS["LSP"], input_size=SIZE),
        log_file=log_path, print_summary=True, device="cpu",
    )
    out = capsys.readouterr().out
    assert "Total Parameters: 47,021,999" in out  # the JAX model's count
    trainer.training(0)
    trainer.validation(0)
    resumed = Logger(log_path, resume=True)
    assert resumed.names == ["epoch", "train_loss", "mAP", "mPCK", "mPCKh"]
    assert len(resumed.numbers["mAP"]) == 1
    resumed.close()


def test_first_disk_loss_matches_the_jax_trainer(tmp_path, monkeypatch, capsys):
    """Full depth, 64x64: the port's Trainer, reading LSPET files through its
    own loaders, and the JAX Trainer, reading them through the JAX readers,
    see the same first batch; with the JAX weights carried across
    (``state_dict_from_jax``) and dropout off on both sides (JAX keys
    cannot match a torch.Generator), their first train losses agree to
    1e-4 relative.  Their parameter summaries print the same counts."""
    from unipose_tpu.data import transforms as JT
    from unipose_tpu.data.loader import PrefetchLoader
    from unipose_tpu.data.lsp import LSPDataset as JaxLSPDataset
    from unipose_tpu.data.native_loader import native_lsp_train_loader
    from unipose_tpu.train.trainer import Trainer as JaxTrainer
    from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch import native
    from unipose_tpu_torch.models.layers import Dropout
    from unipose_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
    train_dir = make_lsp_root(str(tmp_path / "lspet"), "lspet", 4, 4)
    spec = dataclasses.replace(DATASETS["LSP"], input_size=SIZE)
    ours = Trainer(ModelConfig(), TrainConfig(batch_size=2, model_name="", seed=3), train_dir,
                   spec=spec, print_summary=True, device="cpu")
    jspec = dataclasses.replace(jax_config.DATASETS["LSP"], input_size=SIZE)
    if native.available():  # the route the port's factory took
        jloader = native_lsp_train_loader(
            JaxLSPDataset("lspet", train_dir, 3.0, 8, None, input_size=SIZE), 2, seed=3)
    else:
        jloader = PrefetchLoader(
            JaxLSPDataset("lspet", train_dir, 3.0, 8, JT.Compose([JT.RandomHorizontalFlip()]),
                          input_size=SIZE),
            2, shuffle=True, num_workers=1, seed=3)
    out = capsys.readouterr().out
    theirs = JaxTrainer(jax_config.ModelConfig(), jax_config.TrainConfig(batch_size=2, seed=3),
                        spec=jspec, loaders=(jloader, None), print_summary=True)
    jout = capsys.readouterr().out
    summary = lambda s: s[s.index("Total Parameters"):].splitlines()[:4]  # noqa: E731
    assert summary(out) == summary(jout)

    random.seed(0)
    batch = next(iter(ours.train_loader))
    random.seed(0)
    jbatch = next(iter(jloader))
    for k in ("image", "kpts"):
        assert batch[k].tobytes() == jbatch[k].tobytes()

    variables = {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}
    ours.model.load_state_dict(state_dict_from_jax(variables))
    for m in ours.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    loss = ours.train_step(ours.state, ours._device_batch(batch))["loss"].item()
    _, jmetrics = theirs.train_step(theirs.state, theirs._device_batch(jbatch))
    np.testing.assert_allclose(loss, float(jmetrics["loss"]), rtol=1e-4)
