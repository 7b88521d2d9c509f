"""The port's demo against the JAX package's, on the CPU: ``Trainer.test``
(image, and video as a one-frame rollout with a zero centermap), the
drawing helpers of ``viz/draw.py`` on the same heatmaps, and
``cli/demo.py``.

Twins of tests/test_integration.py::test_trainer_test_demo and
tests/test_integration_video.py::test_trainer_test_demo_video: both
Trainers at reduced depth (1, 1, 1, 1) and 64x64 hold the same weights
(the JAX variables, BN perturbed, through ``state_dict_from_jax``); their
keypoints are equal, and so are the skeleton's pixels.  Their heatmaps
agree to f32 rounding, not bit for bit, and an overlay's colour index is
``uint8(255 * heat)``, a truncation that wraps past 255: where a value lies
within rounding of a level the index moves by one, or from 255 to 0, and
the JET colour with it.  So the overlays are held to differ in at most
1e-2 of their values (measured: 1.0e-3 at most, in the image variant's
channel 9; the heatmaps, upsampled from 8x8, cross many levels); a wrong
channel, layout or resize changes most of them.  The drawing helpers on the same heatmaps are
held bit for bit.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from torch_parity import perturb_bn, reduced_lstm_depth, two_threads  # noqa: F401
from unipose_tpu.core import config as jax_config
from unipose_tpu.models import unipose as jax_unipose
from unipose_tpu.models.resnet import ResNet101 as JaxResNet101
from unipose_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from unipose_tpu.train.trainer import Trainer as JaxTrainer
from unipose_tpu.viz import draw as jax_draw
from unipose_tpu_torch.cli import demo
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.models.unipose import init_model
from unipose_tpu_torch.ops.resize import bilinear_resize
from unipose_tpu_torch.train import state as train_state
from unipose_tpu_torch.train.trainer import Trainer
from unipose_tpu_torch.viz import draw

REDUCED = (1, 1, 1, 1)
SIZE = 64
pytestmark = pytest.mark.usefixtures("two_threads")
VARIANTS = {
    "image": dict(dataset="LSP", num_classes=14),
    "video": dict(dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=1),
}


def write_image(path, seed=0, shape=(90, 70, 3)):
    cv2.imwrite(path, np.random.RandomState(seed).randint(0, 255, shape, np.uint8))
    return path


def pngs(directory):
    """{file name: pixels} of every PNG under ``directory``."""
    out = {}
    for base, _, files in os.walk(directory):
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, directory)] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_trainer_test_matches_jax(tmp_path, monkeypatch, variant):
    monkeypatch.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))
    monkeypatch.setattr(jax_unipose, "ResNet101", functools.partial(JaxResNet101, layers=REDUCED))
    fields = VARIANTS[variant]
    spec = dataclasses.replace(DATASETS[fields["dataset"]], input_size=SIZE)
    jspec = dataclasses.replace(jax_config.DATASETS[fields["dataset"]], input_size=SIZE)
    image = write_image(str(tmp_path / "person.jpg"))
    ours = Trainer(ModelConfig(**fields), TrainConfig(batch_size=1), spec=spec,
                   loaders=(None, None), device="cpu")
    with reduced_lstm_depth(REDUCED):
        theirs = JaxTrainer(jax_config.ModelConfig(**fields), jax_config.TrainConfig(batch_size=1),
                            spec=jspec, loaders=(None, None))
        variables = perturb_bn({"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}, 2)
        theirs.state = theirs.state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
        ours.model.load_state_dict(state_dict_from_jax(variables, variant=fields.get("variant", "image")))
        jkpts = theirs.test(image, out_dir=str(tmp_path / "jax"))
    kpts = ours.test(image, out_dir=str(tmp_path / "port"))

    assert len(kpts) == fields["num_classes"] and kpts == jkpts
    assert ours.model.training  # test() leaves the mode it found
    got, want = pngs(str(tmp_path / "port")), pngs(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and len(got) == 1 + fields["num_classes"] + 1
    np.testing.assert_array_equal(got.pop("pose.png"), want.pop("pose.png"))
    for name, pixels in want.items():  # the overlays (see the module's docstring)
        assert got[name].shape == pixels.shape and (got[name] != pixels).mean() <= 1e-2, name


def _heatmaps(seed, k=14, h=46):
    return np.random.RandomState(seed).rand(1, h, h, k + 1).astype(np.float32)


def test_get_kpts_and_draw_paint_match_jax():
    """The same keypoints from either layout; the same skeleton pixels for
    every dataset with a limb sequence, and none for one without."""
    img = np.random.RandomState(1).randint(0, 255, (368, 368, 3), np.uint8)
    assert draw.LIMB_SEQ == jax_draw.LIMB_SEQ and draw.COLORS == jax_draw.COLORS
    for dataset, k in (("LSP", 14), ("MPII", 16), ("Penn_Action", 13), ("BBC", 7), ("NTID", 19)):
        heat = _heatmaps(k, k)
        kpts = draw.get_kpts(heat)
        assert kpts == jax_draw.get_kpts(heat) == draw.get_kpts(np.moveaxis(heat, -1, 1))
        assert len(kpts) == k
        np.testing.assert_array_equal(draw.draw_paint(img, kpts, dataset),
                                      jax_draw.draw_paint(img, kpts, dataset))


def test_heatmap_overlays_match_jax(tmp_path):
    """Heatmaps at 368 (as ``Trainer.test`` hands them over, upsampled on
    the model's device) give the same overlay pixels; at 46 the two
    packages' align-corners resizes (the same interpolation, weights
    computed by two formulas) agree to 1e-5 on values in [0, 1) (measured
    1.6e-6)."""
    image = write_image(str(tmp_path / "person.jpg"), seed=3)
    small = _heatmaps(4)
    up = bilinear_resize(torch.from_numpy(small).permute(0, 3, 1, 2), (368, 368)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(up, np.asarray(jax_bilinear_resize(small, (368, 368))), rtol=0, atol=1e-5)
    got = draw.heatmap_overlays(up, image, out_dir=str(tmp_path / "heat"))
    want = jax_draw.heatmap_overlays(up, image)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(os.listdir(tmp_path / "heat")) == sorted(f"unipose{c}.png" for c in range(15))


def test_demo_cli_on_cpu(tmp_path, capsys):
    """``cli/demo.main --device cpu``: the 368x368 image model (seed-0
    weights), a skeleton and 15 overlays written, 14 keypoints in the
    image, the same as the model's own heatmaps give."""
    image = write_image(str(tmp_path / "person.jpg"), seed=5, shape=(200, 150, 3))
    out = str(tmp_path / "samples")
    kpts = demo.main([image, "--dataset", "LSP", "--out_dir", out, "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "pose.png"))
    assert len(os.listdir(os.path.join(out, "heat"))) == 15
    assert len(kpts) == 14 and all(0 <= v < 368 for kp in kpts for v in kp)
    with pytest.MonkeyPatch.context() as mp, pytest.raises(RuntimeError, match="no CUDA device"):
        mp.setattr(torch.cuda, "is_available", lambda: False)
        demo.main([image, "--out_dir", out])


@pytest.mark.slow
def test_demo_cli_matches_jax(tmp_path, capsys):
    """Full depth at 368x368 (hence ``slow``): both demo CLIs warm-started
    from one reference-format checkpoint, written from JAX variables, print
    the same keypoints and write the same skeleton."""
    import jax

    from unipose_tpu.cli import demo as jax_demo
    from unipose_tpu.compat.torch_export import export_state_dict

    model = jax_unipose.UniPose(num_classes=14)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(6), np.zeros((1, 64, 64, 3), np.float32))
    variables = perturb_bn(variables, 7)
    path = str(tmp_path / "UniPose_LSP.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in export_state_dict(variables).items()}}, path)
    image = write_image(str(tmp_path / "person.jpg"), seed=8, shape=(200, 150, 3))
    kpts = demo.main([image, "--pretrained", path, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    capsys.readouterr()
    jax_demo.main([image, "--pretrained", path, "--out_dir", str(tmp_path / "jax")])
    assert f"keypoints: {kpts}" in capsys.readouterr().out
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "pose.png")),
                                  cv2.imread(str(tmp_path / "jax" / "pose.png")))
