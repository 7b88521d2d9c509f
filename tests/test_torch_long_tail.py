"""The port's long tail against the JAX package on the same seeded inputs:
``eval/refinement.py``, ``ops/limbs.py``, ``viz/draw.py::draw_bbox``,
``utils/profiling.py::StepTimer``, ``utils/summary.py`` (the parameter
lines, and the FLOP count through the kernel ops' formulas), the parts of
``cli/parity_run.py`` that need no reference checkout, and the slice as a
whole: the box-head UniPose at reduced depth, its maps against JAX's at
1e-4, and the people that ``multi_person_kpts`` decodes from them.
Integer and boolean results are exactly equal, floats within 1e-6."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import ComposedUniPose, jax_variables, max_rel_err, two_threads_for_the_module  # noqa: F401
from unipose_tpu.cli import parity_run as jax_parity
from unipose_tpu.eval import refinement as jax_ref
from unipose_tpu.ops import limbs as jax_limbs
from unipose_tpu.postproc import multi_person as jax_mp
from unipose_tpu.utils import profiling as jax_profiling
from unipose_tpu.utils.summary import model_summary as jax_model_summary
from unipose_tpu_torch.cli import parity_run
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.eval import refinement
from unipose_tpu_torch.models.unipose import UniPose, random_state_dict
from unipose_tpu_torch.ops import limbs
from unipose_tpu_torch.ops.kernels import conv_i8 as ci
from unipose_tpu_torch.ops.kernels import fused_stem as fs
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc
from unipose_tpu_torch.postproc import multi_person as mp
from unipose_tpu_torch.utils import profiling
from unipose_tpu_torch.utils.summary import compiled_flops, eval_minus_train_flops, model_summary

REDUCED = (1, 1, 1, 1)
FLOAT_TOL = 1e-6
# where the JAX harness looks for the reference checkout by default
REFERENCE = jax_parity.build_argparser().get_default("reference")


# ---------------------------------------------------------------- refinement


def _score_maps(seed):
    maps = np.random.RandomState(seed).randn(2, 16, 12, 10).astype(np.float32)
    maps[1, 3] = -np.abs(maps[1, 3])  # a map with no positive maximum
    return maps


def test_get_preds_against_jax():
    for seed in (0, 1):
        got = refinement.get_preds(_score_maps(seed))
        np.testing.assert_array_equal(got, jax_ref.get_preds(_score_maps(seed)))
    assert (got[1, 3] == 0).all()


@pytest.mark.parametrize("rot", [0.0, 30.0, -12.5])
def test_transforms_against_jax(rot):
    center, scale, res = [100.0, 120.0], 1.5, (64, 48)
    np.testing.assert_allclose(
        refinement.get_transform(center, scale, res, rot), jax_ref.get_transform(center, scale, res, rot),
        rtol=0, atol=FLOAT_TOL,
    )
    for pt in ([10, 20], [1, 1], [63.7, 2.2]):
        for invert in (False, True):
            np.testing.assert_array_equal(
                refinement.transform_point(pt, center, scale, res, invert, rot),
                jax_ref.transform_point(pt, center, scale, res, invert, rot),
            )
    coords = np.random.RandomState(2).uniform(1, 40, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        refinement.transform_preds(coords, center, scale, res),
        jax_ref.transform_preds(coords, center, scale, res), rtol=0, atol=FLOAT_TOL,
    )


def test_final_preds_against_jax():
    maps = _score_maps(3)
    maps[0, 0] = 0
    maps[0, 0, 6, 5], maps[0, 0, 6, 6], maps[0, 0, 7, 5] = 1.0, 0.6, 0.2  # steps +x, +y
    center = np.array([[60.0, 50.0], [30.0, 70.0]])
    scale = np.array([0.4, 0.8])
    got = refinement.final_preds(maps, center, scale, (10, 12))
    np.testing.assert_allclose(got, jax_ref.final_preds(maps, center, scale, (10, 12)), rtol=0, atol=FLOAT_TOL)


def test_flips_against_jax():
    maps = _score_maps(4)
    np.testing.assert_array_equal(refinement.fliplr(maps), jax_ref.fliplr(maps))
    np.testing.assert_array_equal(refinement.flip_back(maps), jax_ref.flip_back(maps))
    coords = np.random.RandomState(5).uniform(0, 60, (16, 2)).astype(np.float32)
    np.testing.assert_array_equal(refinement.shufflelr(coords, 64), jax_ref.shufflelr(coords, 64))
    assert refinement.MPII_MATCHED_PARTS == jax_ref.MPII_MATCHED_PARTS
    for fn, args in ((refinement.flip_back, (maps,)), (refinement.shufflelr, (coords, 64))):
        with pytest.raises(ValueError, match="Not supported"):
            fn(*args, dataset="lsp")


# --------------------------------------------------------------------- limbs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_limb_maps_against_jax(seed):
    """368x368 at stride 8, seeded keypoints; seed 3 puts some outside the
    frame and two on the same heatmap pixel (a limb of length 0)."""
    kpts = np.random.RandomState(seed).uniform(20, 350, (14, 3)).astype(np.float32)
    if seed == 3:
        kpts[0, :2] = [-30, 500]
        kpts[10, :2] = kpts[11, :2] + 1
    got = limbs.limb_maps(kpts, 368, 368, 8)
    want = jax_limbs.limb_maps(kpts, 368, 368, 8)
    assert got.shape == want.shape == (46, 46, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    assert (got > 0).sum() > 0
    assert limbs.LSP_BODY_PARTS == jax_limbs.LSP_BODY_PARTS


# ----------------------------------------------------------------- draw_bbox


@pytest.mark.parametrize("with_heatmaps", [False, True])
def test_draw_bbox_against_jax(tmp_path, with_heatmaps):
    pytest.importorskip("cv2")
    from unipose_tpu.viz.draw import draw_bbox as jax_draw_bbox
    from unipose_tpu_torch.viz.draw import draw_bbox

    rng = np.random.RandomState(6)
    img = (rng.rand(368, 368, 3) * 255).astype(np.uint8)
    heat = None
    if with_heatmaps:
        heat = np.zeros((1, 46, 46, 15), np.float32)
        for k in range(1, 15):
            heat[0, (k * 3 + 5) % 46, (k * 7 + 2) % 46, k] = 1.0
    box = np.array([180.4, 170.6, 120.2, 250.8])
    out = str(tmp_path / "box.png")
    got = draw_bbox(box, img.copy(), heat, "LSP", out_path=out)
    want = jax_draw_bbox(box, img.copy(), heat, "LSP")
    assert got.dtype == np.uint8 and got.shape == (368, 368, 3)
    np.testing.assert_array_equal(got, want)
    assert os.path.exists(out) and (got != img).any()


# ----------------------------------------------------------------- StepTimer


class _Clock:
    """A perf_counter that moves by the next of ``steps`` seconds a call
    pair (enter, exit)."""

    def __init__(self, steps):
        self.t, self.steps, self.calls = 0.0, list(steps), 0

    def perf_counter(self):
        if self.calls % 2:
            self.t += self.steps[self.calls // 2]
        self.calls += 1
        return self.t


@pytest.mark.parametrize("skip,steps", [(2, [9.0, 5.0, 1.0, 2.0, 4.0]), (0, [1.5, 2.5]), (3, [1.0, 1.0])])
def test_step_timer_against_jax(monkeypatch, skip, steps):
    timers = {}
    for name, module in (("port", profiling), ("jax", jax_profiling)):
        monkeypatch.setattr(module, "time", _Clock(steps))
        timer = module.StepTimer(skip=skip)
        for _ in steps:
            with timer:
                pass
        timers[name] = timer
    port, jax_timer = timers["port"], timers["jax"]
    assert port.times == jax_timer.times == steps[skip:]
    if port.times:
        assert port.mean == jax_timer.mean == sum(steps[skip:]) / len(steps[skip:])
        assert port.rate(8) == jax_timer.rate(8)
    else:
        assert np.isnan(port.mean) and np.isnan(port.rate(8)) and np.isnan(jax_timer.mean)
    assert profiling.StepTimer().skip == 2


# ---------------------------------------------------- the slice as a whole


def _images(b, size, seed):
    img = np.random.RandomState(seed).randint(0, 256, (b, size, size, 3))
    return (img.astype(np.float32) - 128.0) / 256.0


@pytest.fixture(scope="module")
def box_head():
    """The JAX box-head UniPose at reduced depth, seeded weights with BN
    randomised (drawn by the port's helper and converted by the JAX
    package's, so that no init is compiled), and the port's model carrying
    its weights through ``state_dict_from_jax``."""
    jmodel = ComposedUniPose(layers=REDUCED, bbox_head=True)
    variables = jax_variables(jmodel, random_state_dict(UniPose(layers=REDUCED, bbox_head=True), 12), (1, 64, 64, 3))
    port = UniPose(layers=REDUCED, bbox_head=True)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    return jmodel, variables, port.eval()


def test_box_head_multi_person_against_jax(box_head):
    """Maps at 1e-4; then JAX's maps (one set, so that a near-tie of the
    float local maximum cannot decide the test) decoded by both packages,
    and by the port's device peaks: equal people lists."""
    jmodel, variables, port = box_head
    x = _images(2, 64, seed=13)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))  # compiling beats op-by-op here
    jheat, jbox = (np.asarray(t) for t in apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        heat, box = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert heat.shape == (2, 15, 8, 8) and box.shape == (2, 5, 8, 8)
    assert max_rel_err(heat.permute(0, 2, 3, 1).numpy(), jheat) < 1e-4
    assert max_rel_err(box.permute(0, 2, 3, 1).numpy(), jbox) < 1e-4

    maps = np.moveaxis(np.concatenate([jheat, jbox], -1), -1, 1)  # (B, 20, h, w), box channels at 15
    people = 0
    for b in range(2):
        one = np.ascontiguousarray(maps[b : b + 1])
        want = jax_mp.multi_person_kpts(one, "LSP", num_joints=14)
        assert mp.multi_person_kpts(one, "LSP", 14) == want
        assert mp.multi_person_kpts(torch.from_numpy(one), "LSP", 14) == want
        people += len(want) // 19
    assert people > 0

    # the port's own maps: device peaks equal host peaks on the same maps
    ours = torch.cat([heat, box], 1)
    for b in range(2):
        assert mp.multi_person_kpts(ours[b : b + 1], "LSP", 14) == mp.multi_person_kpts(
            ours[b : b + 1].numpy(), "LSP", 14
        )


def test_model_summary_parameter_lines_against_jax(box_head):
    """The lines before the FLOP line equal JAX's (given no sample input,
    JAX's summary has no FLOP line)."""
    jmodel, variables, port = box_head
    want = jax_model_summary(jmodel, variables)
    got = model_summary(port, torch.zeros(1, 3, 64, 64))
    assert got.splitlines()[:-1] == want.splitlines()
    assert got.splitlines()[-1].startswith("Compiled forward FLOPs: ")


def _flops_line(summary: str) -> int:
    return int(summary.splitlines()[-1].split(": ")[1].split(" ")[0].replace(",", ""))


def test_model_summary_flops_through_the_op_formulas(box_head):
    """The eval count through the ops' formulas equals the count of the
    same forward through the plain stem and WASP called directly; the
    train count differs from it by exactly ``eval_minus_train_flops``."""
    _, _, port = box_head
    x = torch.from_numpy(_images(2, 64, seed=14)).permute(0, 3, 1, 2)
    with torch.no_grad():
        port(x)  # fold the weights once: the count is a steady forward's
    state = {k: v.clone() for k, v in port.state_dict().items()}
    ops = _flops_line(model_summary(port, x))
    port.backbone.stem = fs.fused_stem_reference
    port.wasp.cascade = wc.wasp_cascade_reference
    try:
        plain = compiled_flops(port, x)
    finally:
        del port.backbone.stem, port.wasp.cascade
    train = _flops_line(model_summary(port, x, train=True))
    assert ops == plain > 0
    assert ops - train == eval_minus_train_flops(2, 64, 64, 4, port.wasp.dilations[1:])["total"]
    assert not port.training
    for k, v in port.state_dict().items():  # the train-mode forward changed nothing
        assert torch.equal(v, state[k]), k


def test_compiled_flops_is_none_when_counting_fails(box_head):
    _, _, port = box_head
    port.train()
    try:  # train-mode BatchNorm refuses one value a channel (the GAP branch at batch 1)
        assert compiled_flops(port, torch.zeros(1, 3, 32, 32)) is None
    finally:
        port.eval()
    assert "FLOPs" not in model_summary(port, torch.zeros(1, 3, 32, 32), train=True)


@pytest.mark.parametrize("case", ["stem_368", "stem_odd", "wasp_all_taps", "wasp_skipped_taps", "conv_i8"])
def test_op_formulas_equal_the_plain_counts(case):
    """Each registered op counts what its plain version's products count."""
    gen = torch.Generator().manual_seed(15)
    if case.startswith("stem"):
        b, h, w = (1, 368, 368) if case == "stem_368" else (2, 37, 29)
        x = torch.randn(b, h, w, 3, generator=gen)
        folded = {"w4": torch.randn(192, 64, generator=gen), "scale": torch.ones(64), "bias": torch.zeros(64)}
        op, plain = lambda: fs.fused_stem(x, folded), lambda: fs.fused_stem_reference(x, folded)
        want = 2 * fs.stem_macs(b, h, w)
    elif case.startswith("wasp"):
        s = 19 if case == "wasp_all_taps" else 5  # 19 > 18: every tap of every dilation is active
        x = torch.randn(1, s, s, 2048, generator=gen)
        folded = {k: torch.randn(*v, generator=gen) * 0.01 for k, v in wc._SHAPES.items()}
        op, plain = lambda: wc.wasp_cascade(x, folded), lambda: wc.wasp_cascade_reference(x, folded)
        want = 2 * wc.cascade_macs(1, s, (18, 12, 6))
    else:
        x = torch.randint(-8, 8, (2, 11, 9, 24), dtype=torch.int8, generator=gen)
        w = ci.pack_weight(torch.randint(-8, 8, (3, 3, 24, 40), dtype=torch.int8, generator=gen))
        op = lambda: ci.conv_i8(x, w, 3, 3, 2, 1, 1)  # noqa: E731
        plain = lambda: ci.conv_i8_reference(x, ci.unpack_weight(w, 3, 3, 24), 2, 1, 1)  # noqa: E731
        want = 2 * ci.conv_macs(2, 6, 5, 40, 3, 3, 24)
    assert compiled_flops(op) == compiled_flops(plain) == want


# ---------------------------------------------------------------- parity_run


@pytest.mark.parametrize("case", ["equal", "one_joint", "pckh_only", "mean", "random"])
def test_compute_verdict_against_jax(case):
    k = 14
    rng = np.random.RandomState(16)
    ref = np.full(k + 1, 0.95)
    ours, ref_h, ours_h = ref.copy(), ref.copy(), ref.copy()
    if case == "one_joint":
        ours[3] -= 0.01
    elif case == "pckh_only":
        ours_h[3] -= 0.01
    elif case == "mean":
        ours[1:] -= 0.003
    elif case == "random":
        ref, ours, ref_h, ours_h = (rng.rand(k + 1) for _ in range(4))
    args = (ref, ours, ref_h, ours_h, 0.1, 0.5)
    got = parity_run.compute_verdict(*args)
    assert got == jax_parity.compute_verdict(*args)
    assert got["pass"] is (case == "equal")


def test_per_joint_metrics_against_jax():
    rng = np.random.RandomState(17)
    n, hm, k = 6, 46, 14
    heats = rng.rand(n, hm, hm, k + 1).astype(np.float32)
    coords = rng.uniform(0, hm, (n, k + 1, 2)).astype(np.float32)
    coords[0, 4] = [0.5, 20]  # on the border: not measurable
    coords[2, 7] = [30, 1.0]
    got = parity_run._per_joint_metrics(heats, coords, hm, "LSP", k)
    want = jax_parity._per_joint_metrics(heats, coords, hm, "LSP", k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL)


def test_parity_run_fails_fast_without_artifacts(tmp_path):
    for main in (parity_run.main, jax_parity.main):
        with pytest.raises(SystemExit, match="torch_ckpt"):
            main(["--torch_ckpt", str(tmp_path / "missing.pth.tar"), "--val_dir", str(tmp_path)])
    ckpt = tmp_path / "present.pth.tar"
    ckpt.write_bytes(b"")
    with pytest.raises(SystemExit, match="reference checkout not found"):
        parity_run.main(["--torch_ckpt", str(ckpt), "--val_dir", str(tmp_path),
                         "--reference", str(tmp_path / "no_reference")])


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(os.path.join(REFERENCE, "model")), reason="reference repo not mounted")
def test_parity_run_same_weights_pass(tmp_path):
    """The reference's own model, its weights saved as its
    ``save_checkpoint`` does, against the port warm-started from them on
    two LSP val images: PARITY PASS with every delta 0."""
    cv2 = pytest.importorskip("cv2")
    import scipy.io

    if REFERENCE not in sys.path:
        sys.path.insert(0, REFERENCE)
    import model.modules.backbone.resnet as ref_resnet

    ref_resnet.model_zoo.load_url = lambda *a, **k: {}
    import model.unipose as ref_unipose

    torch.manual_seed(0)
    net = ref_unipose.unipose("LSP", num_classes=14, stride=8)
    g = torch.Generator().manual_seed(1)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.copy_(0.05 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.9 + 0.2 * torch.rand(m.running_var.shape, generator=g))
    ckpt = tmp_path / "unipose_synthetic.pth.tar"
    torch.save({"state_dict": net.state_dict()}, str(ckpt))

    root = tmp_path / "lsp"
    os.makedirs(root / "images")
    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(root / "images" / f"im{i + 1:04d}.jpg"), rng.randint(0, 255, (90, 100, 3), np.uint8))
    joints = np.zeros((3, 14, 2))
    joints[0] = rng.uniform(10, 90, (14, 2))
    joints[1] = rng.uniform(10, 80, (14, 2))
    scipy.io.savemat(str(root / "joints.mat"), {"joints": joints})

    verdict = parity_run.main([
        "--torch_ckpt", str(ckpt), "--val_dir", str(root), "--dataset", "LSP",
        "--max_samples", "2", "--reference", REFERENCE, "--device", "cpu",
    ])
    assert verdict["pass"] is True and verdict["n"] == 2
    assert abs(verdict["delta_pt"]) < 1e-9 and abs(verdict["delta_pckh_pt"]) < 1e-9
    assert verdict["worst_joint_delta_pt"] < 1e-9 and verdict["worst_joint_delta_pckh_pt"] < 1e-9
    assert verdict["heatmap_maxnorm_rel_err"] < 5e-4
