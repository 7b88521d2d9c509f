"""The port's UniPose-LSTM video path against the JAX package: the ConvLSTM
cells, the model at reduced depth through ``state_dict_from_jax(variant=
"lstm")``, its ``state_dict`` keys, chunked streaming against the full
rollout and against JAX ``stream_video``, the centermap pool and
centermaps, the init family, and the committed golden stream.

Regenerate the golden file with
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_video.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import max_rel_err, perturb_bn, reduced_lstm_depth
from unipose_tpu.compat.torch_convert import convert_state_dict
from unipose_tpu.compat.torch_export import export_state_dict
from unipose_tpu.core.config import DATASETS as JAX_DATASETS
from unipose_tpu.eval.video import stream_video as jax_stream_video
from unipose_tpu.models.unipose_lstm import ConvLSTM0 as JaxConvLSTM0
from unipose_tpu.models.unipose_lstm import ConvLSTMCell as JaxConvLSTMCell
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu.ops.pooling import avg_pool2d as jax_avg_pool2d
from unipose_tpu.train.steps import make_centermaps as jax_make_centermaps
from unipose_tpu.train.steps import preprocess_images as jax_preprocess
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.compat.torch_convert import load_state_dict_intersection
from unipose_tpu_torch.core.config import DATASETS, ModelConfig
from unipose_tpu_torch.eval.video import stream_video, stream_video_scan
from unipose_tpu_torch.models.unipose import (
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.models.unipose_lstm import ConvLSTM0, ConvLSTMCell
from unipose_tpu_torch.ops.pooling import avg_pool2d
from unipose_tpu_torch.train.steps import make_centermaps

REDUCED = (1, 1, 1, 1)
SIZE = 64
CONFIG = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")
GOLDEN = Path(__file__).parent / "data" / "golden_video_stream_reduced_128.npz"


@pytest.fixture(scope="module", autouse=True)
def _reduced_jax_depth():
    with reduced_lstm_depth(REDUCED):
        yield


@pytest.fixture(scope="module")
def jax_lstm():
    """The JAX UniPoseLSTM at reduced depth, BN perturbed."""
    model = JaxUniPoseLSTM(num_classes=13)
    variables = jax.jit(lambda k, f, c: model.init(k, f, c, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, SIZE, SIZE, 3)), jnp.zeros((1, 2, SIZE, SIZE, 1))
    )
    return model, perturb_bn(variables, 1)


@pytest.fixture(scope="module")
def port_lstm(jax_lstm):
    _, variables = jax_lstm
    model = build_model(CONFIG, layers=REDUCED)
    model.load_state_dict(state_dict_from_jax(variables, variant="lstm"))  # strict
    return model.eval()


def _clip(b, t, seed, size=SIZE):
    """Seeded raw frames (B, T, H, W, 3) and centers (B, T, 2), f32."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (b, t, size, size, 3)).astype(np.float32)
    centers = (rng.rand(b, t, 2) * size).astype(np.float32)
    return frames, centers


def _spec(size=SIZE):
    return dataclasses.replace(DATASETS["Penn_Action"], input_size=size)


def _port_inputs(frames, centers, spec):
    x = (torch.from_numpy(frames) - 128.0) / 256.0
    cm = make_centermaps(torch.from_numpy(centers), spec)
    return x.permute(0, 1, 4, 2, 3), cm.permute(0, 1, 4, 2, 3)


def _conv(rng, cout, cin):
    return {
        "weight": (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
        "bias": (rng.randn(cout) * 0.1).astype(np.float32),
    }


def test_convlstm0_matches_jax():
    ch = 15
    rng = np.random.RandomState(2)
    params = {f"conv_{g}_lstm": _conv(rng, ch, ch) for g in "gio"}
    x = rng.randn(2, 10, 10, ch).astype(np.float32)
    cell, hide = JaxConvLSTM0(ch).apply({"params": params}, jnp.asarray(x))

    port = ConvLSTM0(ch)
    port.load_state_dict(state_dict_from_jax({"params": params}))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, (cell, hide)):
        assert g.dtype == torch.float32
        assert max_rel_err(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) < 1e-5


def test_convlstm_cell_matches_jax():
    """One step from a carried (cell, hide): the fused gate convs split per
    gate by ``state_dict_from_jax`` and concatenated again at the call, in
    gate order g, i, o, f."""
    ch = 15
    rng = np.random.RandomState(3)
    params = {"conv_x_gates": _conv(rng, 4 * ch, ch), "conv_h_gates": _conv(rng, 4 * ch, ch)}
    x, prev_hide, prev_cell = (rng.randn(2, 10, 10, ch).astype(np.float32) for _ in range(3))
    (cell, hide), out = JaxConvLSTMCell(ch).apply(
        {"params": params}, (jnp.asarray(prev_cell), jnp.asarray(prev_hide)), jnp.asarray(x)
    )

    sd = state_dict_from_jax({"params": {"lstm": params}}, variant="lstm")
    port = ConvLSTMCell(ch)
    port.load_state_dict({k[len("lstm."):]: v for k, v in sd.items()})
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        got = port((nchw(prev_cell), nchw(prev_hide)), port.x_gates(nchw(x)))
    for g, w in zip(got, (cell, hide)):
        assert max_rel_err(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) < 1e-5
    np.testing.assert_array_equal(np.asarray(out), np.asarray(hide))


def test_state_dict_from_jax_equals_export_state_dict(jax_lstm, port_lstm):
    _, variables = jax_lstm
    ours = state_dict_from_jax(variables, variant="lstm")
    ref = export_state_dict(variables, variant="lstm")
    assert sorted(ours) == sorted(ref) == sorted(port_lstm.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # a reference-keyed checkpoint loads whole through the key intersection
    fresh = build_model(CONFIG, layers=REDUCED)
    report = load_state_dict_intersection(fresh, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()})
    assert not report["skipped"] and len(report["loaded"]) == len(ref)


@pytest.mark.parametrize("t", [1, 3])
def test_model_matches_jax(jax_lstm, port_lstm, t):
    """Heatmaps and the final (cell, hide) at reduced depth, T frames from
    ConvLSTM0; the JAX model sows its final state, the port returns it."""
    model, variables = jax_lstm
    frames, centers = _clip(2, t, seed=4 + t)
    spec = _spec()
    want, inter = model.apply(
        variables, jax_preprocess(jnp.asarray(frames)), jax_make_centermaps(jnp.asarray(centers), spec),
        train=False, mutable=["intermediates"],
    )
    with torch.no_grad():
        heat, (cell, hide) = port_lstm(*_port_inputs(frames, centers, spec))
    assert heat.shape == (2, t, 14, SIZE // 8, SIZE // 8) and heat.dtype == torch.float32
    assert max_rel_err(heat.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want)) < 1e-4
    want_cell, want_hide = inter["intermediates"]["final_state"][0]
    assert max_rel_err(cell.permute(0, 2, 3, 1).numpy(), np.asarray(want_cell)) < 1e-4
    assert max_rel_err(hide.permute(0, 2, 3, 1).numpy(), np.asarray(want_hide)) < 1e-4


def test_chunked_equals_full_rollout(port_lstm):
    """Frame 0 of a continued chunk goes through ConvLSTMCell with the
    carried state: two chunks give the one rollout."""
    frames, centers = _clip(1, 4, seed=8)
    x, cm = _port_inputs(frames, centers, _spec())
    with torch.no_grad():
        full, full_state = port_lstm(x, cm)
        first, state = port_lstm(x[:, :2], cm[:, :2])
        second, state = port_lstm(x[:, 2:], cm[:, 2:], initial_state=state)
    got = torch.cat([first, second], dim=1)
    assert max_rel_err(got.numpy(), full.numpy()) < 1e-5
    for g, w in zip(state, full_state):
        assert max_rel_err(g.numpy(), w.numpy()) < 1e-5


def test_stream_video_matches_jax(jax_lstm, port_lstm):
    """``stream_video`` and ``stream_video_scan`` against JAX ``stream_video``
    on 5 frames in chunks of 2: the last chunk is padded, its pad dropped."""
    model, variables = jax_lstm
    frames, centers = _clip(1, 5, seed=9)
    spec = _spec()
    jspec = dataclasses.replace(JAX_DATASETS["Penn_Action"], input_size=SIZE)
    want = jax_stream_video(model, variables["params"], variables["batch_stats"], frames, centers,
                            jspec, chunk=2)
    got = stream_video(port_lstm, frames, centers, spec, chunk=2)
    assert got.shape == want.shape == (1, 5, SIZE // 8, SIZE // 8, 14)
    assert max_rel_err(got, want) < 1e-4
    scanned = stream_video_scan(port_lstm, torch.from_numpy(frames), torch.from_numpy(centers), spec, chunk=2)
    np.testing.assert_allclose(scanned.numpy(), got, rtol=0, atol=1e-6)


def test_avg_pool_and_centermaps_match_jax():
    """The centermap pool 9/8/1 divides by 81 everywhere, borders included."""
    rng = np.random.RandomState(10)
    x = rng.rand(2, 37, 29, 1).astype(np.float32)
    want = np.asarray(jax_avg_pool2d(jnp.asarray(x), 9, 8, 1))
    got = avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 9, 8, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ones = avg_pool2d(torch.ones(1, 1, SIZE, SIZE), 9, 8, 1)
    assert ones[0, 0, 0, 0].item() == pytest.approx(64 / 81)  # a corner window holds 8x8 pixels

    centers = (rng.rand(2, 3, 2) * SIZE).astype(np.float32)
    want = np.asarray(jax_make_centermaps(jnp.asarray(centers),
                                          dataclasses.replace(JAX_DATASETS["Penn_Action"], input_size=SIZE)))
    got = make_centermaps(torch.from_numpy(centers), _spec()).numpy()
    assert got.shape == want.shape == (2, 3, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("positive", [False, True])
def test_init_family(positive):
    """He-normal fan_out for the tower, torch's U(+-1/sqrt(fan_in)) for the
    ConvLSTM and the head, whose biases sit at +1/sqrt(fan_in) with
    ``head_positive_bias``; the same seed gives the same weights."""
    config = dataclasses.replace(CONFIG, head_positive_bias=positive)
    model = init_model(config, seed=5, device="cpu", layers=REDUCED)
    again = init_model(config, seed=5, device="cpu", layers=REDUCED)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, again.state_dict()[k], rtol=0, atol=0)
    torch_default = [model.lstm_0.conv_g_lstm, model.lstm.conv_fh_lstm, model.conv1, model.conv5]
    for m in torch_default:
        bound = m.weight[0].numel() ** -0.5
        assert m.weight.abs().max() <= bound
        assert m.weight.std().item() == pytest.approx(bound / np.sqrt(3), rel=0.1)
    for m in (model.lstm_0.conv_g_lstm, model.lstm.conv_fh_lstm):  # never positive
        bound = m.weight[0].numel() ** -0.5
        assert m.bias.abs().max() <= bound and m.bias.min() < 0 < m.bias.max()
    for m in (model.conv1, model.conv2, model.conv3, model.conv4, model.conv5):
        bound = m.weight[0].numel() ** -0.5
        if positive:
            torch.testing.assert_close(m.bias, torch.full_like(m.bias, bound), rtol=0, atol=0)
        else:
            assert m.bias.abs().max() <= bound and m.bias.min() < 0 < m.bias.max()
    w = model.backbone.layer2[0].conv2.weight  # He-normal fan_out: sqrt(2 / (128 * 9))
    assert abs(w.std().item() / np.sqrt(2 / 1152) - 1) < 0.05


def test_bf16_compute_keeps_f32_heatmaps_and_state(port_lstm):
    model = build_model(dataclasses.replace(CONFIG, compute_dtype=torch.bfloat16), layers=REDUCED)
    model.load_state_dict(port_lstm.state_dict())
    frames, centers = _clip(1, 3, seed=11)
    x, cm = _port_inputs(frames, centers, _spec())
    with torch.no_grad():
        want, _ = port_lstm(x, cm)
        got, (cell, hide) = model.eval()(x, cm)
    assert got.dtype == cell.dtype == hide.dtype == torch.float32
    assert max_rel_err(got.numpy(), want.numpy()) < 5e-2


def _golden_inputs(golden):
    size = int(golden["size"])
    frames, centers = _clip(1, int(golden["frames"]), int(golden["input_seed"]), size)
    model = build_model(CONFIG, layers=tuple(int(v) for v in golden["layers"]))
    return model, random_state_dict(model, int(golden["weights_seed"])), frames, centers, size


def test_golden_video_stream():
    """The port's two-chunk stream on the CPU against the committed JAX
    heatmaps (chip_smoke.py holds the card's stream against the same
    file)."""
    golden = np.load(GOLDEN)
    model, state, frames, centers, size = _golden_inputs(golden)
    load_numpy_state_dict(model, state)
    got = stream_video(model.eval(), frames, centers, _spec(size), chunk=int(golden["chunk"]))
    assert got.shape == golden["heatmaps"].shape == (1, 10, size // 8, size // 8, 14)
    assert max_rel_err(got, golden["heatmaps"]) < 1e-4


if __name__ == "__main__":
    seeds = {"layers": np.array(REDUCED), "weights_seed": np.array(0), "input_seed": np.array(1),
             "size": np.array(128), "frames": np.array(10), "chunk": np.array(5)}
    model, state, frames, centers, size = _golden_inputs(seeds)
    with reduced_lstm_depth(REDUCED):
        jmodel = JaxUniPoseLSTM(num_classes=13)
        template = jax.jit(lambda k, f, c: jmodel.init(k, f, c, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2, 64, 64, 1))
        )
        variables, report = convert_state_dict(state, template, variant="lstm")
        assert all(k.endswith("num_batches_tracked") for k in report["skipped"])
        jspec = dataclasses.replace(JAX_DATASETS["Penn_Action"], input_size=size)
        heat = jax_stream_video(jmodel, variables["params"], variables["batch_stats"], frames, centers,
                                jspec, chunk=int(seeds["chunk"]))
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GOLDEN, heatmaps=np.asarray(heat, np.float32), **seeds)
    print(f"wrote {GOLDEN} {heat.shape}")
