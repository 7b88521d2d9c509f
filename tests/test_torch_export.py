"""The port's serving artifacts (compat/export.py): twins of
tests/test_export.py, the artifacts against the live port model and
against the JAX model on the same weights, the raw uint8 input, the
int8 artifact, the exported graph (the kernels as ops, no parameter
converted), loading without the model code, and the refusals (a blob of
another kind, another device).  The video artifacts: test_torch_export_video.py.

Tolerances: an artifact runs the live model's ops in the same order, so
against it the f32 heatmaps are held at 1e-6 max-norm relative (read 0);
against JAX at the parity bar, 1e-4 (tests/test_parity_full.py:47-75).
"""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (  # two_threads_for_the_module: an autouse fixture
    ComposedUniPose,
    jax_variables,
    max_rel_err,
    two_threads_for_the_module,
)
from unipose_tpu.compat.export import STREAM_MAGIC as JAX_STREAM_MAGIC
from unipose_tpu_torch.compat import export
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models import quantized
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict

REDUCED = (1, 1, 1, 1)
SIZE = 64
ROOT = Path(__file__).resolve().parents[1]


def _images(seed, b=2, size=SIZE):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)


def _normalised(pixels):
    return (pixels.astype(np.float32) - 128.0) / 256.0


@pytest.fixture(scope="module")
def jax_image():
    """The port's UniPose at reduced depth (seeded weights, BN perturbed)
    and the JAX model on the same weights."""
    model = build_model(ModelConfig(), layers=REDUCED)
    state = random_state_dict(model, seed=21)
    load_numpy_state_dict(model, state)
    jmodel = ComposedUniPose(layers=REDUCED)
    return jmodel, jax_variables(jmodel, state, (1, SIZE, SIZE, 3)), model.eval()


@pytest.fixture(scope="module")
def image_blob(jax_image, tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "unipose.pt2"
    blob = export.export_inference(jax_image[2], (2, SIZE, SIZE, 3), path=str(path))
    return blob, path


def test_export_roundtrip(jax_image, image_blob):
    """Twin of tests/test_export.py::test_export_roundtrip: the bytes are
    written, load back, and the artifact equals the live model."""
    blob, path = image_blob
    assert len(blob) > 1000 and path.read_bytes() == blob
    x = _normalised(_images(0))
    got = export.load_inference(blob)(torch.from_numpy(x))
    with torch.no_grad():
        want = jax_image[2](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, SIZE // 8, SIZE // 8, 15) and got.dtype == torch.float32
    assert max_rel_err(got.numpy(), want.numpy()) <= 1e-6


def test_artifact_matches_jax(jax_image, image_blob):
    jmodel, variables, _ = jax_image
    x = _normalised(_images(1))
    got = export.load_inference(image_blob[0])(torch.from_numpy(x))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    assert max_rel_err(got.numpy(), np.asarray(want)) < 1e-4


def test_raw_uint8_artifact_matches_f32_artifact(jax_image, image_blob):
    """Twin of tests/test_serve.py::test_raw_uint8_artifact_roundtrip's
    first half: uint8 in, normalised inside, the f32 artifact's heatmaps."""
    blob_u8 = export.export_inference(jax_image[2], (2, SIZE, SIZE, 3), raw_uint8=True)
    ep = export.load_exported(blob_u8)
    assert export.input_specs(ep) == [((2, SIZE, SIZE, 3), torch.uint8)]
    pixels = _images(2)
    out_u8 = ep.module()(torch.from_numpy(pixels))
    out_f32 = export.load_inference(image_blob[0])(torch.from_numpy(_normalised(pixels)))
    assert max_rel_err(out_u8.numpy(), out_f32.numpy()) <= 1e-6


def _kernel_nodes_and_conversions(ep):
    """Counts of the unipose ops in the graph, and the nodes that convert or
    join a parameter or buffer (what a frozen program must not do)."""
    ops = Counter(str(n.target).rsplit(".", 1)[0] for n in ep.graph.nodes
                  if n.op == "call_function" and str(n.target).startswith("unipose."))
    weights = set(ep.graph_signature.inputs_to_parameters) | set(ep.graph_signature.inputs_to_buffers)
    converting = ("to", "_to_copy", "type_as", "cat", "contiguous", "clone", "rsqrt", "sqrt", "div",
                  "permute", "reshape", "view", "t", "transpose", "matmul", "mm")
    bad = []
    for n in ep.graph.nodes:
        if n.op != "call_function":
            continue
        name = str(n.target).split(".")[1] if str(n.target).startswith("aten.") else ""
        flat = [a for arg in n.args for a in (arg if isinstance(arg, (list, tuple)) else [arg])]
        if name in converting and any(getattr(a, "name", None) in weights for a in flat):
            bad.append(n.format_node())
    return ops, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exported_graph_calls_each_kernel_once_and_converts_no_parameter(dtype):
    model = build_model(ModelConfig(compute_dtype=dtype), layers=REDUCED)
    load_numpy_state_dict(model, random_state_dict(model, seed=5))
    ep = export.load_exported(export.export_inference(model.eval(), (1, SIZE, SIZE, 3)))
    ops, bad = _kernel_nodes_and_conversions(ep)
    assert ops == {"unipose.fused_stem": 1, "unipose.wasp_cascade": 1}
    assert not bad, bad
    # the frozen copy holds the folded weights; the live model is untouched
    assert "backbone.conv1.weight" in model.state_dict()
    assert not any(k.endswith("conv1.weight") and "backbone" in k and "layer" not in k
                   for k in ep.state_dict)


def test_export_int8_frontend_roundtrip():
    """Twin of tests/test_export.py::test_export_int8_frontend_roundtrip: the
    int8 forward (front end at full depth, layer3/4 cut) exports, loads and
    equals the live quantized forward; the program calls the fused int8 conv
    (conv_i8_requant) 24 times and the stem kernel not at all."""
    model = build_model(ModelConfig(), layers=(3, 4, 1, 1))
    load_numpy_state_dict(model, random_state_dict(model, seed=12))
    x = torch.from_numpy(_normalised(_images(3)))
    _, forward = quantized.int8_forward_fn(model.eval(), x, dtype=torch.float32)
    blob = export.export_inference(model, (2, SIZE, SIZE, 3), forward=forward)
    ep = export.load_exported(blob)
    got = ep.module()(x)
    with torch.no_grad():
        want = forward(x)
    assert got.shape == (2, SIZE // 8, SIZE // 8, 15)
    assert max_rel_err(got.numpy(), want.numpy()) <= 1e-6
    ops, bad = _kernel_nodes_and_conversions(ep)
    assert ops == {"unipose.conv_i8_requant": 24, "unipose.wasp_cascade": 1} and not bad, (ops, bad)


def test_loading_needs_no_model_code(image_blob):
    """An artifact loads and runs in a process that imports only
    compat/export.py: no module of unipose_tpu_torch.models is loaded."""
    code = (
        "import sys, torch\n"
        "from unipose_tpu_torch.compat.export import load_inference\n"
        f"fn = load_inference(open({str(image_blob[1])!r}, 'rb').read())\n"
        "out = fn(torch.zeros(2, 64, 64, 3))\n"
        "assert out.shape == (2, 8, 8, 15), out.shape\n"
        "bad = sorted(m for m in sys.modules if m.startswith('unipose_tpu_torch.models'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                                            "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_other_blobs_are_refused_with_a_message(image_blob):
    hlo = jax.export.export(jax.jit(lambda x: x + 1))(jax.ShapeDtypeStruct((2,), jnp.float32)).serialize()
    for blob in (bytes(hlo), b"\x00" * 64, JAX_STREAM_MAGIC + bytes(hlo)):
        with pytest.raises(ValueError, match="unipose_tpu_torch"):
            export.load_exported(blob)
    with pytest.raises(ValueError, match="JAX"):
        export.load_video_stream(JAX_STREAM_MAGIC + bytes(hlo))
    with pytest.raises(ValueError, match="streaming"):
        export.load_video_stream(image_blob[0])
    # a program runs where it was exported: a CPU artifact is refused on the card
    with pytest.raises(ValueError, match="cannot run on cuda"):
        export.load_exported(image_blob[0], device="cuda")
    assert export.artifact_meta(image_blob[0])["device"] == "cpu"

