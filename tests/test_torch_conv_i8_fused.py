"""The fused int8 conv, ``unipose::conv_i8_requant`` (ops/kernels/conv_i8.py),
on the CPU, where the op runs its plain version: against the unfused
PyTorch chain that the front end ran before the epilogue was fused, against
the JAX package's arithmetic, and in ``frontend_int8``, the int8 forwards
and an exported program.  The CUDA kernel against this plain version:
tests/test_torch_kernels_cuda.py (marked ``cuda``).

What is read, and the tolerances (read first, then fixed):
  * the op's plain version against the unfused chain: equal, bit for bit
    (the same PyTorch ops in the same order), codes, f32 outputs and the
    dequantised outputs, with sums past 2^24;
  * against JAX's epilogue (XLA on the CPU) on the same int32 accumulator:
    the codes equal (read: equal at every case);
  * ``frontend_int8`` on the fused op against the unfused chain
    (``frontend_int8_unfused``, which chip_smoke.py times): equal, bit for
    bit, in f32 and bf16;
  * an exported int8 program: 24 calls of the fused op and none of the int32
    op, and the same FLOP count as the unfused forward.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import two_threads_for_the_module  # noqa: F401  (autouse)
from unipose_tpu.ops import quant as jax_quant
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models import quantized
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict
from unipose_tpu_torch.ops import quant
from unipose_tpu_torch.ops.kernels import conv_i8 as kernel
from unipose_tpu_torch.utils.summary import compiled_flops

# (Cin, Cout, k, stride, padding, H): tests/test_torch_quant.py's CONV_CASES,
# the front end's kinds of conv scaled down.
CONV_CASES = {
    "7x7/2 cin3": (3, 64, 7, 2, 3, 21),
    "3x3/2 cin128": (128, 32, 3, 2, 1, 9),
    "1x1/2 cin256": (256, 24, 1, 2, 0, 7),
    "3x3/1 cin64": (64, 16, 3, 1, 1, 8),
    "1x1 cin256": (256, 40, 1, 1, 0, 5),
}
# The epilogues the front end asks for: (out_scale given, residual, deq dtype).
KINDS = {
    "codes": (True, None, None),  # each block's conv1 and conv2, the stem's conv1
    "f32": (False, None, None),  # the downsample
    "codes_res_f32": (True, torch.float32, None),  # a stage's first conv3
    "codes_res_i8": (True, torch.int8, None),  # the other conv3s
    "codes_res_i8_deq_f32": (True, torch.int8, torch.float32),  # a stage's last conv3
    "codes_res_i8_deq_bf16": (True, torch.int8, torch.bfloat16),
    "codes_res_f32_deq_bf16": (True, torch.float32, torch.bfloat16),
}
OUT_SCALE, RES_SCALE, S_IN = 4.0 / 127, 3.0 / 127, 0.0213


def _case(case: str, seed: int):
    """Saturated image 0 and filters 0 and 1 (the largest sums), random
    codes elsewhere; per-channel scales that put y = acc*scale + b at O(1),
    so that the codes spread over the whole range and clip at both ends."""
    cin, cout, k, stride, padding, h = CONV_CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (2, h, h + 1, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    x[0] = 127
    w[..., 0] = 127
    w[..., 1] = -127
    k_len = k * k * cin
    w_scale = ((rng.rand(cout) + 0.5) / (127 * 127 * np.sqrt(k_len) / 3 * S_IN)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, w, w_scale, bias, (stride, padding)


def _unfused(acc, scale, bias, out_scale, residual, residual_scale, deq_dtype):
    """The chain ops/quant.py::frontend_int8 ran before the fusion, an op a
    step: ``y.float() * (w_scale * s) + b``, ReLU after the residual add,
    ``round(h / s)`` by a Python float, clamp, the dequantised value cast."""
    y = acc.float() * scale + bias
    if out_scale is None:
        return [y]
    if residual is not None:
        y = y + (residual if residual.dtype == torch.float32 else residual.float() * residual_scale)
    q = torch.clamp(torch.round(torch.relu(y).float() / out_scale), -127, 127).to(torch.int8)
    return [q] if deq_dtype is None else [q, (q.float() * out_scale).to(deq_dtype)]


def _residual(rng, kind, shape):
    if kind == torch.float32:
        return torch.from_numpy((rng.randn(*shape) * 2).astype(np.float32))
    if kind == torch.int8:
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    return None


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_fused_plain_version_equals_the_unfused_chain(case, kind):
    seed = sorted(CONV_CASES).index(case) * 10 + sorted(KINDS).index(kind)
    x, w, w_scale, bias, (stride, padding) = _case(case, seed)
    requant, res_kind, deq_dtype = KINDS[kind]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    scale = torch.from_numpy(w_scale) * S_IN  # the op Int8Frontend's buffers hold
    acc = kernel.conv_i8_reference(xt, wt, stride, padding)
    residual = _residual(np.random.RandomState(seed + 1), res_kind, tuple(acc.shape))
    out_scale = OUT_SCALE if requant else None
    want = _unfused(acc, scale, torch.from_numpy(bias), out_scale, residual, RES_SCALE, deq_dtype)
    kh, kw = w.shape[:2]
    before = kernel.conv_i8_requant.launches
    got = kernel.conv_i8_requant(xt, kernel.pack_weight(wt), scale, torch.from_numpy(bias), kh, kw, stride,
                                 padding, 1, out_scale, residual, RES_SCALE, deq_dtype)
    assert kernel.conv_i8_requant.launches == before  # the CPU takes the plain version
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for g, t in zip(got, want):
        assert torch.equal(g, t)
    if k_len_past_2_24(case):
        assert int(acc.abs().max()) > 2**24
    if requant:  # the codes cover the range, clipped at both ends where y can go negative
        assert int(got[0].max()) == 127 and int(got[0].min()) == 0


def k_len_past_2_24(case: str) -> bool:
    cin, _, k, *_ = CONV_CASES[case]
    return k * k * cin >= 1152


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_fused_plain_version_equals_jax_epilogue(case):
    """The codes of a stage's first conv3 (f32 residual) and of a later one
    (int8 residual), against JAX's frontend_int8 arithmetic on the same
    int32 accumulator (quant.py:291-303): XLA's f32 epilogue on the CPU."""
    x, w, w_scale, bias, (stride, padding) = _case(case, 50 + sorted(CONV_CASES).index(case))
    jqc = jax_quant.QuantConv(jnp.asarray(w), jnp.asarray(w_scale), jnp.asarray(bias), stride, padding)
    jacc = jax_quant.conv_i8(jnp.asarray(x), jqc)
    jy = jacc.astype(jnp.float32) * (jqc.w_scale * S_IN) + jqc.b
    rng = np.random.RandomState(7)
    r_f32 = (rng.randn(*jacc.shape) * 2).astype(np.float32)
    r_i8 = rng.randint(-127, 128, jacc.shape).astype(np.int8)
    scale = torch.from_numpy(w_scale) * S_IN
    kh, kw = w.shape[:2]
    for residual, jres in ((r_f32, jnp.asarray(r_f32)), (r_i8, jnp.asarray(r_i8).astype(jnp.float32) * RES_SCALE)):
        h = jnp.maximum(jy + jres, 0.0)
        jq = np.asarray(jnp.clip(jnp.round(h.astype(jnp.float32) / OUT_SCALE), -127, 127).astype(jnp.int8))
        q = kernel.conv_i8_requant(torch.from_numpy(x), kernel.pack_weight(torch.from_numpy(w)), scale,
                                   torch.from_numpy(bias), kh, kw, stride, padding, 1, OUT_SCALE,
                                   torch.from_numpy(residual), RES_SCALE)[0]
        np.testing.assert_array_equal(q.numpy(), jq)


def test_requant_divides_by_a_tensor_on_the_input_device():
    """requant's quotient is the true f32 quotient (the f64 quotient rounded
    to f32), the one a Python-float divisor gives on the CPU; on a CUDA
    tensor a Python float would multiply by the reciprocal instead."""
    h = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32) * 50)
    s = 0.0173
    true = torch.round((h.double() / np.float32(s)).float())
    assert torch.equal(kernel.requant(h, s).float(), torch.clamp(true, -127, 127))
    assert torch.equal(kernel.requant(h, s), torch.clamp(torch.round(h / s), -127, 127).to(torch.int8))


# ---------------------------------------------------------------------------
# frontend_int8, the int8 forwards and an exported program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_model():
    """The front end at full depth (layer3/4 cut), seeded weights, its int8
    state calibrated on the images it runs."""
    model = build_model(ModelConfig(), layers=(3, 4, 1, 1))
    load_numpy_state_dict(model, random_state_dict(model, seed=21))
    model.eval()
    rng = np.random.RandomState(21)
    x = torch.from_numpy(((rng.rand(2, 48, 48, 3) * 255 - 128) / 256).astype(np.float32))
    with torch.no_grad():
        fe = quantized.prepare_int8_frontend(model, x)
    return model, fe, x


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_frontend_int8_equals_the_unfused_chain(int8_model, out_dtype):
    _, fe, x = int8_model
    with torch.no_grad():
        want_out, want_low = quant.frontend_int8_unfused(fe.qconvs, fe.act_scales, x, out_dtype=out_dtype,
                                                         return_low=True)
        scales = quant.combined_scales(fe.qconvs, fe.act_scales)
        out, low = quant.frontend_int8(fe.qconvs, fe.act_scales, x, scales=scales, out_dtype=out_dtype,
                                       return_low=True)
        mod_out, mod_low = fe(x, out_dtype=out_dtype)  # Int8Frontend: the combined scales as buffers
        only_out = quant.frontend_int8(fe.qconvs, fe.act_scales, x, scales=scales, out_dtype=out_dtype)
    assert out.shape == (2, 6, 6, 512) and low.shape == (2, 12, 12, 256)
    for got in (out, mod_out, only_out):
        assert got.dtype == out_dtype and torch.equal(got, want_out)
    for got in (low, mod_low):
        assert got.dtype == out_dtype and torch.equal(got, want_low)
    assert float(want_out.abs().max()) > 0


def test_int8_frontend_holds_the_combined_scales(int8_model):
    _, fe, _ = int8_model
    points = quant.frontend_input_points()
    assert set(points) == set(fe.names) and len(points) == 24
    for i, (name, qc) in enumerate(fe.qconvs.items()):
        assert torch.equal(getattr(fe, f"c{i}"), qc.w_scale * fe.act_scales[points[name]])


def test_int8_program_calls_the_fused_op_24_times(int8_model):
    """An int8 program exported on the CPU: 24 calls of the fused op (its
    fake implementation gives the trace its outputs), none of the int32 op,
    the live forward's heatmaps, and the FLOP count of the unfused forward
    (elementwise work is not counted, the convs' products are)."""
    from unipose_tpu_torch.compat import export

    model, fe, x = int8_model
    forward = quantized.Int8ImageForward(model, fe, torch.float32)
    ep = export.load_exported(export.export_inference(model, (2, 48, 48, 3), forward=forward))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum(t.startswith("unipose.conv_i8_requant") for t in targets) == 24
    assert not any(t.startswith("unipose.conv_i8.") for t in targets)
    with torch.no_grad():
        want = forward(x)
    assert torch.equal(ep.module()(x), want)

    class Unfused(torch.nn.Module):
        def forward(self, x, out_dtype=torch.float32):
            return quant.frontend_int8_unfused(fe.qconvs, fe.act_scales, x, out_dtype=out_dtype,
                                               return_low=True)

    unfused = quantized.Int8ImageForward(model, fe, torch.float32)
    unfused.fe = Unfused()
    convs = sum(2 * kernel.conv_macs(2, *q.shape[1:3], q.shape[3], *qc.w_i8.shape[:3])
                for q, qc in _conv_outputs(fe, x))
    assert compiled_flops(fe, x) == compiled_flops(Unfused(), x) == convs
    assert compiled_flops(forward, x) == compiled_flops(unfused, x) > convs


def _conv_outputs(fe, x):
    """(an output of each front-end conv, its QuantConv), from the plain
    ops on ``x``: the shapes the FLOP formula reads."""
    seen = []
    qconvs = fe.qconvs

    def conv(name, qv, point, residual=None, deq=False):
        acc = quant.conv_i8(qv[0], qconvs[name])
        seen.append((acc, qconvs[name]))
        qv = (torch.clamp(acc, -127, 127).to(torch.int8), 1.0)
        return (qv, None) if deq else qv

    with torch.no_grad():
        quant._run_frontend(x, lambda name, h: (torch.round(h * 127).to(torch.int8), 1.0), conv,
                            lambda qv: (quant._max_pool(qv[0].half()).to(torch.int8), 1.0))
    assert len(seen) == 24
    return seen


def test_fused_op_raises_on_what_it_does_not_take():
    x = torch.zeros(1, 8, 8, 16, dtype=torch.int8)
    w = kernel.pack_weight(torch.zeros(3, 3, 16, 8, dtype=torch.int8))
    scale, bias = torch.ones(8), torch.zeros(8)
    fns = kernel._check_epilogue
    shape = (1, 6, 6, 8)
    with pytest.raises(ValueError):  # scale of the wrong length
        fns(x, w, torch.ones(4), bias, 0.1, None, None, shape)
    with pytest.raises(ValueError):  # f64 bias
        fns(x, w, scale, bias.double(), 0.1, None, None, shape)
    with pytest.raises(ValueError):  # the f32 output takes no residual
        fns(x, w, scale, bias, None, torch.zeros(shape), None, shape)
    with pytest.raises(ValueError):  # a residual of another shape
        fns(x, w, scale, bias, 0.1, torch.zeros(1, 6, 6, 4), None, shape)
    with pytest.raises(TypeError):  # f16 dequantised output
        fns(x, w, scale, bias, 0.1, None, torch.float16, shape)
    with pytest.raises(ValueError):
        fns(x, w, scale, bias, 0.0, None, None, shape)
    fns(x, w, scale, bias, 0.1, torch.zeros(shape, dtype=torch.int8), torch.bfloat16, shape)
