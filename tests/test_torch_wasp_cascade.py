"""The port's fused WASP (fold + plain version + wrapper) against the JAX
Pallas kernel in interpret mode and the linen WASP module, on the same
seeded weights and inputs.  The CUDA kernel itself is held against the
plain version by tests/test_torch_kernels_cuda.py (on a card) and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import max_rel_err, perturb_bn
from unipose_tpu.models.wasp import WASP as JaxWASP
from unipose_tpu.ops.pallas.wasp_cascade import fold_wasp_params as jax_fold
from unipose_tpu.ops.pallas.wasp_cascade import wasp_cascade as jax_cascade
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.models.wasp import WASP
from unipose_tpu_torch.ops.kernels import wasp_cascade as port_kernel

DILATIONS = {16: (18, 12, 6), 8: (36, 24, 12)}


def _pair(output_stride, gap_bn, seed, dropout_rate=0.5):
    """A JAX WASP and the port's WASP carrying the same perturbed weights."""
    jwasp = JaxWASP(
        output_stride=output_stride, gap_batchnorm=gap_bn, dropout_rate=dropout_rate
    )
    variables = jwasp.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 4, 4, 2048)), train=False
    )
    variables = perturb_bn(variables, seed + 1)
    pwasp = WASP(output_stride=output_stride, gap_batchnorm=gap_bn, dropout_rate=dropout_rate)
    pwasp.load_state_dict(state_dict_from_jax(variables))
    return jwasp, variables, pwasp.eval()


def _input(b, s, seed):
    return (np.random.RandomState(seed).randn(b, s, s, 2048) * 0.1).astype(np.float32)


@pytest.mark.parametrize("gap_bn", [True, False])
def test_fold_matches_jax(gap_bn):
    _, variables, pwasp = _pair(16, gap_bn, seed=0)
    want = jax_fold(
        variables["params"], variables["batch_stats"], gap_batchnorm=gap_bn
    )
    got = port_kernel.fold_wasp_params(pwasp)
    assert set(got) == set(want)
    for k in want:
        # the same f32 arithmetic (w2 @ w2 sums 256 products in another order)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


# (batch, S, output stride, gap_batchnorm): S=23 at OS16 uses all 9 taps of
# dilation 18; S=8 skips the taps of 18 and 12 that fall in the padding;
# S=46 at OS8 is the output-stride-8 map with dilations (36, 24, 12).
CASES = [(2, 23, 16, True), (2, 23, 16, False), (1, 8, 16, True), (1, 46, 8, True)]


@pytest.mark.parametrize("b,s,os_,gap_bn", CASES)
def test_plain_matches_pallas_interpret_and_linen(b, s, os_, gap_bn):
    jwasp, variables, pwasp = _pair(os_, gap_bn, seed=s + b)
    x = _input(b, s, seed=s)
    folded_j = jax_fold(
        variables["params"], variables["batch_stats"], gap_batchnorm=gap_bn
    )
    want_kernel = np.asarray(
        jax_cascade(jnp.asarray(x), folded_j, dilations=DILATIONS[os_], interpret=True)
    )
    want_linen = np.asarray(jwasp.apply(variables, jnp.asarray(x), train=False))

    xt = torch.from_numpy(x)
    folded = port_kernel.fold_wasp_params(pwasp)
    got = port_kernel.wasp_cascade(xt, folded, DILATIONS[os_]).numpy()
    # f32 throughout; the sums differ from JAX's only in order
    assert max_rel_err(got, want_kernel) < 1e-4
    assert max_rel_err(got, want_linen) < 1e-4

    # the module's eval forward goes through the same function (NCHW view)
    with torch.no_grad():
        got_module = pwasp(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_module, got)


def test_train_mode_matches_linen():
    """Train mode runs the unfused modules: batch statistics, updated
    running statistics, conv2 twice (dropout off on both sides, since the
    two frameworks' random streams differ)."""
    jwasp, variables, pwasp = _pair(16, True, seed=7, dropout_rate=0.0)
    x = _input(2, 8, seed=8)
    want, updates = jwasp.apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"]
    )
    pwasp.train()
    with torch.no_grad():
        got = pwasp(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert max_rel_err(got.numpy(), np.asarray(want)) < 1e-4
    stats = jax.device_get(updates["batch_stats"])
    np.testing.assert_allclose(
        pwasp.bn1.running_var.numpy(), stats["bn1"]["running_var"], rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        pwasp.aspp3.bn.running_mean.numpy(), stats["aspp3"]["bn"]["running_mean"],
        rtol=1e-4, atol=1e-6,
    )


def test_folded_weights_follow_weight_changes():
    """The eval forward refolds after a weight changes in place."""
    _, _, pwasp = _pair(16, True, seed=3)
    x = torch.from_numpy(_input(1, 8, seed=4)).permute(0, 3, 1, 2)
    with torch.no_grad():
        before = pwasp(x)
        pwasp.bn1.running_mean.add_(0.5)
        after = pwasp(x)
        fresh = port_kernel.wasp_cascade(
            x.permute(0, 2, 3, 1).contiguous(),
            port_kernel.fold_wasp_params(pwasp),
            pwasp.dilations[1:],
        ).permute(0, 3, 1, 2)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    _, _, pwasp = _pair(16, True, seed=5)
    x = torch.from_numpy(_input(1, 8, seed=6))
    folded = port_kernel.fold_wasp_params(pwasp)
    before = port_kernel.wasp_cascade.launches
    got = port_kernel.wasp_cascade(x, folded)
    assert port_kernel.wasp_cascade.launches == before
    torch.testing.assert_close(got, port_kernel.wasp_cascade_reference(x, folded), rtol=0, atol=0)


def test_wrapper_checks_reject_bad_inputs():
    _, _, pwasp = _pair(16, True, seed=9)
    folded = port_kernel.fold_wasp_params(pwasp)
    good = torch.zeros(1, 8, 8, 2048)
    port_kernel._check(good, folded, (18, 12, 6))
    bad_inputs = [
        (torch.zeros(1, 8, 7, 2048), ValueError),  # not square
        (torch.zeros(1, 8, 8, 1024), ValueError),  # wrong width
        (torch.zeros(1, 8, 8, 2048, dtype=torch.float16), TypeError),
        (torch.zeros(1, 2048, 8, 8).permute(0, 2, 3, 1), ValueError),  # not contiguous
    ]
    for x, err in bad_inputs:
        with pytest.raises(err):
            port_kernel._check(x, folded, (18, 12, 6))
    with pytest.raises(ValueError):
        port_kernel._check(good, folded, (18, 0, 6))
    with pytest.raises(ValueError):
        port_kernel._check(good, {**folded, "wc": folded["wc"][:1024]}, (18, 12, 6))
