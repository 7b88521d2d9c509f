"""Data-parallel training of the port on the CPU: two gloo ranks (child
processes, tests/torch_ddp_worker.py) each take their two rows of a global
batch of 4 through the ``Trainer`` under DDP with ``sync_bn=True``, held
against the JAX package's single-device step on the whole batch, at the
port's conditioned train-step case (tests/test_torch_train.py: reduced
depth, 32x32, weights seed 48, batch seed 22); dropout off and the fused
loss on both sides.  Per-rank statistics (``sync_bn=False``):
tests/test_torch_ddp_groups.py.

Tolerances, as tests/test_torch_train.py holds the one-process step: loss
1e-5 relative; each gradient tensor (the ranks' averaged gradient, before
Adam) 1e-4 max-norm relative; BN running statistics 1e-5 (STAT_TOL's
exceptions 3e-5); each parameter after Adam's first update within
2 lr + 1e-6 of JAX's.  The two ranks' parameters and buffers are bit-equal
after the step.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np

from test_torch_train import GRAD_BATCH, GRAD_SEED, GRAD_SIZE, LR, REDUCED, STAT_TOL, _batch, _jax_state, _specs
from torch_parity import ComposedUniPose, init_composed, max_rel_err, run_ranks
from torch_parity import two_threads_for_the_module  # noqa: F401
from unipose_tpu.compat.torch_export import export_state_dict
from unipose_tpu.train import steps as jax_steps
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax


def run_two_ranks(tmp, variables, batch, modes):
    """Two ranks, one Trainer step for each ``sync_bn`` of ``modes`` from
    the JAX ``variables`` on the global ``batch``: {sync_bn: [rank 0's
    results, rank 1's]}."""
    np.savez(tmp / "weights.npz", **{k: v.numpy() for k, v in state_dict_from_jax(variables).items()})
    np.savez(tmp / "batch.npz", **batch)
    spec = {"batch": str(tmp / "batch.npz"), "weights": str(tmp / "weights.npz"), "variant": "image",
            "layers": list(REDUCED), "size": GRAD_SIZE, "lr": LR, "dropout": False,
            "modes": list(modes), "device": "cpu"}
    results = run_ranks("step", spec, tmp)
    return {m: [r[str(m)] for r in results] for m in modes}


def assert_matches_jax_step(variables, batch, got, bn_groups, monkeypatch):
    """The two ranks' step (``got``) against JAX's single-device step on
    the whole batch, with ``bn_groups`` statistics groups; the ranks
    bit-equal."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
    jmodel = ComposedUniPose(layers=REDUCED, bn_groups=bn_groups)
    jspec = dataclasses.replace(_specs()[1], input_size=GRAD_SIZE)
    tx, jstate = _jax_state(variables)
    jstate, jmetrics = jax_steps.make_train_step(jmodel, tx, jspec, donate=False, fused_loss=True)(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch))

    # the two ranks: one loss, the same bits everywhere
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["fingerprint"] == got[1]["fingerprint"]
    for k in ("grads", "stats", "params"):
        for name, v in got[0][k].items():
            assert (v == got[1][k][name]).all(), (k, name)

    np.testing.assert_allclose(got[0]["loss"], float(jmetrics["loss"]), rtol=1e-5)
    want = state_dict_from_jax({"params": jstate.opt_state[0]})
    assert sorted(got[0]["grads"]) == sorted(want)
    for name, g in got[0]["grads"].items():
        assert max_rel_err(g.numpy(), want[name].numpy()) < 1e-4, name
    want_stats = state_dict_from_jax({"batch_stats": jstate.batch_stats})
    for name, v in got[0]["stats"].items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name
        else:
            assert max_rel_err(v.numpy(), want_stats[name].numpy()) < STAT_TOL.get(name, 1e-5), name
    jparams = export_state_dict({"params": jstate.params})
    for name, p in got[0]["params"].items():
        assert np.abs(p.numpy() - jparams[name]).max() <= 2 * LR + 1e-6, name


def test_two_ranks_with_global_statistics_match_the_jax_step(tmp_path, monkeypatch):
    variables = init_composed(ComposedUniPose(layers=REDUCED), seed=GRAD_SEED)
    batch = _batch(22, b=GRAD_BATCH, size=GRAD_SIZE)
    got = run_two_ranks(tmp_path, variables, batch, [True])[True]
    assert_matches_jax_step(variables, batch, got, 1, monkeypatch)
