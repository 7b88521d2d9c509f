"""Readings of the train step's conditioning on the CPU, behind the case
that tests/test_torch_train.py holds its parity at.

    JAX_PLATFORMS=cpu python tests/torch_conditioning.py --size 32 --batch 4 --seeds 31-74
    JAX_PLATFORMS=cpu python tests/torch_conditioning.py --size 64 --batch 2 --seeds 48
    JAX_PLATFORMS=cpu python tests/torch_conditioning.py --video --size 32 --batch 2 --frames 3 --seeds 0-7

For each weights seed (the reduced-depth model of the tests, dropout off,
materialised targets, 8 torch threads) it prints one JSON line: the worst
gradient tensor of the port's f32 step against its own f64 twin and against
JAX's f32 step, how many tensors miss 1e-4 against JAX, and every BN
statistic that lies more than 1e-5 from another reading (port against JAX,
port against f64, JAX against f64).  ``--video``: the same readings for the
UniPose-LSTM's video step (tests/test_torch_video_train.py's model, clips of
``--frames`` frames).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_train as T  # noqa: E402
from torch_parity import ComposedUniPose, init_composed, max_rel_err  # noqa: E402
from unipose_tpu.train import steps as jax_steps  # noqa: E402
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax  # noqa: E402
from unipose_tpu_torch.train import steps  # noqa: E402


def reading(size: int, batch_size: int, seed: int) -> dict:
    spec, jspec = (dataclasses.replace(s, input_size=size) for s in T._specs())
    jmodel = ComposedUniPose(layers=T.REDUCED)
    variables = init_composed(jmodel, seed=seed)
    batch = T._batch(22, b=batch_size, size=size)
    state = T._port_state(variables)
    steps.make_train_step(state.model, state.optimizer, spec)(state, T._torch_batch(batch))
    grads64, stats64 = T._float64_twin(variables, batch, spec)
    tx, jstate = T._jax_state(variables)
    jstate, _ = jax_steps.make_train_step(jmodel, tx, jspec, donate=False)(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch)
    )
    jgrads = state_dict_from_jax({"params": jstate.opt_state[0]})
    jstats = state_dict_from_jax({"batch_stats": jstate.batch_stats})
    named = dict(state.model.named_parameters())
    vs64 = {n: max_rel_err(p.grad.numpy(), grads64[n]) for n, p in named.items()}
    vsjax = {n: max_rel_err(p.grad.numpy(), jgrads[n].numpy()) for n, p in named.items()}
    stats = {}
    for n, v in T._stats(state).items():
        r = (max_rel_err(v.numpy(), jstats[n].numpy()), max_rel_err(v.numpy(), stats64[n].numpy()),
             max_rel_err(jstats[n].numpy(), stats64[n].numpy()))
        if max(r) > 1e-5:
            stats[n] = {"port_vs_jax": r[0], "port_vs_f64": r[1], "jax_vs_f64": r[2]}
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])  # noqa: E731
    return {"size": size, "batch": batch_size, "seed": seed,
            "grad_port_vs_f64": worst(vs64), "grad_port_vs_jax": worst(vsjax),
            "tensors_over_1e-4_vs_jax": sum(v >= 1e-4 for v in vsjax.values()),
            "stats_over_1e-5": stats}


def video_reading(size: int, batch_size: int, frames: int, seed: int) -> dict:
    import test_torch_video_train as V
    from torch_parity import reduced_lstm_depth

    spec, jspec = V.specs(size)
    with reduced_lstm_depth(V.REDUCED):
        jmodel, variables = V.jax_variables(seed)
        batch = V.clip_batch(11, batch_size, frames, size)
        state = V.port_state(variables)
        steps.make_train_step(state.model, state.optimizer, spec, video=True)(state, V.torch_batch(batch))
        grads64, stats64 = V.float64_twin(variables, batch, spec)
        _, jgrads, jstats = V.jax_step(jmodel, variables, batch, jspec)
    named = dict(state.model.named_parameters())
    vs64 = {n: max_rel_err(p.grad.numpy(), grads64[n]) for n, p in named.items()}
    vsjax = {n: max_rel_err(p.grad.numpy(), jgrads[n].numpy()) for n, p in named.items()}
    jaxvs64 = {n: max_rel_err(jgrads[n].numpy(), grads64[n]) for n in named}
    stats = {}
    for n, v in T._stats(state).items():
        r = (max_rel_err(v.numpy(), jstats[n].numpy()), max_rel_err(v.numpy(), stats64[n]),
             max_rel_err(jstats[n].numpy(), stats64[n]))
        if max(r) > 1e-5:
            stats[n] = {"port_vs_jax": r[0], "port_vs_f64": r[1], "jax_vs_f64": r[2]}
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])  # noqa: E731
    return {"video": True, "size": size, "batch": batch_size, "frames": frames, "seed": seed,
            "grad_port_vs_f64": worst(vs64), "grad_port_vs_jax": worst(vsjax),
            "grad_jax_vs_f64": worst(jaxvs64),
            "tensors_over_1e-4_vs_jax": sum(v >= 1e-4 for v in vsjax.values()),
            "stats_over_1e-5": stats}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=T.GRAD_SIZE)
    ap.add_argument("--batch", type=int, default=T.GRAD_BATCH)
    ap.add_argument("--seeds", default=str(T.GRAD_SEED), help="one seed, or first-last")
    ap.add_argument("--video", action="store_true", help="the UniPose-LSTM's video step")
    ap.add_argument("--frames", type=int, default=3, help="frames a clip (--video)")
    args = ap.parse_args()
    first, _, last = args.seeds.partition("-")
    flax.linen.Dropout.__call__ = lambda self, x, *a, **kw: x
    torch.set_num_threads(8)
    for seed in range(int(first), int(last or first) + 1):
        if args.video:
            print(json.dumps(video_reading(args.size, args.batch, args.frames, seed)), flush=True)
        else:
            print(json.dumps(reading(args.size, args.batch, seed)), flush=True)


if __name__ == "__main__":
    main()
