"""One rank of a data- or time-parallel run of unipose_tpu_torch, started as
a child process by the tests (tests/test_torch_sync_bn.py,
test_torch_ddp*.py, test_torch_cp_ranks.py) and by chip_smoke.py's
``ddp_step_check`` and ``cp_step_check``; pytest does not collect it, and it
imports neither jax nor the JAX package.

    python tests/torch_ddp_worker.py bn SPEC.json      # TorchBatchNorm across ranks
    python tests/torch_ddp_worker.py step SPEC.json    # Trainer steps under DDP
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/torch_ddp_worker.py cli [--layers 1,1,1,1] -- <cli/train.py arguments>

``bn`` and ``step`` read the rank from ``RANK`` and the world from
``WORLD_SIZE`` (the caller sets both) and rendezvous at ``SPEC["init"]``
(a ``file://`` path: no port is picked).  Each writes its results to
``<SPEC["out"]>.rank<r>.pt`` (CPU tensors, ``torch.save``) and prints
``RANK_OK <r>``.

SPEC keys.  Both: ``init``, ``out``, ``device`` ("cpu" or "cuda:0"),
``backend`` (default: gloo).  ``bn``: ``x`` (an .npz with the global batch
``x`` (B, C, H, W) and the loss weights ``r``), ``sync`` (bool).  ``step``:
``batch`` (an .npz holding the global batch), ``variant`` ("image"/"lstm"),
``layers`` (null: full depth), ``size`` (input side), ``weights`` (an .npz
``state_dict``, or null: the init of ``seed``), ``seed``, ``lr``,
``dropout`` (false: every Dropout's p set to 0), ``modes`` (a list of
``sync_bn`` values, one Trainer each), ``timed_steps`` (steps timed after
the checked one, on the card), ``tf32`` (false turns TF32 off),
``dtypes`` (default ["float32"]; "float64" runs the network in f64, the
loss staying f32),
``tensor_ranks`` (the ranks that write their gradients and parameters;
default every rank; the others write the loss, the BN statistics, the
fingerprint and the launch counts), ``mesh`` ([n_data, n_time]: time
parallelism, the video model with ``spmd_axes`` on a ("data", "time")
mesh, ``frame_memory`` the batch's T; each rank writes its block's
results).  A mode may also be a dict, whose results are under its
``name``: ``{"name", "kind": "step", "dtype", "dropout", "remat", "grads"}``
(one ``sync_bn=True`` step; ``remat``: ``remat_tower`` and ``remat_scan``
on; ``grads`` (default true): the tensor ranks write their gradients, never
their parameters) or
``{"name", "kind": "eval"}`` (f32 eval heatmaps of the rank's block, NHWC,
``heat``; and ``chunks``: the clip in two halves, the ConvLSTM state
carried from the first to the second).  A step also writes ``gathers``,
the forward calls of ``gather_frames``.

``cli`` runs ``cli/train.main`` on the arguments after ``--`` (the backbone
cut to ``--layers``), then prints ``FINGERPRINT <rank> <sha256>`` of the
trainer's parameters and buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _join(spec):
    from unipose_tpu_torch.parallel.mesh import maybe_init_distributed

    return maybe_init_distributed(spec.get("device", "cpu"), backend=spec.get("backend", "gloo"),
                                  init_method=spec["init"])


def _rank_world():
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


def run_bn(spec) -> dict:
    """The rank's rows of ``x`` through a ``TorchBatchNorm`` whose
    statistics span the ranks; loss ``sum(y * r)`` over the rank's rows."""
    import torch.distributed as dist

    from unipose_tpu_torch.models.layers import TorchBatchNorm, set_bn_process_group

    dev = _join(spec)
    rank, world = _rank_world()
    data = np.load(spec["x"])
    b = data["x"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    x = torch.from_numpy(data["x"][rows]).to(dev).requires_grad_(True)
    r = torch.from_numpy(data["r"][rows]).to(dev)
    bn = TorchBatchNorm(x.shape[1]).to(dev).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["weight"]))
        bn.bias.copy_(torch.from_numpy(data["bias"]))
    set_bn_process_group(bn, dist.group.WORLD, sync=spec["sync"])
    y = bn(x)
    (y * r).sum().backward()
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(),
            "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu(),
            "num_batches_tracked": bn.num_batches_tracked.cpu()}


class OneBatch:
    """A train loader of one global batch (the loader protocol)."""

    def __init__(self, batch):
        self.batch = batch
        self.batch_size = len(next(iter(batch.values())))

    def __len__(self):
        return 1

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        yield {k: v.copy() for k, v in self.batch.items()}


def _trainer(spec, batch, sync_bn: bool, dtype, dev, dropout: bool = True, remat: bool = False):
    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch.models.layers import Dropout
    from unipose_tpu_torch.models.unipose import FULL_DEPTH, init_model
    from unipose_tpu_torch.train import state as train_state
    from unipose_tpu_torch.train.trainer import Trainer

    video = spec["variant"] == "lstm"
    dataset = "Penn_Action" if video else "LSP"
    ds = DATASETS[dataset]
    data_spec = dataclasses.replace(ds, input_size=spec["size"])
    mc = ModelConfig(dataset=dataset, num_classes=ds.num_joints, variant=spec["variant"],
                     sync_bn=sync_bn, remat_tower=remat, remat_scan=remat)
    tc = TrainConfig(batch_size=len(batch["kpts"]), lr=spec.get("lr", 1e-4), seed=spec.get("seed", 0),
                     sigma=ds.sigma, model_name="", mesh_shape=(-1,))
    if spec.get("mesh"):
        mc = dataclasses.replace(mc, spmd_axes=("data", "time"), frame_memory=batch["frames"].shape[1])
        tc = dataclasses.replace(tc, mesh_shape=tuple(spec["mesh"]), mesh_axes=("data", "time"))
    layers = tuple(spec["layers"]) if spec.get("layers") else FULL_DEPTH
    if dtype == torch.float64:  # the whole network in f64 (the loss stays f32)
        train_state.init_model = lambda *a, **k: init_model(*a, layers=layers, **k).double()
        mc = dataclasses.replace(mc, compute_dtype=torch.float64)
    else:
        train_state.init_model = functools.partial(init_model, layers=layers)
    trainer = Trainer(mc, tc, spec=data_spec, loaders=(OneBatch(batch), None), log_every=1,
                      device=dev)
    if spec.get("weights"):
        w = np.load(spec["weights"])
        trainer.model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    if not dropout:
        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return trainer


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy (never an alias: the timed steps change the live ones)."""
    return t.detach().to("cpu", copy=True)


def run_step(spec) -> dict:
    """Per dtype and mode: a Trainer under DDP takes one step on the global
    batch; the loss, the gradients before Adam, the BN statistics after the
    step, the parameters and buffers' fingerprint and the launch counts;
    then, in f32, ``timed_steps`` steps timed.  Results by ``str(sync_bn)``
    (f32) or ``f"{sync_bn}:{dtype}"``."""
    if not spec.get("tf32", True):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = _join(spec)
    batch = dict(np.load(spec["batch"]))
    out = {}
    for dtype_name in spec.get("dtypes", ["float32"]):
        dtype = getattr(torch, dtype_name)
        for sync_bn in (m for m in spec["modes"] if not isinstance(m, dict)):
            key = str(sync_bn) if dtype == torch.float32 else f"{sync_bn}:{dtype_name}"
            out[key] = _step(spec, batch, sync_bn, dtype, dev, spec.get("dropout", True))
    for mode in (m for m in spec["modes"] if isinstance(m, dict)):
        if mode["kind"] == "eval":
            out[mode["name"]] = _eval(spec, batch, dev)
        else:
            out[mode["name"]] = _step(spec, batch, True, getattr(torch, mode["dtype"]), dev,
                                      mode.get("dropout", True), mode.get("remat", False),
                                      ("grads",) if mode.get("grads", True) else ())
    return out


def _eval(spec, batch, dev) -> dict:
    """The rank's block of the clips through the eval forward under the
    mesh: the whole clip, then its two halves with the state carried."""
    from unipose_tpu_torch.parallel.cp import shard_clip_batch, under_mesh
    from unipose_tpu_torch.train.steps import forward_video_nhwc

    trainer = _trainer(spec, batch, True, torch.float32, dev)
    model = trainer.model.eval()

    @torch.no_grad()
    def forward(part, state=None):
        block = trainer._upload(shard_clip_batch(part, trainer.mesh))
        return under_mesh(trainer.mesh, forward_video_nhwc)(
            model, block["frames"], block["centers"], trainer.spec, state)

    heat, _ = forward(batch)
    half = batch["frames"].shape[1] // 2
    first, state = forward({k: v[:, :half] for k, v in batch.items()})
    second, _ = forward({k: v[:, half:] for k, v in batch.items()}, state)
    return {"heat": _host(heat), "chunks": [_host(first), _host(second)]}


def _step(spec, batch, sync_bn: bool, dtype, dev, dropout: bool = True, remat: bool = False,
          tensors=("grads", "params")) -> dict:
    from unipose_tpu_torch.ops import kernels
    from unipose_tpu_torch.parallel import cp
    from unipose_tpu_torch.parallel.mesh import fingerprint

    rank, world = _rank_world()
    trainer = _trainer(spec, batch, sync_bn, dtype, dev, dropout, remat)
    kernels.reset_launches()
    cp.gathers["gather_frames"] = 0
    loss = trainer.training(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model = trainer.model
    res = {"loss": loss, "launches": kernels.launch_counts(), "gathers": cp.gathers["gather_frames"],
           "fingerprint": fingerprint(model).hex(),
           "stats": {k: _host(v) for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}}
    if rank in spec.get("tensor_ranks", range(world)):
        if "grads" in tensors:
            res["grads"] = {n: _host(p.grad) for n, p in model.named_parameters()}
        if "params" in tensors:
            res["params"] = {n: _host(p) for n, p in model.named_parameters()}
    if spec.get("timed_steps") and dtype == torch.float32:
        db = trainer._device_batch(batch)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
        times = []
        for _ in range(spec["timed_steps"] + 1):  # the first warms up
            sync(dev)
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, db)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        res["step_ms"] = times[1:]
    return res


def run_cli(argv) -> None:
    from unipose_tpu_torch.cli import train as cli_train
    from unipose_tpu_torch.models.unipose import init_model
    from unipose_tpu_torch.parallel.mesh import fingerprint
    from unipose_tpu_torch.train import state as train_state

    if argv and argv[0] == "--layers":
        layers = tuple(int(v) for v in argv[1].split(","))
        train_state.init_model = functools.partial(init_model, layers=layers)
        argv = argv[2:]
    if argv and argv[0] == "--":
        argv = argv[1:]
    trainer = cli_train.main(argv)
    print(f"FINGERPRINT {os.environ.get('RANK', '0')} {fingerprint(trainer.model).hex()}", flush=True)


def main() -> None:
    mode = sys.argv[1]
    if mode == "cli":
        run_cli(sys.argv[2:])
        return
    with open(sys.argv[2]) as f:
        spec = json.load(f)
    result = {"bn": run_bn, "step": run_step}[mode](spec)
    rank, _ = _rank_world()
    torch.save(result, f"{spec['out']}.rank{rank}.pt")
    from unipose_tpu_torch.parallel.mesh import shutdown_distributed

    shutdown_distributed()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
