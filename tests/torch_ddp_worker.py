"""One rank of a data- or time-parallel run of unipose_tpu_torch, started as
a child process by the tests (tests/test_torch_sync_bn.py,
test_torch_ddp*.py, test_torch_cp_ranks.py, test_torch_sharded_val.py) and
by chip_smoke.py's ``ddp_step_check``, ``cp_step_check`` and
``sharded_val``; pytest does not collect it, and it imports neither jax nor
the JAX package.

    python tests/torch_ddp_worker.py bn SPEC.json      # TorchBatchNorm across ranks
    python tests/torch_ddp_worker.py step SPEC.json    # Trainer steps under DDP
    python tests/torch_ddp_worker.py val SPEC.json     # sharded validation from files
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/torch_ddp_worker.py cli [--layers 1,1,1,1] -- <cli/train.py arguments>

``bn``, ``step`` and ``val`` read the rank from ``RANK`` and the world from
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
carried from the first to the second) or ``{"name", "kind": "val"}``
(``Trainer.validation`` on the global batch as its one validation batch,
f32, cuDNN's deterministic algorithms: ``_validate``'s results).  A step also writes ``gathers``, the
forward calls of ``gather_frames``.

``val``: ``cases``, a list of ``{"name", "variant", "val_dir", "val_batch",
"size", "layers", "weights", "sigma", "mesh", "frame_memory", "repeats"}``
(``mesh`` null: the data axis over every rank); each builds a ``Trainer``
on ``val_dir`` (its loader sharded by the Trainer), reads every batch of
its validation loader once (``rows``, timed), then runs ``validation``
``repeats`` times, the last one counted: the mAP, rank 0's scored
coordinates, the launch counts, the ``gather_frames`` calls and the
``all_gather`` and ``broadcast`` calls, its seconds and the model's
fingerprint.  Also ``tf32`` and ``deterministic`` (cuDNN's flag).

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


def _trainer(spec, batch, sync_bn: bool, dtype, dev, dropout: bool = True, remat: bool = False,
             validate: bool = False):
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
    trainer = Trainer(mc, tc, spec=data_spec, log_every=1, device=dev,
                      loaders=(OneBatch(batch), OneBatch(batch) if validate else None))
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
        elif mode["kind"] == "val":  # cuDNN's deterministic algorithms, as the caller's twin
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                out[mode["name"]] = _validate(_trainer(spec, batch, True, torch.float32, dev, validate=True),
                                              dev)
            finally:
                torch.backends.cudnn.deterministic = deterministic
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


def _validate(trainer, dev, repeats: int = 1) -> dict:
    """``repeats`` validations of ``trainer``, the last one counted (see
    the module docstring)."""
    import torch.distributed as dist

    from unipose_tpu_torch.ops import kernels
    from unipose_tpu_torch.parallel import cp
    from unipose_tpu_torch.parallel.mesh import fingerprint

    calls = {"all_gather": 0, "broadcast": 0}
    originals = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return call

    for _ in range(repeats - 1):
        trainer.validation(0)
    kernels.reset_launches()
    cp.gathers["gather_frames"] = 0
    for name in calls:
        setattr(dist, name, counted(name))
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mAP = trainer.validation(0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return {"mAP": mAP, "coords": trainer.val_coords, "is_best": trainer.is_best, "val_s": seconds,
            "launches": kernels.launch_counts(), "gathers": cp.gathers["gather_frames"], **calls,
            "fingerprint": fingerprint(trainer.model).hex()}


def run_val(spec) -> dict:
    """Per case: a Trainer on ``val_dir`` (module docstring), its loader's
    rows, then its validation."""
    import dataclasses as dc

    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch.models.unipose import FULL_DEPTH, init_model
    from unipose_tpu_torch.train import state as train_state
    from unipose_tpu_torch.train.trainer import _KEEP, Trainer

    if not spec.get("tf32", True):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = bool(spec.get("deterministic", False))
    dev = _join(spec)
    out = {}
    for case in spec["cases"]:
        video = case["variant"] == "lstm"
        dataset = "Penn_Action" if video else "LSP"
        ds = DATASETS[dataset]
        mc = ModelConfig(dataset=dataset, num_classes=ds.num_joints, variant=case["variant"],
                         frame_memory=case.get("frame_memory", 5))
        tc = TrainConfig(batch_size=case["val_batch"], val_batch_size=case["val_batch"],
                         sigma=case.get("sigma", ds.sigma), model_name="", seed=case.get("seed", 0))
        if case.get("mesh"):
            mc = dc.replace(mc, spmd_axes=("data", "time"))
            tc = dc.replace(tc, mesh_shape=tuple(case["mesh"]), mesh_axes=("data", "time"))
        layers = tuple(case["layers"]) if case.get("layers") else FULL_DEPTH
        train_state.init_model = functools.partial(init_model, layers=layers)
        trainer = Trainer(mc, tc, val_dir=case["val_dir"], spec=dc.replace(ds, input_size=case["size"]),
                          device=dev)
        if case.get("weights"):
            w = np.load(case["weights"])
            trainer.model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
        t0 = time.perf_counter()
        rows = [{k: b[k] for k in (*_KEEP, "global_real") if k in b} for b in trainer.val_loader]
        loader_s = time.perf_counter() - t0
        res = _validate(trainer, dev, case.get("repeats", 1))
        out[case["name"]] = {**res, "rows": rows, "loader_s": loader_s,
                             "shard": getattr(trainer.val_loader, "shard", None),
                             "loader": type(trainer.val_loader).__name__}
        del trainer
    return out


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
    result = {"bn": run_bn, "step": run_step, "val": run_val}[mode](spec)
    rank, _ = _rank_world()
    torch.save(result, f"{spec['out']}.rank{rank}.pt")
    from unipose_tpu_torch.parallel.mesh import shutdown_distributed

    shutdown_distributed()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
