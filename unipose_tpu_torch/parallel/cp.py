"""Time (sequence) parallelism for the video model: one clip's frames over
a ``time`` axis of ranks, clips over ``data``.

Counterpart of ``unipose_tpu/parallel/cp.py``.  There one program runs on
a (data, time) mesh of devices and GSPMD places the collectives that the
model's sharding constraints call for.  Here each rank is a process (as in
``parallel/mesh.py``): rank r sits at (r // n_time, r % n_time), ``time``
the minor axis as in JAX, and holds its clips' frames (``shard_clip_batch``).
The model (``models/unipose_lstm.py``, ``ModelConfig.spmd_axes``) runs the
tower (backbone, WASP, decoder: ~99% of the FLOPs) on the rank's frames,
gathers the per-frame features of its clips over the time axis
(``gather_frames``, the smallest tensor of the program), runs the ConvLSTM
over every frame of the clip on each rank of the axis, and the head on the
rank's frames again.  The BatchNorms take their moments over every rank
(``sync_bn=True``), as GSPMD's over B*T; DDP averages the gradients.

Usage, one process a rank under ``torch.distributed.run``::

    mesh = make_video_mesh(n_data=2, n_time=4)       # every rank, once
    step = under_mesh(mesh, make_train_step(ddp_model, optimizer, spec,
                                            video=True, time_shards=4))
    step(state, shard_clip_batch(batch, mesh))
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from unipose_tpu_torch.parallel.mesh import Mesh, local_shard, make_mesh

# Leaf names of (B, T, ...) per-frame clip tensors: dim 1 is time and is
# cut over the 'time' axis.  Any other array leaf is per clip and is cut
# over 'data' only (a (B, K, 3) leaf's K must never go over 'time').
CLIP_LEAVES = frozenset({"frames", "kpts", "centers"})

# process groups of the time axes, by (default group, mesh shape): made
# once, every rank making every group in the same order
_TIME_GROUPS = {}
_bound = {"mesh": None}  # the mesh that under_mesh binds for a call

# forward calls of gather_frames (the chip check reads them a step)
gathers = {"gather_frames": 0}


def make_video_mesh(n_data: int = 1, n_time: int = -1, world: Optional[int] = None,
                    rank: Optional[int] = None) -> Mesh:
    """The (data, time) mesh over the ranks; one ``-1`` takes what the other
    axis leaves of the world.  Under a process group with ``n_time`` > 1 it
    also makes the time axes' process groups: ``dist.new_group`` is
    collective, so every rank makes every group, in data order, here."""
    mesh = make_mesh((n_data, n_time), ("data", "time"), world=world, rank=rank)
    if mesh.distributed and mesh.axis_size("time") > 1:
        import torch.distributed as dist

        key = (dist.group.WORLD, mesh.shape)
        if key not in _TIME_GROUPS:
            n_d, n_t = mesh.shape
            _TIME_GROUPS[key] = [dist.new_group(list(range(d * n_t, (d + 1) * n_t)))
                                 for d in range(n_d)]
    return mesh


def time_group(mesh: Mesh):
    """The process group of this rank's time axis: None when the axis has
    one rank or no process group is up.  The mesh must come from
    :func:`make_video_mesh`, which made the groups."""
    if not mesh.distributed or mesh.axis_size("time") == 1:
        return None
    import torch.distributed as dist

    groups = _TIME_GROUPS.get((dist.group.WORLD, mesh.shape))
    if groups is None:
        raise ValueError(f"no time groups for the mesh {mesh.shape}: build it with make_video_mesh")
    return groups[mesh.coordinate("data")]


def clip_sharding(mesh: Mesh, b: int, t: int):
    """This rank's (clip slice, frame slice) of a (B, T, ...) leaf, the
    counterpart of JAX's ``NamedSharding(mesh, P("data", "time"))``.  A B
    that the data axis does not divide raises, as a T that the time axis
    does not divide."""
    return _block(mesh, "data", b, "clip"), _block(mesh, "time", t, "frame")


def _block(mesh: Mesh, axis: str, n: int, what: str) -> slice:
    size = mesh.axis_size(axis)
    if n % size:
        raise ValueError(f"{what} count {n} is not divisible by the {axis!r} axis ({size})")
    k = n // size
    i = mesh.coordinate(axis)
    return slice(i * k, (i + 1) * k)


def shard_clip_batch(batch, mesh: Mesh):
    """This rank's block of a video batch (a dict, nested dicts walked):
    a leaf of ``CLIP_LEAVES`` with ndim >= 2 gets its (clip, frame) block;
    any other array leaf (numpy or torch) is cut on its leading axis over
    'data' only; anything else passes through.  A batch that a loader
    sharded over 'data' (marked ``"shard"``, ``parallel/mesh.py::
    local_shard``) holds this rank's clips already: only its frames are
    cut, as JAX's ``put_sharded`` takes a process's local clips."""
    local = isinstance(batch, dict) and local_shard(batch, mesh) is not None

    def clips_of(n):
        return slice(None) if local else _block(mesh, "data", n, "clip")

    def put(name, x):
        if isinstance(x, dict):
            return {k: put(k, v) for k, v in x.items()}
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim < 1:
            return x
        if name in CLIP_LEAVES and x.ndim >= 2:
            return x[clips_of(x.shape[0]), _block(mesh, "time", x.shape[1], "frame")]
        return x[clips_of(x.shape[0])]

    return put(None, batch)


class _GatherFrames(torch.autograd.Function):
    """All-gather of (b, t_loc, ...) blocks along the frame axis; the
    backward sums the cotangent over the group and keeps this rank's
    block (an all-reduce and a slice: gloo and NCCL both have them)."""

    @staticmethod
    def forward(ctx, z, group):
        import torch.distributed as dist

        ctx.group = group
        ctx.t = z.shape[1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(z) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, z.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)  # reduced in place
        dist.all_reduce(grad, group=ctx.group)
        return grad[:, ctx.index * ctx.t:(ctx.index + 1) * ctx.t], None


def gather_frames(z: torch.Tensor, group) -> torch.Tensor:
    """(b, t_loc, ...) -> (b, t_loc * n, ...): every rank's frames of the
    group in rank (time) order, under autograd; each rank's block gets the
    sum of every rank's cotangent for it.  With no group (one rank) the
    input itself."""
    if group is None:
        return z
    gathers["gather_frames"] += 1
    return _GatherFrames.apply(z, group)


def bound_mesh() -> Optional[Mesh]:
    """The mesh that :func:`under_mesh` binds for the running call, or None."""
    return _bound["mesh"]


def under_mesh(mesh: Mesh, fn):
    """Wrap ``fn`` so that every call runs with ``mesh`` bound: a model with
    ``spmd_axes`` then splits its clips over the mesh's time axis (its
    frames are this rank's, its features are gathered over
    :func:`time_group`).  In JAX the wrapper is ``jax.set_mesh``, the
    context that the model's sharding constraints need while they trace;
    here the binding is read at every call, and outside it a model with
    ``spmd_axes`` runs the clips it is handed whole, as one process does,
    except in training, where it raises.  The ``Trainer`` wraps its train
    and validation steps (JAX trainer.py:160-164)."""

    def wrapped(*args, **kwargs):
        prev, _bound["mesh"] = _bound["mesh"], mesh
        try:
            return fn(*args, **kwargs)
        finally:
            _bound["mesh"] = prev

    return wrapped
