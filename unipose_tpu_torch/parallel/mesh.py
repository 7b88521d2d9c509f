"""Data-parallel training over ranks: the process group, the mesh of ranks,
a rank's rows of the global batch, and the start-up check that the ranks
hold the same state.

Counterpart of ``unipose_tpu/parallel/mesh.py``.  There, one program runs
over a mesh of devices and XLA inserts the collectives (GSPMD).  Here each
rank is a process with one device, launched by ``torch.distributed.run``
(torchrun); a mesh's axes are over ranks, ranks are laid out on it in row
order, and ``DistributedDataParallel`` averages the gradients.  The global
batch is ``TrainConfig.batch_size``; a rank trains on its contiguous rows
(``shard_batch``), as a data-sharded ``jax.Array`` lays them out.

A rank's share is ``shard_of(mesh)``, its (index, count) on the data axis,
and its rows of a global batch are ``shard_rows``.  The loaders take the
same shard (``data/loader.py``, ``data/native_loader.py``) and decode only
those rows, each batch marked with its ``"shard"``: such a batch is already
local, and ``shard_batch`` passes it through, as JAX's ``put_sharded``
takes each process's local portion of the global batch (mesh.py:151-163).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

_state = {"device": None}  # this process's rank device, once initialised


def maybe_init_distributed(device=None, *, backend: Optional[str] = None,
                           init_method: str = "env://") -> Optional[torch.device]:
    """Join the process group when a launcher started this process: a no-op
    returning None unless ``WORLD_SIZE`` is set (torchrun sets it, with
    ``RANK`` and ``LOCAL_RANK``).  Decided from the environment alone: no
    process-group call is made before.  A rank on the card runs on
    ``cuda:LOCAL_RANK`` over NCCL, a CPU rank (``device="cpu"``) over gloo;
    ``backend`` overrides the choice (two ranks sharing one card must use
    gloo: NCCL refuses them).  A one-rank launch joins a group of one, so
    the data-parallel path runs as it would on more cards.  Returns the
    rank's device; safe to call more than once.
    (``init_method``: a ``file://`` path rendezvouses without a port.)"""
    if "WORLD_SIZE" not in os.environ:
        return None
    if _state["device"] is not None:
        return _state["device"]
    import torch.distributed as dist

    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    _state["device"] = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the process group that :func:`maybe_init_distributed` joined."""
    if _state["device"] is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _state["device"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks on named axes: ``shape`` over ``axis_names``, rank r at the
    row-order index r.  ``distributed``: a process group is up (then even a
    one-rank mesh trains through DDP)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def coordinate(self, name: str, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) index along axis ``name`` (0 off the
        mesh's axes)."""
        if name not in self.axis_names:
            return 0
        r = self.rank if rank is None else rank
        return int(np.unravel_index(r, self.shape)[self.axis_names.index(name)])


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",),
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """A mesh over the ranks; one -1 takes what the other axes leave of
    the world size.  ``world``/``rank`` default to the process group's (1
    and 0 without one).  As in JAX (mesh.py:84-126): a shape needing more
    ranks than there are raises, a shape whose size does not divide the
    world strands ranks and raises, an exact smaller mesh warns."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if up else 1
    if rank is None:
        rank = dist.get_rank() if up else 0
    shape = [int(s) for s in shape]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        if known > world:
            raise ValueError(f"mesh shape {tuple(shape)} needs at least {known} devices "
                             f"but only {world} are available")
        shape[shape.index(-1)] = world // known
    n = int(np.prod(shape))
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices but only "
                         f"{world} are available")
    if n < world:
        stranded = world - n
        if world % n:
            raise ValueError(f"mesh shape {tuple(shape)} uses {n} of {world} devices, "
                             f"stranding {stranded}; pick a shape whose product divides "
                             "the device count")
        warnings.warn(f"mesh shape {tuple(shape)} uses {n} of {world} devices "
                      f"({stranded} idle)", stacklevel=2)
    return Mesh(tuple(shape), tuple(axes), rank=rank, world=world, distributed=up)


def shard_of(mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """This rank's (index, count) on ``axis``: the share of every global
    batch that it loads and trains on (JAX ``batch_sharding``)."""
    return mesh.coordinate(axis), mesh.axis_size(axis)


def shard_rows(n: int, shard: Tuple[int, int], what: str = "batch") -> slice:
    """The rows of a global batch of ``n`` that ``shard`` = (i, count) owns:
    [i*n/count, (i+1)*n/count), as GSPMD lays a data-sharded array out.
    An ``n`` that ``count`` does not divide raises."""
    i, count = shard
    if n % count:
        raise ValueError(f"{what} {n} is not divisible by the data axis ({count})")
    b = n // count
    return slice(i * b, (i + 1) * b)


def local_shard(batch: dict, mesh: Mesh, axis: str = "data") -> Optional[Tuple[int, int]]:
    """The shard that a loader marked ``batch`` with (``"shard"``), None for
    a global batch; a shard that is not this rank's on ``axis`` raises."""
    marked = batch.get("shard")
    if marked is None:
        return None
    if tuple(marked) != shard_of(mesh, axis):
        raise ValueError(f"a batch loaded for shard {tuple(marked)} reached the rank at "
                         f"{shard_of(mesh, axis)} of the {axis!r} axis")
    return tuple(marked)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's contiguous rows of a global batch: for a data axis of
    size n, rows [i*B/n, (i+1)*B/n) at coordinate i (JAX mesh.py:166-179,
    where GSPMD lays a data-sharded batch out so).  Leaves without a
    leading axis pass through; a batch that n does not divide raises.  A
    batch that a sharded loader made is this rank's already and passes
    through unchanged (JAX ``put_sharded``); one made for another rank
    raises."""
    if local_shard(batch, mesh, axis) is not None:
        return batch
    shard = shard_of(mesh, axis)

    def rows(v):
        if getattr(v, "ndim", 0) < 1 or shard[1] == 1:
            return v
        return v[shard_rows(v.shape[0], shard)]

    return {k: rows(v) for k, v in batch.items()}


def fingerprint(module: nn.Module) -> bytes:
    """SHA-256 of every parameter and buffer, bit for bit, in key order."""
    h = hashlib.sha256()
    for k, t in module.state_dict().items():
        h.update(k.encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.digest()


def ranks_agree(module: nn.Module, mesh: Mesh) -> bool:
    """Whether every rank holds the same parameters and buffers, bit for
    bit (their fingerprints all-gathered)."""
    if not mesh.distributed:
        return True
    import torch.distributed as dist

    dev = next(module.parameters()).device
    mine = torch.tensor(list(fingerprint(module)), dtype=torch.uint8, device=dev)
    got = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(got, mine)
    return all(torch.equal(g, mine) for g in got)


def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Check, once at the start, that every rank holds rank 0's parameters
    and buffers bit for bit (raises if not).  ``data_parallel``'s DDP
    broadcasts rank 0's parameters as it is built; the buffers are not
    broadcast (``broadcast_buffers=False``): the seeded init, or the one
    checkpoint every rank restored, makes them equal (as in JAX's
    replicate), and a difference is a fault this check shows."""
    if mesh.distributed and not ranks_agree(module, mesh):
        raise RuntimeError("the ranks' parameters or buffers differ at the start")
    return module


def data_parallel(module: nn.Module, mesh: Mesh) -> nn.Module:
    """``module`` under ``DistributedDataParallel``: the gradients are
    averaged over the ranks in the backward.  ``broadcast_buffers=False``:
    the BatchNorms keep their running statistics equal across ranks
    themselves (``models/layers.py::TorchBatchNorm``), and a broadcast of
    rank 0's would hide a fault there."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev] if dev.type == "cuda" else None, broadcast_buffers=False
    )
