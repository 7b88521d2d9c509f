"""Training harness, image and video: init, training, validation, the demo.

Counterpart of ``unipose_tpu/train/trainer.py`` (Reference: unipose.py:
37-246 image, uniposeLSTM.py:37-270 video):
  * the dataset loaders from ``train_dir``/``val_dir`` (``get_dataloader``);
  * per-update step-decay LR (the scheduler in the train state);
  * per-epoch validation with AP/PCK/PCKh accumulated with per-joint
    visibility gating (unipose.py:163-176);
  * best-mAP checkpoint to ``<model_name>_best`` (unipose.py:183-186);
  * a checkpoint an epoch to ``checkpoint_dir``, and auto-resume from the
    newest one;
  * a TSV metric log and the parameter summary;
  * optional warm start from a reference ``*.pth.tar`` (unipose.py:78-90);
  * ``test``: one image through the model, a skeleton and per-channel
    heatmap overlays (unipose.py:197-246).

The video variant (``ModelConfig(variant="lstm")``) trains on clip batches
(``frames``, ``kpts``, ``centers``) of ``frame_memory`` frames and validates
per frame, in dataset order.

Data parallelism (JAX trainer.py:100-126, 154, 189-195, 237-252): under a
process group (``parallel/mesh.py``; ``cli/train.py`` under
``torch.distributed.run``) ``TrainConfig.batch_size`` is the global batch;
the mesh is built first, and every rank's loaders decode only its rows of
each global batch (``shard_of``: the rows ``shard_batch`` would cut, as
each process's loader yields its local portion under JAX's multi-host
``put_sharded``); loaders passed in through ``loaders=`` are global and
cut on the host.  A rank's step runs on the model under
``DistributedDataParallel``, so each rank's ``heatmap_mse`` is its rows'
mean and the averaged gradient the global batch's.  ``ModelConfig.sync_bn``
picks the BatchNorm statistics: global moments all-reduced across the ranks,
or per-rank moments with pooled running statistics (``bn_groups`` = the
data axis's size).  The dropout masks are the global batch's, each rank
keeping its rows.  Every rank validates its rows of each (padded) global
batch; the coordinates are gathered once a validation and scored on rank
0 in one process's order, which broadcasts the mAP.  Only rank 0 logs and
writes checkpoints; every rank restores.

Time parallelism (JAX trainer.py:82-115, 193, 251; ``parallel/cp.py``): a
video model with ``ModelConfig.spmd_axes`` on a ("data", "time") mesh
(``cli/train.py --time_parallel``) gets each rank's (clip, frame) block of
the global batch (``shard_clip_batch``), and its train step runs under
``cp.under_mesh``.  Every rank holds as many frames, so each rank's
``heatmap_mse`` over its frames times the clip's T, averaged by DDP, is the
global step.  The BatchNorms take their moments over every rank
(``sync_bn=True`` only), the dropout masks are the global batch's (the
rank's clips and frames).  A rank loads its data coordinate's clips whole
and cuts its frames on the host; validation runs ``under_mesh`` on every
rank's block, the ConvLSTM's input gathered over the time axis, as JAX's
(trainer.py:164).

One deliberate difference: the train step runs the fused loss
(``heatmap_mse``, the same function as the materialised MSE, whose targets
never exist in memory), where the JAX ``Trainer`` builds its step without it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from unipose_tpu_torch import resolve_device
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig, effective_spec
from unipose_tpu_torch.data.loader import get_dataloader
from unipose_tpu_torch.eval.metrics import accuracy_from_coords
from unipose_tpu_torch.eval.report import print_accuracies
from unipose_tpu_torch.models.layers import set_bn_process_group, use_dropout_generator
from unipose_tpu_torch.ops.resize import bilinear_resize
from unipose_tpu_torch.parallel.cp import make_video_mesh, shard_clip_batch, under_mesh
from unipose_tpu_torch.parallel.mesh import (
    data_parallel,
    local_shard,
    make_mesh,
    replicate,
    shard_batch,
    shard_of,
)
from unipose_tpu_torch.train.checkpoint import (
    CheckpointManager,
    save_checkpoint,
    warm_start_from_torch,
)
from unipose_tpu_torch.train.state import create_train_state
from unipose_tpu_torch.train.steps import _eval_mode, make_train_step, make_val_step, preprocess_images
from unipose_tpu_torch.utils.logger import Logger
from unipose_tpu_torch.utils.summary import count_params, per_module_params

_KEEP = ("image", "frames", "kpts", "centers")


class Trainer:
    def __init__(
        self,
        model_config: ModelConfig,
        train_config: TrainConfig,
        train_dir: Optional[str] = None,
        val_dir: Optional[str] = None,
        pretrained: Optional[str] = None,
        *,
        log_every: int = 50,
        spec=None,
        loaders=None,
        log_file: Optional[str] = None,
        print_summary: bool = False,
        device=None,
        mesh=None,
    ):
        """``spec``/``loaders`` override what derives from
        ``model_config.dataset``; ``loaders`` is (train, val[, test]) with
        the loader protocol (``__len__``, ``set_epoch``, ``__iter__`` of
        numpy batches, ``batch_size``), global batches, each rank keeping
        its rows; a loader with a ``shard`` that is not this rank's raises.
        Runs on the card unless ``device="cpu"``.  ``mesh`` overrides
        ``make_mesh(train_config.mesh_shape, train_config.mesh_axes)``,
        where the default shape (1,) stands for (-1,): the data axis over
        every rank."""
        self.model_config = model_config
        self.train_config = train_config
        # TrainConfig.sigma/stride resolve into the spec here; the loaders
        # and the steps read the spec only.
        self.spec = effective_spec(spec or DATASETS[model_config.dataset], train_config)
        self.video = model_config.variant == "lstm"
        device = resolve_device(device)
        self.log_every = log_every

        shape = tuple(train_config.mesh_shape)
        if shape == (1,):
            # the default, one process's mesh: under a launcher every rank
            # it started trains, so it is the data axis over all of them
            shape = (-1,)
        if mesh is None:
            video_mesh = tuple(train_config.mesh_axes) == ("data", "time")
            mesh = make_video_mesh(*shape) if video_mesh else make_mesh(shape, train_config.mesh_axes)
        self.mesh = mesh
        self.is_main = self.mesh.rank == 0
        if self.mesh.size != self.mesh.world:
            raise ValueError(f"the mesh {self.mesh.shape} holds {self.mesh.size} of the "
                             f"{self.mesh.world} ranks; every rank must train: set "
                             "TrainConfig.mesh_shape=(-1,)")
        # time parallelism: a model with spmd_axes needs a mesh with those
        # axes, checked before the state is built
        self.cp = self.video and model_config.spmd_axes is not None
        if self.cp:
            missing = [a for a in model_config.spmd_axes if a and a not in self.mesh.axis_names]
            if missing:
                raise ValueError(f"model_config.spmd_axes={model_config.spmd_axes} needs mesh axes "
                                 f"{missing} but the mesh has {self.mesh.axis_names}; set "
                                 "TrainConfig.mesh_shape/mesh_axes to match, e.g. "
                                 "mesh_shape=(-1, t), mesh_axes=('data', 'time')")
        n_time = self.mesh.axis_size("time")
        if (self.cp or n_time > 1) and not model_config.sync_bn:
            raise ValueError("sync_bn=False (per-shard BN) is not supported together with "
                             "sequence/context parallelism: with the frames of one clip "
                             "spread over the 'time' axis, per-device statistics would "
                             "split clips. Use sync_bn=True.")
        data = self.mesh.axis_size("data")
        if train_config.batch_size % data:
            raise ValueError(f"batch_size {train_config.batch_size} is not divisible by the "
                             f"data-parallel shard count ({data})")
        # every rank validates its rows of each global validation batch, as
        # JAX's sharded device_put lays them out (and refuses)
        if loaders is not None:
            val_batch = getattr(loaders[1], "batch_size", None)
        else:
            val_batch = train_config.val_batch_size if val_dir else None
        if val_batch and val_batch % data:
            raise ValueError(f"val_batch_size {val_batch} is not divisible by the "
                             f"data-parallel shard count ({data})")

        # the loaders decode only this rank's rows of each global batch
        shard = shard_of(self.mesh) if data > 1 else None
        if loaders is not None:
            self.train_loader, self.val_loader = loaders[0], loaders[1]
        elif train_dir or val_dir:
            self.train_loader, self.val_loader, _ = get_dataloader(
                model_config.dataset,
                train_dir,
                val_dir,
                self.spec.sigma,
                self.spec.stride,
                train_config.workers,
                train_config.batch_size,
                frame_memory=model_config.frame_memory if self.video else None,
                seed=train_config.seed,
                val_batch_size=train_config.val_batch_size,
                input_size=self.spec.input_size,
                shard=shard,
            )
        else:
            self.train_loader = self.val_loader = None
        for loader in (self.train_loader, self.val_loader):
            marked = getattr(loader, "shard", None)
            if marked is not None and tuple(marked) != shard_of(self.mesh):
                raise ValueError(f"a loader of shard {tuple(marked)} on the rank at "
                                 f"{shard_of(self.mesh)} of the data axis")
        # every rank holds b_loc * t_loc frames, so DDP's mean of the ranks'
        # losses (each a mean over its frames) is the global batch's
        self.time_shards = n_time if self.cp else 1
        if model_config.frame_memory % self.time_shards:
            raise ValueError(f"frame_memory {model_config.frame_memory} is not divisible by the "
                             f"'time' axis ({self.time_shards})")
        # sync_bn=False: one BN statistics group per data-parallel shard.
        # A shard is a rank, so a rank's model keeps one group over its
        # rows (create_train_state's bn_groups=1), and its BatchNorms pool
        # only the running statistics across the ranks.
        self.model, self.optimizer, self.state = create_train_state(
            model_config, train_config, train_config.seed, device
        )
        self.device = next(self.model.parameters()).device
        if self.mesh.distributed and self.mesh.size > 1:
            import torch.distributed as dist

            set_bn_process_group(self.model, dist.group.WORLD, sync=model_config.sync_bn)
            shard = (self.mesh.coordinate("data"), data)
            if self.time_shards > 1:  # the rank's clips, and its frames of each
                shard += (self.mesh.coordinate("time"), self.time_shards,
                          model_config.frame_memory // self.time_shards)
            use_dropout_generator(self.model, self.state.generator, shard=shard)
        if pretrained:
            warm_start_from_torch(self.state, pretrained)

        # auto-resume from the newest periodic checkpoint (every rank reads
        # it; rank 0 alone writes)
        self.ckpt_manager = None
        if train_config.checkpoint_dir:
            self.ckpt_manager = CheckpointManager(train_config.checkpoint_dir)
            if self.ckpt_manager.restore_latest(self.state) is not None and self.is_main:
                print(f"resumed from step {self.state.step} ({train_config.checkpoint_dir})")

        # the state keeps the bare model (its keys carry no ``module.``);
        # the step runs on its DDP wrapper
        train_model = self.model
        if self.mesh.distributed:
            train_model = data_parallel(self.model, self.mesh)
            replicate(self.model, self.mesh)
        self.train_step = make_train_step(train_model, self.optimizer, self.spec, video=self.video,
                                          fused_loss=True, time_shards=self.time_shards)
        self.val_step = make_val_step(self.model, self.spec, video=self.video)
        if self.cp:
            self.train_step = under_mesh(self.mesh, self.train_step)
            self.val_step = under_mesh(self.mesh, self.val_step)

        self.is_best = 0.0
        self.best_pck = 0.0
        self.best_pckh = 0.0
        self.model_name = train_config.model_name
        # rank 0: the last validation's scored (pred, target) coordinates,
        # (frames, K+1, 2) each, in one process's order
        self.val_coords = None

        # TSV metric log (counterpart of extra_utils/logger.py)
        self.logger = None
        if log_file and self.is_main:
            self.logger = Logger(log_file, title=self.model_name)
            self.logger.set_names(["epoch", "train_loss", "mAP", "mPCK", "mPCKh"])
        self._epoch_stats = {}
        # epoch -> host timestamps of training(epoch): seconds until its last
        # loss reached the host, steps, and the seconds spent waiting for
        # the loader and in the (synchronous) upload
        self.epoch_times = {}

        if print_summary and self.is_main:
            # parameter audit (counterpart of get_model_summary,
            # utils/utils.py:713-829, called at unipose.py:96-98)
            print(f"Total Parameters: {count_params(self.model):,}")
            for name, n in sorted(per_module_params(self.model).items()):
                print(f"  {name:<12} {n:>14,}")

    # ------------------------------------------------------------------
    def _upload(self, batch):
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in _KEEP if k in batch}

    @staticmethod
    def _host_batch(batch) -> dict:
        """The model's leaves of a loader's batch, and its shard mark."""
        sub = {k: np.asarray(batch[k]) for k in _KEEP if k in batch}
        if batch.get("shard") is not None:
            sub["shard"] = batch["shard"]
        return sub

    def _rows(self, sub):
        """The rank's rows of a host batch: a sharded loader's pass through
        (under time parallelism only their frames are cut), a global batch
        is cut; under time parallelism its (clip, frame) block of clips of
        ``frame_memory`` frames."""
        if not self.cp:
            return shard_batch(sub, self.mesh)
        t = sub["frames"].shape[1]
        if t != self.model_config.frame_memory:
            raise ValueError(f"a clip of {t} frames; time parallelism splits frame_memory="
                             f"{self.model_config.frame_memory}")
        return shard_clip_batch(sub, self.mesh)

    def _device_batch(self, batch):
        """The rank's rows of a batch, on the device (``_rows``)."""
        return self._upload(self._rows(self._host_batch(batch)))

    def _loss_sum(self, pending) -> float:
        """The sum of the losses in ``pending``, averaged over the ranks
        (each a mean over its rows, so the average is the global batch's);
        one read back to the host."""
        total = torch.stack(pending).sum()
        if self.mesh.distributed:
            import torch.distributed as dist

            dist.all_reduce(total)
            total = total / self.mesh.world
        return total.item()

    def training(self, epoch: int) -> float:
        if self.is_main:
            print(f"Epoch {epoch}:")
        # Losses stay on the device between log points: reading one every
        # step would stall the host on the card at each update.
        pending = []
        train_loss = 0.0
        n = 0
        waited = uploaded = 0.0  # host seconds in next(loader) and in the upload
        t0 = time.perf_counter()
        self.train_loader.set_epoch(epoch)
        batches = iter(self.train_loader)
        while True:
            t1 = time.perf_counter()
            batch = next(batches, None)
            t2 = time.perf_counter()
            if batch is None:
                break
            device_batch = self._device_batch(batch)
            waited, uploaded = waited + t2 - t1, uploaded + time.perf_counter() - t2
            metrics = self.train_step(self.state, device_batch)
            pending.append(metrics["loss"])
            n += 1
            if n % self.log_every == 0:
                train_loss += self._loss_sum(pending)  # one sync
                pending = []
                rate = n / (time.perf_counter() - t0)
                if self.is_main:
                    print(
                        f"  iter {n}/{len(self.train_loader)} "
                        f"loss {train_loss / n:.6f} ({rate:.2f} it/s)"
                    )
        if pending:
            train_loss += self._loss_sum(pending)
        self.epoch_times[epoch] = {"seconds": time.perf_counter() - t0, "steps": n,
                                   "loader_wait_s": waited, "upload_s": uploaded}
        if self.ckpt_manager is not None and self.is_main:
            with torch.profiler.record_function("checkpoint_save"):  # a span in traces
                self.ckpt_manager.save(self.state.step, self.state)
        avg = train_loss / max(n, 1)
        self._epoch_stats[epoch] = avg
        return avg

    def finalize(self) -> None:
        """Wait for the work queued on the device, then for in-flight
        checkpoint writes to commit (call before exit)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.ckpt_manager is not None:
            self.ckpt_manager.wait()

    # ------------------------------------------------------------------
    def _device_batch_padded(self, batch, pad_to):
        """The rank's rows of a validation batch padded to ``pad_to`` global
        rows, on the device.  A global batch that is ragged is padded by
        repeating its last sample, then cut (JAX trainer.py:237-252); a
        sharded loader's batch comes padded and cut.  Returns (device batch,
        real rows of the global batch, resolved pad size)."""
        sub = self._host_batch(batch)
        if local_shard(sub, self.mesh) is not None:
            n = int(batch["global_real"])
        else:
            n = sub["kpts"].shape[0]
            if pad_to is None:
                pad_to = n
            if n < pad_to:
                sub = {k: np.concatenate([v, np.repeat(v[-1:], pad_to - n, axis=0)]) for k, v in sub.items()}
        return self._upload(self._rows(sub)), n, pad_to

    def validation(self, epoch: int) -> float:
        """Validation (reference behaviour: unipose.py:133-193) with the
        argmax of predictions and targets on the device and one fetch of
        all coordinates at the end; metrics per frame (a clip's frames in
        order), running means gated per joint by visibility
        (unipose.py:163-176).  Returns the mAP.

        Across ranks every rank runs the eval step on its rows of every
        global batch (the same batches, padding included, so the same
        collectives), the (pred, target) coordinates are all-gathered once,
        and rank 0 puts them back in one process's order, drops the padding
        and scores them, so its metrics are one process's bit for bit; it
        broadcasts the mAP, mPCK and mPCKh, and every rank keeps its bests
        from them."""
        pending, valids, pad_to = [], [], getattr(self.val_loader, "batch_size", None)
        for batch in self.val_loader:
            db, n_valid, pad_to = self._device_batch_padded(batch, pad_to)
            pred, tgt, _ = self.val_step(db)
            pending.append(torch.stack([pred, tgt]))  # (2, rows, [frames,] K+1, 2)
            valids.append(n_valid)
        if not pending:
            return 0.0
        local = torch.stack(pending)
        if self.mesh.size == 1:
            return self._record(epoch, *self._score(epoch, local.cpu().numpy(), valids))
        if not self.mesh.distributed:
            raise RuntimeError(f"validation on a mesh of {self.mesh.size} ranks needs their process group")
        import torch.distributed as dist

        parts = [torch.empty_like(local) for _ in range(self.mesh.world)]
        dist.all_gather(parts, local.contiguous())  # the one gather of a validation
        metrics = torch.zeros(3, dtype=torch.float64, device=self.device)
        if self.is_main:
            coords = self._global_batches(parts).cpu().numpy()
            metrics = torch.tensor(self._score(epoch, coords, valids), dtype=torch.float64,
                                   device=self.device)
        dist.broadcast(metrics, src=0)
        return self._record(epoch, *metrics.tolist())

    def _global_batches(self, parts) -> torch.Tensor:
        """Every rank's (batches, 2, rows, ...) coordinates put back into the
        padded global batches (batches, 2, B, ...): the rows of data index
        d, and under time parallelism each clip's frame blocks in time
        order.  Ranks that differ only on other axes hold the same rows;
        the first is taken."""
        mesh = self.mesh
        spread = ("data", "time") if self.cp else ("data",)
        owners = [r for r in range(mesh.size)
                  if all(mesh.coordinate(a, r) == 0 for a in mesh.axis_names if a not in spread)]
        by_data = []
        for d in range(mesh.axis_size("data")):
            ranks = sorted((r for r in owners if mesh.coordinate("data", r) == d),
                           key=lambda r: mesh.coordinate("time", r))
            by_data.append(torch.cat([parts[r] for r in ranks], dim=3) if self.cp else parts[ranks[0]])
        return torch.cat(by_data, dim=2)

    def _score(self, epoch: int, coords: np.ndarray, valids) -> tuple:
        """The metrics of the global batches' (pred, target) coordinates,
        padding rows dropped, in dataset order (a clip's frames in order);
        prints them.  Returns (mAP, mPCK, mPCKh)."""
        k = self.model_config.num_classes
        AP = np.zeros(k + 1)
        PCK = np.zeros(k + 1)
        PCKh = np.zeros(k + 1)
        count = np.zeros(k + 1)

        hm = self.spec.heatmap_size
        frames = []  # (pred (K+1, 2), target (K+1, 2)) in dataset order
        for bi, n_valid in enumerate(valids):
            for s in range(n_valid):
                if self.video:
                    frames.extend((coords[bi, 0, s, j], coords[bi, 1, s, j]) for j in range(coords.shape[3]))
                else:
                    frames.append((coords[bi, 0, s], coords[bi, 1, s]))
        self.val_coords = tuple(np.stack([f[i] for f in frames]) for i in (0, 1))

        for frame_idx, (p, t) in enumerate(frames):
            acc, acc_pck, acc_pckh, _, _, visible = accuracy_from_coords(
                p[None], t[None], hm, hm, 0.2, 0.5, self.model_config.dataset
            )
            AP[0] = (AP[0] * frame_idx + acc[0]) / (frame_idx + 1)
            PCK[0] = (PCK[0] * frame_idx + acc_pck[0]) / (frame_idx + 1)
            PCKh[0] = (PCKh[0] * frame_idx + acc_pckh[0]) / (frame_idx + 1)
            for j in range(1, k + 1):
                if visible[j] == 1:
                    AP[j] = (AP[j] * count[j] + acc[j]) / (count[j] + 1)
                    PCK[j] = (PCK[j] * count[j] + acc_pck[j]) / (count[j] + 1)
                    PCKh[j] = (PCKh[j] * count[j] + acc_pckh[j]) / (count[j] + 1)
                    count[j] += 1

        mAP = AP[1:].sum() / k
        mPCK = PCK[1:].sum() / k
        mPCKh = PCKh[1:].sum() / k
        print_accuracies(mAP, AP, mPCKh, PCKh, mPCK, PCK, self.model_config.dataset)
        return mAP, mPCK, mPCKh

    def _record(self, epoch: int, mAP: float, mPCK: float, mPCKh: float) -> float:
        """Keep the bests (every rank); rank 0 writes the best checkpoint,
        prints the bests and appends the log line.  Returns the mAP."""
        if mAP > self.is_best:
            self.is_best = mAP
            if self.model_name and self.is_main:
                save_checkpoint(self.state, True, self.model_name)
                print(f"Model saved to {self.model_name}")
        self.best_pckh = max(self.best_pckh, mPCKh)
        self.best_pck = max(self.best_pck, mPCK)
        if self.is_main:
            print(
                "Best AP = %.2f%%; PCK = %2.2f%%; PCKh = %2.2f%%"
                % (self.is_best * 100, self.best_pck * 100, self.best_pckh * 100)
            )
        if self.logger is not None:
            self.logger.append(
                [epoch, self._epoch_stats.get(epoch, float("nan")), mAP, mPCK, mPCKh]
            )
        return mAP

    # ------------------------------------------------------------------
    def test(self, image_path: str, out_dir: str = "samples"):
        """Demo inference on one image (Reference: unipose.py:197-246
        ``Trainer.test``): the image resized to the input size, the eval
        forward (the video variant as a one-frame rollout with a zero
        centermap) and the align-corners upsample of the heatmaps to the
        input size on the model's device; writes ``<out_dir>/pose.png``
        (the skeleton) and ``<out_dir>/heat/unipose<c>.png`` (a JET overlay
        a channel).  Returns the keypoints, [x, y] a joint."""
        import cv2

        from unipose_tpu_torch.viz.draw import draw_paint, get_kpts, heatmap_overlays

        size = self.spec.input_size
        img = np.asarray(cv2.resize(cv2.imread(image_path), (size, size)), np.float32)
        x = preprocess_images(torch.from_numpy(img[None]).to(self.device)).permute(0, 3, 1, 2)
        with _eval_mode(self.model):
            if self.video:
                heat = self.model(x[:, None], torch.zeros_like(x[:, None, :1]))[0][:, 0]
            else:
                heat = self.model(x)
            heat = bilinear_resize(heat, (size, size)).permute(0, 2, 3, 1).cpu().numpy()
        kpts = get_kpts(heat, img_h=float(size), img_w=float(size))
        os.makedirs(out_dir, exist_ok=True)
        draw_paint(image_path, kpts, self.model_config.dataset,
                   out_path=os.path.join(out_dir, "pose.png"))
        heatmap_overlays(heat, image_path, out_dir=os.path.join(out_dir, "heat"))
        return kpts
