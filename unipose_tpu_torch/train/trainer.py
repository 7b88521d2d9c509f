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
from unipose_tpu_torch.ops.resize import bilinear_resize
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
    ):
        """``spec``/``loaders`` override what derives from
        ``model_config.dataset``; ``loaders`` is (train, val[, test]) with
        the loader protocol (``__len__``, ``set_epoch``, ``__iter__`` of
        numpy batches, ``batch_size``).  Runs on the card unless
        ``device="cpu"``."""
        self.model_config = model_config
        self.train_config = train_config
        # TrainConfig.sigma/stride resolve into the spec here; the loaders
        # and the steps read the spec only.
        self.spec = effective_spec(spec or DATASETS[model_config.dataset], train_config)
        self.video = model_config.variant == "lstm"
        device = resolve_device(device)
        self.log_every = log_every

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
            )
        else:
            self.train_loader = self.val_loader = None

        self.model, self.optimizer, self.state = create_train_state(
            model_config, train_config, train_config.seed, device
        )
        self.device = next(self.model.parameters()).device
        if pretrained:
            warm_start_from_torch(self.state, pretrained)

        # auto-resume from the newest periodic checkpoint
        self.ckpt_manager = None
        if train_config.checkpoint_dir:
            self.ckpt_manager = CheckpointManager(train_config.checkpoint_dir)
            if self.ckpt_manager.restore_latest(self.state) is not None:
                print(f"resumed from step {self.state.step} ({train_config.checkpoint_dir})")

        self.train_step = make_train_step(self.model, self.optimizer, self.spec,
                                          video=self.video, fused_loss=True)
        self.val_step = make_val_step(self.model, self.spec, video=self.video)

        self.is_best = 0.0
        self.best_pck = 0.0
        self.best_pckh = 0.0
        self.model_name = train_config.model_name

        # TSV metric log (counterpart of extra_utils/logger.py)
        self.logger = None
        if log_file:
            self.logger = Logger(log_file, title=self.model_name)
            self.logger.set_names(["epoch", "train_loss", "mAP", "mPCK", "mPCKh"])
        self._epoch_stats = {}
        # epoch -> host timestamps of training(epoch): seconds until its last
        # loss reached the host, steps, and the seconds spent waiting for
        # the loader and in the (synchronous) upload
        self.epoch_times = {}

        if print_summary:
            # parameter audit (counterpart of get_model_summary,
            # utils/utils.py:713-829, called at unipose.py:96-98)
            print(f"Total Parameters: {count_params(self.model):,}")
            for name, n in sorted(per_module_params(self.model).items()):
                print(f"  {name:<12} {n:>14,}")

    # ------------------------------------------------------------------
    def _device_batch(self, batch):
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in _KEEP if k in batch}

    def training(self, epoch: int) -> float:
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
                train_loss += torch.stack(pending).sum().item()  # one sync
                pending = []
                rate = n / (time.perf_counter() - t0)
                print(
                    f"  iter {n}/{len(self.train_loader)} "
                    f"loss {train_loss / n:.6f} ({rate:.2f} it/s)"
                )
        if pending:
            train_loss += torch.stack(pending).sum().item()
        self.epoch_times[epoch] = {"seconds": time.perf_counter() - t0, "steps": n,
                                   "loader_wait_s": waited, "upload_s": uploaded}
        if self.ckpt_manager is not None:
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
        """Pad a ragged last batch to ``pad_to`` by repeating its last
        sample.  Returns (device batch, real samples, resolved pad size)."""
        sub = {k: np.asarray(batch[k]) for k in _KEEP if k in batch}
        n = sub["kpts"].shape[0]
        if pad_to is None:
            pad_to = n
        if n < pad_to:
            sub = {k: np.concatenate([v, np.repeat(v[-1:], pad_to - n, axis=0)]) for k, v in sub.items()}
        return self._device_batch(sub), n, pad_to

    def validation(self, epoch: int) -> float:
        """Validation (reference behaviour: unipose.py:133-193) with the
        argmax of predictions and targets on the device and one fetch of
        all coordinates at the end; metrics per frame (a clip's frames in
        order), running means gated per joint by visibility
        (unipose.py:163-176).  Returns the mAP."""
        k = self.model_config.num_classes
        AP = np.zeros(k + 1)
        PCK = np.zeros(k + 1)
        PCKh = np.zeros(k + 1)
        count = np.zeros(k + 1)

        pending = []  # (pred coords, target coords, loss) on the device
        valids = []
        pad_to = getattr(self.val_loader, "batch_size", None)
        for batch in self.val_loader:
            db, n_valid, pad_to = self._device_batch_padded(batch, pad_to)
            pending.append(self.val_step(db))
            valids.append(n_valid)
        if not pending:
            return 0.0

        preds = torch.cat([p for p, _, _ in pending]).cpu().numpy()
        tgts = torch.cat([t for _, t, _ in pending]).cpu().numpy()

        hm = self.spec.heatmap_size
        frames = []  # (pred (K+1, 2), target (K+1, 2)) in dataset order
        for bi, n_valid in enumerate(valids):
            for s in range(n_valid):
                i = bi * pad_to + s
                if self.video:
                    frames.extend((preds[i, j], tgts[i, j]) for j in range(preds.shape[1]))
                else:
                    frames.append((preds[i], tgts[i]))

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

        if mAP > self.is_best:
            self.is_best = mAP
            if self.model_name:
                save_checkpoint(self.state, True, self.model_name)
                print(f"Model saved to {self.model_name}")
        self.best_pckh = max(self.best_pckh, mPCKh)
        self.best_pck = max(self.best_pck, mPCK)
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
