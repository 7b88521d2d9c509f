"""Training CLI: the entry point of the image and video training paths.

Usage (image, Reference: unipose.py:248-275):
    python -m unipose_tpu_torch.cli.train --dataset LSP --train_dir ... --val_dir ... \
        --checkpoint_dir ...
Usage (video, Reference: uniposeLSTM.py:274-301):
    python -m unipose_tpu_torch.cli.train --dataset Penn_Action --model_arch uniposeLSTM \
        --train_dir penn/ --val_dir penn/ --checkpoint_dir ...
Runs on the CUDA card; ``--device cpu`` runs on the CPU (the tests do).

Counterpart of ``unipose_tpu/cli/train.py``, with the same flags and
defaults (video: clip batch 1, sigma 1, ``--frame_memory`` frames a clip),
plus ``--device``, ``--input_size`` (LSP and Penn Action only: the other
datasets' loaders resize to 368) and ``--profile_epoch`` (the epoch that
``--profile_dir`` traces, with ``torch.profiler``).  ``--time_parallel``
above 1 exits (ROADMAP.md Queue 1 item 6).  Flags are not silently
overridden after parsing (unipose.py:261-267 hardcodes paths over the CLI
values); presets supply defaults instead.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="unipose_tpu_torch trainer")
    p.add_argument("--pretrained", default=None, type=str,
                   help="reference *.pth.tar to warm-start from")
    p.add_argument("--dataset", type=str, default="LSP", choices=sorted(DATASETS))
    p.add_argument("--train_dir", default=None, type=str)
    p.add_argument("--val_dir", default=None, type=str)
    p.add_argument("--model_name", default="unipose", type=str)
    p.add_argument("--model_arch", default="unipose", type=str,
                   choices=["unipose", "uniposeLSTM"])
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--frame_memory", default=5, type=int)
    p.add_argument("--sigma", default=None, type=float,
                   help="target Gaussian sigma (default: the reference's "
                        "3.0 image / 1.0 video)")
    p.add_argument("--stride", default=None, type=int,
                   help="heatmap stride override (default: dataset spec's 8)")
    p.add_argument("--warmup_steps", default=0, type=int,
                   help="linear LR warmup steps (0 = off, the reference schedule)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--head_positive_bias", action="store_true",
                   help="video: init the 11x11 head's biases at the positive "
                        "torch bound (ModelConfig.head_positive_bias)")
    p.add_argument("--freeze_bn", action="store_true",
                   help="fine-tune with BatchNorm frozen to running stats "
                        "(the reference flag, made functional)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--config", default=None, type=str,
                   help="YAML config (see core.config.load_yaml_config); "
                        "overrides the other model/train flags")
    p.add_argument("--checkpoint_dir", default=None, type=str,
                   help="periodic-checkpoint/auto-resume directory")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler Chrome trace of one epoch's "
                        "training to <dir>/trace.json")
    p.add_argument("--profile_epoch", default=0, type=int,
                   help="the epoch that --profile_dir traces")
    p.add_argument("--time_parallel", default=1, type=int,
                   help="video only: shard each clip's frames over this many "
                        "devices (not ported yet: ROADMAP.md Queue 1 item 6)")
    p.add_argument("--input_size", default=368, type=int,
                   help="input resolution (LSP and Penn Action only; the "
                        "reference's is 368)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' runs on the CPU")
    return p


def apply_time_parallel(model_config, train_config, n_time: int):
    """``--time_parallel``: 1 leaves the configs as they are; sequence
    parallelism waits for the parallelism slice."""
    if n_time <= 1:
        return model_config, train_config
    raise SystemExit(
        f"--time_parallel {n_time}: sequence parallelism is not ported yet "
        "(ROADMAP.md Queue 1 item 6)"
    )


def configs_from_args(args) -> tuple:
    spec = DATASETS[args.dataset]
    video = args.model_arch == "uniposeLSTM"
    model_config = ModelConfig(
        dataset=args.dataset,
        num_classes=spec.num_joints,
        variant="lstm" if video else "image",
        frame_memory=args.frame_memory,
        freeze_bn=getattr(args, "freeze_bn", False),
        head_positive_bias=getattr(args, "head_positive_bias", False),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    # reference defaults: batch 8 image (unipose.py:49), clip-batch 1 video
    # (uniposeLSTM.py:51); sigma 3 image / 1 video (unipose.py:53,
    # uniposeLSTM.py:55)
    batch = args.batch_size or (1 if video else 8)
    train_config = TrainConfig(
        batch_size=batch,
        lr=args.lr,
        sigma=args.sigma if args.sigma is not None else (1.0 if video else 3.0),
        stride=args.stride,
        epochs=args.epochs,
        seed=args.seed,
        model_name=args.model_name,
        warmup_steps=getattr(args, "warmup_steps", 0),
    )
    return model_config, train_config


RESIZABLE = ("LSP", "Penn_Action")  # the loaders that honour input_size


def dataset_spec(dataset: str, input_size: int):
    """The dataset's spec at ``input_size``; only the LSP and Penn Action
    loaders honour a size other than the reference's 368."""
    if input_size != 368 and dataset not in RESIZABLE:
        raise SystemExit(f"--input_size {input_size}: only the LSP and Penn Action loaders resize to it")
    return dataclasses.replace(DATASETS[dataset], input_size=input_size)


def make_trainer(args):
    """The ``Trainer`` that ``main`` runs: configs from the flags or the
    YAML file, ``--checkpoint_dir`` (from which it resumes), the loaders of
    ``--train_dir``/``--val_dir``."""
    from unipose_tpu_torch.train.trainer import Trainer

    if args.config:
        from unipose_tpu_torch.core.config import load_yaml_config

        preset = load_yaml_config(args.config)
        model_config, train_config = preset.model, preset.train
    else:
        model_config, train_config = configs_from_args(args)
    if args.checkpoint_dir:
        train_config = dataclasses.replace(train_config, checkpoint_dir=args.checkpoint_dir)
    model_config, train_config = apply_time_parallel(
        model_config, train_config, args.time_parallel
    )
    return Trainer(
        model_config,
        train_config,
        train_dir=args.train_dir,
        val_dir=args.val_dir,
        pretrained=args.pretrained,
        spec=dataset_spec(model_config.dataset, args.input_size),
        device=args.device,
    )


def run(trainer, args) -> None:
    """``epochs`` rounds of training and validation, then ``finalize``
    (pending checkpoint writes commit) whatever happens."""
    try:
        for epoch in range(trainer.train_config.epochs):
            if trainer.train_loader is not None:
                if epoch == args.profile_epoch and args.profile_dir:
                    from unipose_tpu_torch.utils.profiling import trace

                    with trace(args.profile_dir):
                        trainer.training(epoch)
                else:
                    trainer.training(epoch)
            if trainer.val_loader is not None:
                trainer.validation(epoch)
    finally:
        trainer.finalize()


def main(argv=None):
    """Parse, build the trainer, run it; returns the trainer."""
    args = build_argparser().parse_args(argv)
    trainer = make_trainer(args)
    run(trainer, args)
    return trainer


if __name__ == "__main__":
    main()
