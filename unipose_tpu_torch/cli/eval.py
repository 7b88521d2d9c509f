"""Eval-only CLI: restore a checkpoint and run validation with the per-joint
PCK/PCKh/AP report (Reference: unipose.py validation loop, :133-193).

    python -m unipose_tpu_torch.cli.eval --dataset LSP --val_dir ... --checkpoint_dir ...
    python -m unipose_tpu_torch.cli.eval --dataset Penn_Action --model_arch uniposeLSTM \
        --frame_memory 5 --val_dir ... --checkpoint_dir ...

Counterpart of ``unipose_tpu/cli/eval.py``, plus ``--device`` and
``--input_size`` as ``cli/train.py`` takes them.  Restores the newest
checkpoint of ``--checkpoint_dir`` through the ``Trainer`` and returns the
mAP of ``validation(0)``; with ``--model_arch uniposeLSTM`` the video
model validates per frame over ``--frame_memory``-frame clips.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="unipose_tpu_torch evaluation")
    p.add_argument("--dataset", type=str, default="LSP")
    p.add_argument("--val_dir", required=True, type=str)
    p.add_argument("--pretrained", default=None, type=str,
                   help="torch .pth.tar warm start")
    p.add_argument("--checkpoint_dir", default=None, type=str,
                   help="checkpoint directory (cli/train.py) to restore")
    p.add_argument("--model_arch", default="unipose", type=str,
                   choices=["unipose", "uniposeLSTM"])
    p.add_argument("--frame_memory", default=5, type=int)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--input_size", default=368, type=int,
                   help="input resolution (LSP and Penn Action only; the "
                        "reference's is 368)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' runs on the CPU")
    args = p.parse_args(argv)

    # Fail fast and clearly before any model build: this is the entry point
    # of the pretrained-weight PCK parity runbook (docs/ROADMAP.md), whose
    # checkpoint artifacts are fetched out-of-band.
    if args.pretrained is not None and not os.path.exists(args.pretrained):
        raise SystemExit(
            f"--pretrained checkpoint not found: {args.pretrained!r}.\n"
            "Fetch a released UniPose checkpoint (Google Drive links in "
            "the reference README) or point at your own *.pth.tar, then "
            "rerun — see docs/ROADMAP.md 'Pretrained-weight parity "
            "runbook' for the full command sequence."
        )

    from unipose_tpu_torch.cli.train import configs_from_args, dataset_spec
    from unipose_tpu_torch.train.trainer import Trainer

    ns = argparse.Namespace(
        dataset=args.dataset,
        model_arch=args.model_arch,
        frame_memory=args.frame_memory,
        bf16=args.bf16,
        batch_size=None,
        lr=1e-4,
        sigma=None,
        stride=None,
        epochs=1,
        seed=0,
        model_name=None,
    )
    model_config, train_config = configs_from_args(ns)
    if args.checkpoint_dir:
        train_config = dataclasses.replace(train_config, checkpoint_dir=args.checkpoint_dir)
    trainer = Trainer(
        model_config,
        train_config,
        val_dir=args.val_dir,
        pretrained=args.pretrained,
        spec=dataset_spec(args.dataset, args.input_size),
        device=args.device,
    )
    return trainer.validation(0)


if __name__ == "__main__":
    main()
