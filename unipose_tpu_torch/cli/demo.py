"""Demo inference CLI: one image in, a skeleton render and per-channel
heatmap overlays out (Reference: unipose.py:197-246 ``Trainer.test``).

    python -m unipose_tpu_torch.cli.demo person.jpg --dataset LSP --pretrained UniPose_LSP.tar

Counterpart of ``unipose_tpu/cli/demo.py``, plus ``--device``: the image
model (seed-0 init, or ``--pretrained`` loaded by key intersection) through
``Trainer.test`` at 368x368, the forward and the heatmaps' 46 -> 368
align-corners upsample on the card unless ``--device cpu``.  Writes
``<out_dir>/pose.png`` and ``<out_dir>/heat/unipose<c>.png`` and returns
the keypoints.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="unipose_tpu_torch demo inference")
    p.add_argument("image", type=str, help="input image path")
    p.add_argument("--dataset", type=str, default="LSP")
    p.add_argument("--pretrained", default=None, type=str)
    p.add_argument("--out_dir", default="samples", type=str)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' runs on the CPU")
    args = p.parse_args(argv)

    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch.train.trainer import Trainer

    spec = DATASETS[args.dataset]
    trainer = Trainer(
        ModelConfig(dataset=args.dataset, num_classes=spec.num_joints),
        TrainConfig(model_name=""),
        pretrained=args.pretrained,
        loaders=(None, None),
        device=args.device,
    )
    kpts = trainer.test(args.image, args.out_dir)
    print(f"wrote {args.out_dir}/pose.png and {args.out_dir}/heat/*.png")
    print("keypoints:", kpts)
    return kpts


if __name__ == "__main__":
    main()
