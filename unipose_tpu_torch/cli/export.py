"""Export a serving artifact (a ``torch.export`` program) to a file.

Counterpart of ``unipose_tpu/cli/export.py``: bake weights (fresh from seed
0, warm-started from a reference checkpoint, or restored from a
``cli/train.py`` checkpoint directory) into a self-contained artifact that
``cli/serve.py --artifact`` loads without the model code
(``compat/export.py``).  Every JAX flag, plus ``--device``: the program is
exported on, and runs on, the card unless ``--device cpu`` is given.

Usage:
  python -m unipose_tpu_torch.cli.export --dataset LSP --out model.pt2 \\
      [--pretrained w.pth.tar | --checkpoint_dir ckpts/] [--size 368] \\
      [--batch 4] [--bf16] [--raw_uint8] [--int8_frontend]
  python -m unipose_tpu_torch.cli.export --dataset Penn_Action \\
      --model_arch uniposeLSTM --frame_memory 5 [--stream] --out video.pt2

``--int8_frontend`` calibrates the front end's activation scales on
synthetic inputs in the serving range, (U[0, 1) * 255 - 128) / 256, drawn
from a ``torch.Generator`` seeded 0: the same recipe as the JAX CLI, but not
JAX's draws.  For deployment-grade scales, calibrate on real images.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="unipose_tpu_torch artifact export")
    p.add_argument("--dataset", type=str, default="LSP")
    p.add_argument("--out", required=True, type=str, help="output artifact path")
    p.add_argument("--pretrained", default=None, type=str,
                   help="reference .pth.tar to warm-start from")
    p.add_argument("--checkpoint_dir", default=None, type=str,
                   help="cli/train.py checkpoint dir to restore the latest step from")
    p.add_argument("--model_arch", default="unipose", type=str,
                   choices=["unipose", "uniposeLSTM"])
    p.add_argument("--frame_memory", default=5, type=int)
    p.add_argument("--batch", default=1, type=int, help="baked batch size")
    p.add_argument("--size", default=368, type=int, help="baked input size")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument(
        "--raw_uint8", action="store_true",
        help="the artifact takes raw uint8 pixels and normalises them on the device "
        "(4x less host-to-device transfer); cli/serve reads the input dtype from it",
    )
    p.add_argument(
        "--int8_frontend", action="store_true",
        help="quantize the ResNet front end (stem, layer1, layer2) to w8a8 on the "
        "conv_i8 kernel (changes numerics)",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="video only: a streaming artifact (a chunk-program pair carrying the "
        "ConvLSTM state), so cli/serve runs clips of any length in --frame_memory chunks",
    )
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.stream and args.int8_frontend:
        raise SystemExit("--stream with --int8_frontend is not supported "
                         "(the int8 video forward serves fresh-state clips only)")

    from unipose_tpu_torch import resolve_device
    from unipose_tpu_torch.compat.export import export_inference, export_video_stream
    from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
    from unipose_tpu_torch.train.state import create_train_state

    spec = DATASETS[args.dataset]
    video = args.model_arch == "uniposeLSTM"
    if args.stream and not video:
        raise SystemExit("--stream requires --model_arch uniposeLSTM")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    mc = ModelConfig(
        dataset=args.dataset,
        num_classes=spec.num_joints,
        variant="lstm" if video else "image",
        frame_memory=args.frame_memory,
        compute_dtype=dtype,
    )
    device = resolve_device(args.device)
    model, _, state = create_train_state(mc, TrainConfig(), seed=0, device=device)
    if args.pretrained:
        from unipose_tpu_torch.train.checkpoint import warm_start_from_torch

        warm_start_from_torch(state, args.pretrained)
    if args.checkpoint_dir:
        from unipose_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        restored = mgr.restore_latest(state)
        mgr.close()
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
        print(f"restored step {int(state.step)} from {args.checkpoint_dir}")
    model.eval()

    shape = (
        (args.batch, args.frame_memory, args.size, args.size, 3)
        if video
        else (args.batch, args.size, args.size, 3)
    )
    forward = None
    if args.int8_frontend:
        from unipose_tpu_torch.models.quantized import int8_forward_fn, int8_video_forward_fn

        calib_shape = (2, args.frame_memory, args.size, args.size, 3) if video else (8, args.size, args.size, 3)
        g = torch.Generator().manual_seed(0)
        calib = ((torch.rand(calib_shape, generator=g) * 255.0 - 128.0) / 256.0).to(device)
        make = int8_video_forward_fn if video else int8_forward_fn
        _, forward = make(model, calib, dtype=dtype)
    if args.stream:
        blob = export_video_stream(model, shape, path=args.out, raw_uint8=args.raw_uint8)
        print(f"wrote {args.out}: {len(blob)} bytes, streaming chunk {list(shape)}, on {device}")
        return blob
    blob = export_inference(
        model, shape, path=args.out, video=video, forward=forward, raw_uint8=args.raw_uint8
    )
    print(f"wrote {args.out}: {len(blob)} bytes, input {list(shape)}, on {device}")
    return blob


if __name__ == "__main__":
    main()
