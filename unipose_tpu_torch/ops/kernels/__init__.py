"""Hand-written Hopper kernels, one module each: the wrapper, its plain
PyTorch version and its helpers.  Each wrapper keeps an integer count of
its launches in ``<wrapper>.launches``, counted where the kernel is launched
(for the registered ops, inside their CUDA implementation)."""

from __future__ import annotations

from typing import Dict


def wrappers():
    from unipose_tpu_torch.ops.kernels.conv_i8 import conv_i8
    from unipose_tpu_torch.ops.kernels.fused_stem import fused_stem
    from unipose_tpu_torch.ops.kernels.heatmap_mse import heatmap_mse, heatmap_mse_backward
    from unipose_tpu_torch.ops.kernels.wasp_cascade import wasp_cascade

    return (wasp_cascade, heatmap_mse, heatmap_mse_backward, fused_stem, conv_i8)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in wrappers()}
