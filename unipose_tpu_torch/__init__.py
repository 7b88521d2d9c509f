"""unipose_tpu_torch — UniPose on PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside ``unipose_tpu`` (the JAX reference).  Module names
copy the JAX package's, so each counterpart is easy to find; inside, the code
is PyTorch: NCHW ``nn.Module``s whose ``state_dict`` keys are the reference
checkpoint's, an explicit ``device`` and an explicit ``torch.Generator``.

The package imports ``torch`` and never ``jax`` or ``unipose_tpu``.  Each
TPU kernel of the path it covers is a hand-written CUDA kernel under
``csrc/``, with its plain PyTorch version beside its wrapper in
``ops/kernels/``.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they raise.
They never fall back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card.  Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
