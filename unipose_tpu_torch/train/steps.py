"""Device-side input normalisation.

Counterpart of the first lines of ``unipose_tpu/train/steps.py`` (:25-31):
(x - 128) / 256 (utils/lsp_lspet_data.py:242-243), run on the device so
raw uint8 pixels cross the bus.  The train and eval steps arrive with the
training slice.
"""

from __future__ import annotations

import torch

MEAN = 128.0
STD = 256.0


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """(x - 128) / 256 in f32, any shape (BGR channel-last as decoded)."""
    return (images.float() - MEAN) / STD
