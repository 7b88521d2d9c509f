"""UniPose-LSTM video model: per-frame UniPose features and a ConvLSTM over
time, NCHW.

Counterpart of ``unipose_tpu/models/unipose_lstm.py`` (Reference:
model/uniposeLSTM.py):
  * ``ConvLSTM0`` (first frame, no incoming state): ``cell = tanh(g*i)``,
    ``hide = o*cell``, g/i/o from 3x3 convs on the input (:9-24);
  * ``ConvLSTMCell`` (later frames): ``cell = f*prev_cell + i*g``,
    ``hide = o*tanh(cell)``, per-gate x- and h-convs (:27-64);
  * per frame: backbone -> WASP (no BN in its GAP branch) -> decoder (K+1
    channels at H/8), the centermap average-pooled 9/8/1 to H/8 and
    concatenated: K+2 channels (:108-116);
  * head: three 11x11 convs to 128, then 1x1 128->128 and 1x1 -> K+1, each
    followed by ReLU (:85-89, :120-124).

As in the JAX package, the tower (backbone, WASP, decoder) runs once,
batched over the B*T frames, since nothing in it depends on the recurrent
state; so do the ConvLSTM's x-gate convs and the head.  Only the h-gates
and the gate arithmetic run in a loop over T.  Gates and carry are f32 under
a bf16 compute dtype; ``hide`` goes back to the compute dtype for the next
conv and for the head.

Module names are the reference's ``state_dict`` keys: the per-gate convs
``lstm_0.conv_{g,i,o}_lstm`` and ``lstm.conv_{g,i,o,f}{x,h}_lstm``, and the
head at the top level as ``conv1``..``conv5``.  The cell concatenates its
per-gate weights at each call into one conv for the four x-gates and one
for the four h-gates, in gate order g, i, o, f.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unipose_tpu_torch.models.decoder import Decoder
from unipose_tpu_torch.models.layers import conv
from unipose_tpu_torch.models.resnet import ResNet101
from unipose_tpu_torch.models.wasp import WASP
from unipose_tpu_torch.ops.pooling import avg_pool2d

GATE_ORDER = ("g", "i", "o", "f")
State = Tuple[torch.Tensor, torch.Tensor]


def _gate_conv(ch: int) -> nn.Conv2d:
    return conv(ch, ch, 3, padding=1, bias=True, torch_default_init=True)


class ConvLSTM0(nn.Module):
    """First-frame cell (Reference: uniposeLSTM.py:9-24)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv_g_lstm = _gate_conv(features)
        self.conv_i_lstm = _gate_conv(features)
        self.conv_o_lstm = _gate_conv(features)

    def forward(self, x: torch.Tensor) -> State:
        g = torch.tanh(self.conv_g_lstm(x).float())
        i = torch.sigmoid(self.conv_i_lstm(x).float())
        o = torch.sigmoid(self.conv_o_lstm(x).float())
        cell = torch.tanh(g * i)
        return cell, o * cell


class ConvLSTMCell(nn.Module):
    """Recurrent cell (Reference: uniposeLSTM.py:27-64)."""

    def __init__(self, features: int):
        super().__init__()
        for g in GATE_ORDER:
            setattr(self, f"conv_{g}x_lstm", _gate_conv(features))
            setattr(self, f"conv_{g}h_lstm", _gate_conv(features))

    def _gates_conv(self, x: torch.Tensor, xh: str) -> torch.Tensor:
        """The four ``xh`` gate convs of x as one conv, in x's dtype."""
        convs = [getattr(self, f"conv_{g}{xh}_lstm") for g in GATE_ORDER]
        w = torch.cat([c.weight for c in convs]).to(x.dtype)
        b = torch.cat([c.bias for c in convs]).to(x.dtype)
        return F.conv2d(x, w, b, padding=1)

    def x_gates(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, h, w) inputs -> (N, 4C, h, w) x-gate pre-activations; the
        caller batches every frame through one call."""
        return self._gates_conv(x, "x")

    def forward(self, state: State, xg: torch.Tensor) -> State:
        """One step from the f32 (cell, hide) and this frame's x-gates."""
        prev_cell, prev_hide = state
        hg = self._gates_conv(prev_hide.to(xg.dtype), "h")
        g, i, o, f = (xg + hg).float().chunk(4, dim=1)
        cell = torch.sigmoid(f) * prev_cell.float() + torch.sigmoid(i) * torch.tanh(g)
        return cell, torch.sigmoid(o) * torch.tanh(cell)


class UniPoseLSTM(nn.Module):
    def __init__(
        self,
        num_classes: int = 13,
        output_stride: int = 16,
        stride: int = 8,
        wasp_double_conv2: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        layers: Tuple[int, int, int, int] = (3, 4, 23, 3),
        freeze_bn: bool = False,
        head_positive_bias: bool = False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.freeze_bn = freeze_bn
        ch = num_classes + 2
        self.backbone = ResNet101(output_stride=output_stride, layers=layers)
        # the video WASP has no BN in its GAP branch (waspVideo.py:56-59)
        self.wasp = WASP(output_stride=output_stride, double_conv2=wasp_double_conv2,
                         gap_batchnorm=False)
        self.decoder = Decoder(num_classes)
        self.lstm_0 = ConvLSTM0(ch)
        self.lstm = ConvLSTMCell(ch)
        for n, (cin, cout, k) in enumerate(
            [(ch, 128, 11), (128, 128, 11), (128, 128, 11), (128, 128, 1), (128, num_classes + 1, 1)],
            start=1,
        ):
            setattr(self, f"conv{n}", conv(cin, cout, k, padding=k // 2, bias=True,
                                           torch_default_init=True,
                                           bias_positive=head_positive_bias))

    def train(self, mode: bool = True) -> "UniPoseLSTM":
        super().train(mode)
        if mode and self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def head(self, x: torch.Tensor) -> torch.Tensor:
        for n in range(1, 6):
            x = torch.relu(getattr(self, f"conv{n}")(x))
        return x

    def forward(
        self,
        frames: torch.Tensor,
        centermap: torch.Tensor,
        initial_state: Optional[State] = None,
    ) -> Tuple[torch.Tensor, State]:
        """frames (B, T, 3, H, W) normalised, centermap (B, T, 1, H, W) ->
        (heatmaps (B, T, K+1, H/8, W/8) f32, final (cell, hide) f32, each
        (B, K+2, H/8, W/8)).

        ``initial_state``: the (cell, hide) of a previous chunk; every frame
        then goes through ``ConvLSTMCell``.  Without it frame 0 goes through
        ``ConvLSTM0``, the reference's first-frame branch (:106-124)."""
        b, t, _, h, w = frames.shape
        x = frames.reshape(b * t, 3, h, w).to(self.compute_dtype, memory_format=torch.channels_last)
        feats, low_level = self.backbone(x)
        y = self.decoder(self.wasp(feats), low_level)  # (B*T, K+1, h8, w8)
        cm = avg_pool2d(centermap.reshape(b * t, 1, h, w).to(y.dtype), 9, 8, 1)
        z = torch.cat([y, cm], dim=1)
        h8, w8 = z.shape[2:]
        z = z.reshape(b, t, -1, h8, w8)

        if initial_state is None:
            cell, hide = self.lstm_0(z[:, 0])
            hides = [hide.to(z.dtype)]
            rest = z[:, 1:]
        else:
            cell, hide = initial_state
            hides = []
            rest = z
        state = (cell.float(), hide.float())
        if rest.shape[1]:
            xg = self.lstm.x_gates(rest.reshape(-1, *rest.shape[2:])).reshape(b, rest.shape[1], -1, h8, w8)
            for k in range(rest.shape[1]):
                state = self.lstm(state, xg[:, k])
                hides.append(state[1].to(z.dtype))

        hides = torch.stack(hides, dim=1).reshape(b * t, -1, h8, w8)
        heat = self.head(hides.contiguous(memory_format=torch.channels_last))
        return heat.float().reshape(b, t, self.num_classes + 1, h8, w8), state
