"""Böck-style supervised beat-activation baseline (TCN over the log-VQT), in PyTorch.

Port of zeronotesamba_tpu/models/baseline.py, a temporal convolutional
network in the style of Böck & Davies 2019 that stands in for madmom's
pre-trained RNNBeatProcessor (reference measures.py:30,270-277), trained on
the same corpora as every other status (``status="bock"``):

- a 3-stage conv front end pools the 96 VQT bins to 1 (16 filters, 3x3,
  SAME padding, frequency-only max pools 3/4/8, each followed by ELU and
  dropout);
- 8 residual dilated 1-D conv blocks over time (kernel 5, dilations
  1..128, SAME padding, so 2·d each side; ELU; dropout; a 1x1 mix; ELU of
  the sum): about 2.7 s of receptive field at 62.5 fps;
- a dense projection of the 16 channels to per-frame beat logits.

Layout: input (B, 1, 96, T) as ``DSCNN`` takes it, the TCN in (B, 16, T).
Kept from the JAX model: the fixed input standardisation (x + 6) / 5,
Flax's default init (``lecun_normal`` kernels, zero biases), the convs in
``compute_dtype`` with a float32 embedding and head. Dropout in training
mode draws its masks from the ``generator`` the forward pass is given, as
the encoder's does. Parameter names follow the Flax tree (``front1``,
``tcn_d4.dilated``, ``head``), so models/weights.py maps one onto the other.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.models.encoder import INPUT_MEAN, INPUT_STD, fan_in_truncated_normal_, flax_dropout

TCN_CHANNELS = 16
TCN_KERNEL = 5
TCN_DILATIONS: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)
POOLS = (3, 4, 8)  # 96 -> 32 -> 8 -> 1


def _conv(conv: nn.Module, h: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` (F.conv1d / F.conv2d) with conv's weights in h's dtype."""
    return fn(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), padding=conv.padding, dilation=conv.dilation)


class TCNBlock(nn.Module):
    """Residual dilated conv block: (B, C, T) -> (B, C, T)."""

    def __init__(self, dilation: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dilated = nn.Conv1d(TCN_CHANNELS, TCN_CHANNELS, TCN_KERNEL, dilation=dilation,
                                 padding=(TCN_KERNEL - 1) // 2 * dilation)
        self.mix = nn.Conv1d(TCN_CHANNELS, TCN_CHANNELS, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = F.elu(_conv(self.dilated, x, F.conv1d))
        h = flax_dropout(h, self.dropout_rate, self.training, generator)
        return F.elu(x + _conv(self.mix, h, F.conv1d))


class BockTCN(nn.Module):
    """(B, 1, 96, T) log-VQT -> (B, T) beat activation, with the call surface
    of ``DSCNN`` (``forward`` / ``logits`` / ``embed``)."""

    def __init__(self, dropout_rate: float = 0.1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        cin = 1
        for i in range(len(POOLS)):
            self.add_module(f"front{i + 1}", nn.Conv2d(cin, TCN_CHANNELS, 3, padding=1))
            cin = TCN_CHANNELS
        for d in TCN_DILATIONS:
            self.add_module(f"tcn_d{d}", TCNBlock(d, dropout_rate))
        self.head = nn.Linear(TCN_CHANNELS, 1)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's default init: lecun_normal kernels, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                    fan_in_truncated_normal_(m.weight, 1.0, generator)
                    m.bias.zero_()

    def embed(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 1, 96, T) -> (B, 16, T) float32."""
        if x.ndim != 4 or x.shape[1] != 1:
            raise ValueError("BockTCN expects (B, 1, freq, time)")
        h = ((x - INPUT_MEAN) / INPUT_STD).to(self.compute_dtype)
        for i, pool in enumerate(POOLS):
            h = _conv(getattr(self, f"front{i + 1}"), h, F.conv2d)
            h = F.max_pool2d(h, kernel_size=(pool, 1), stride=(pool, 1))
            h = flax_dropout(F.elu(h), self.dropout_rate, self.training, generator)
        h = h.squeeze(2)  # (B, C, T)
        for d in TCN_DILATIONS:
            h = getattr(self, f"tcn_d{d}")(h, generator)
        return h.float()

    def logits(self, x: torch.Tensor, generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        if mesh is not None:
            raise NotImplementedError("BockTCN has no mesh path: its convs take no halo exchange")
        return self.head(self.embed(x, generator).transpose(1, 2))[..., 0]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.sigmoid(self.logits(x, generator))
