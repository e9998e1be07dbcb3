"""Conv beat-tracking encoder family in PyTorch (NCHW).

Port of zeronotesamba_tpu/models/encoder.py, with the reference's module
names (zeroNoteSamba/models/models.py), so reference ``.pth`` state dicts load
as they are:

- ``Encoder``         == ``_CNN``: 8 Conv2d layers ``cv1``..``cv8`` over
  (freq=96, time=T), channels 1-64-64-128-128-256-256-128-128, odd kernels
  with SAME padding, frequency max-pools (3,1)/(4,1)/(8,1) after convs 2/4/6
  (96 -> 1), ReLU + Dropout(0.1) after every conv. (B, 1, 96, T) -> (B, 128, T).
- ``BeatHead``        == the Conv1d(128 -> 1, k=1) ``fc1`` + sigmoid.
- ``DSCNN``           == ``DS_CNN``: ``pretrained`` encoder + head -> (B, T) pulse.
- ``TwinPretext``     == ``Pretext_CNN``: independent ``anchor``/``postve`` DSCNNs.
- ``FusedDownstream`` == ``Down_CNN``: elementwise max (or mean) of the two pulses.

JAX choices kept: the fixed input standardization ``(x + 6) / 5``
(``INPUT_MEAN``, ``INPUT_STD``), He-normal init by default
(``weight_init="torch"`` for the torch default), the conv -> pool -> ReLU ->
dropout order, float32 output, and ``compute_dtype`` float32 by default
(bfloat16 as an option). On the float32 path the caller
turns TF32 off (device.disable_tf32), or cuDNN runs the convs in TF32.
The convs stay cuDNN, as the JAX package left them to XLA.

Dropout in training mode is Flax's: each cell is kept with probability
1 - rate and scaled by 1 / (1 - rate). Its mask is drawn from the
``generator`` the forward pass is given (on the input's device), or from
torch's default generator without one, so a seeded training run repeats
its masks exactly. Eval mode draws nothing.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

CONV_SPECS: Sequence[Tuple[int, Tuple[int, int]]] = (
    (64, (3, 11)),
    (64, (7, 13)),
    (128, (5, 15)),
    (128, (9, 17)),
    (256, (3, 19)),
    (256, (5, 21)),
    (128, (1, 23)),
    (128, (1, 25)),
)
# Frequency pool window after conv index (0-based): 96 -> 32 -> 8 -> 1.
POOL_AFTER = {1: 3, 3: 4, 5: 8}
EMBED_DIM = 128
WEIGHT_INITS = ("he", "torch")
# Fixed input standardization: log-VQT magnitudes sit around -6 with spread 5.
INPUT_MEAN = -6.0
INPUT_STD = 5.0


def _he_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """Flax ``he_normal``: truncated normal at +-2 sd, variance 2/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978  # sd of N(0,1) truncated to [-2, 2]
    # Redraw the draws outside [-2, 2], in index order, until none is left:
    # exact, and far faster than nn.init.trunc_normal_'s inverse-CDF
    # sampling at these sizes. Each round touches only the cells still out.
    z = torch.randn(w.numel(), generator=generator)
    out = (z.abs() > 2.0).nonzero().squeeze(1)
    while out.numel():
        redraw = torch.randn(out.numel(), generator=generator)
        z[out] = redraw
        out = out[redraw.abs() > 2.0]
    w.copy_(z.view(w.shape) * std)


def _torch_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    """torch Conv default (kaiming_uniform a=sqrt(5)) = U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound, generator=generator)


class Encoder(nn.Module):
    """The 8-conv trunk: (B, 1, 96, T) -> (B, 128, T) float32."""

    def __init__(
        self,
        dropout_rate: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
        *,
        weight_init: str = "he",
    ):
        super().__init__()
        if weight_init not in WEIGHT_INITS:
            raise ValueError(f"weight_init must be one of {WEIGHT_INITS}")
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.weight_init = weight_init
        cin = 1
        for i, (cout, (kh, kw)) in enumerate(CONV_SPECS):
            self.add_module(f"cv{i + 1}", nn.Conv2d(cin, cout, (kh, kw), padding=(kh // 2, kw // 2)))
            cin = cout
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i in range(len(CONV_SPECS)):
            conv = getattr(self, f"cv{i + 1}")
            with torch.no_grad():
                if self.weight_init == "torch":
                    _torch_uniform_(conv.weight, conv.weight[0].numel(), generator)
                    _torch_uniform_(conv.bias, conv.weight[0].numel(), generator)
                else:
                    _he_normal_(conv.weight, generator)
                    conv.bias.zero_()

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0.0:
            return h
        keep = 1.0 - self.dropout_rate
        kept = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(kept, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if x.ndim != 4 or x.shape[1] != 1:
            raise ValueError("Encoder expects (B, 1, freq, time)")
        h = ((x - INPUT_MEAN) / INPUT_STD).to(self.compute_dtype)
        for i in range(len(CONV_SPECS)):
            conv = getattr(self, f"cv{i + 1}")
            h = F.conv2d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), padding=conv.padding)
            if i in POOL_AFTER:
                w = POOL_AFTER[i]
                h = F.max_pool2d(h, kernel_size=(w, 1), stride=(w, 1))
            h = F.relu(h)
            h = self._dropout(h, generator)
        # (B, 128, 1, T) -> (B, 128, T)
        return h.squeeze(2).float()


class BeatHead(nn.Conv1d):
    """The 1x1 conv head + sigmoid: (B, 128, T) -> (B, T) per-frame beat
    activation. It is the Conv1d(128 -> 1, k=1) itself, so its parameters
    carry the reference's ``fc1`` names."""

    def __init__(self):
        super().__init__(EMBED_DIM, 1, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            _torch_uniform_(self.weight, EMBED_DIM, generator)
            _torch_uniform_(self.bias, EMBED_DIM, generator)

    def logits(self, emb: torch.Tensor) -> torch.Tensor:
        return super().forward(emb)[:, 0, :]

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(emb))


class DSCNN(nn.Module):
    """Encoder + beat head (reference DS_CNN): (B, 1, 96, T) -> (B, T)."""

    def __init__(self, dropout_rate: float = 0.1, compute_dtype: torch.dtype = torch.float32, *,
                 weight_init: str = "he"):
        super().__init__()
        self.pretrained = Encoder(dropout_rate, compute_dtype, weight_init=weight_init)
        self.fc1 = BeatHead()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.pretrained.reset_parameters(generator)
        self.fc1.reset_parameters(generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.fc1(self.pretrained(x, generator))

    def logits(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.fc1.logits(self.pretrained(x, generator))

    def embed(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.pretrained(x, generator)


class TwinPretext(nn.Module):
    """Independent anchor/positive DSCNNs (reference Pretext_CNN)."""

    def __init__(self, dropout_rate: float = 0.1, compute_dtype: torch.dtype = torch.float32, *,
                 weight_init: str = "he"):
        super().__init__()
        self.anchor = DSCNN(dropout_rate, compute_dtype, weight_init=weight_init)
        self.postve = DSCNN(dropout_rate, compute_dtype, weight_init=weight_init)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.anchor.reset_parameters(generator)
        self.postve.reset_parameters(generator)

    def forward(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None):
        return self.anchor(anc, generator), self.postve(pos, generator)

    def logits(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None):
        return self.anchor.logits(anc, generator), self.postve.logits(pos, generator)


class FusedDownstream(nn.Module):
    """Twin network with max/mean stream fusion (reference Down_CNN).

    ``freq_s2d`` is accepted as the JAX model takes it and has no effect: it
    names convs the JAX package computes through an exact frequency
    space-to-depth fold, a TPU matrix-unit schedule whose outputs equal the
    plain conv's. Here every conv is a plain cuDNN conv.
    """

    def __init__(self, reduction: str = "max", dropout_rate: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32, *, weight_init: str = "he",
                 freq_s2d: Tuple[int, ...] = ()):
        super().__init__()
        del freq_s2d
        if reduction not in ("max", "mean"):
            raise ValueError("reduction must be 'max' or 'mean'")
        self.reduction = reduction
        self.pretext = TwinPretext(dropout_rate, compute_dtype, weight_init=weight_init)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.pretext.reset_parameters(generator)

    def fuse(self, anc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        if self.reduction == "mean":
            return (anc + pos) / 2.0
        return torch.maximum(anc, pos)

    def forward(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.fuse(*self.pretext(anc, pos, generator))

    def logits(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None):
        """Per-stream logits; with max fusion sigmoid(max(la, lb)) equals the
        fused probability exactly (sigmoid is monotonic)."""
        return self.pretext.logits(anc, pos, generator)
