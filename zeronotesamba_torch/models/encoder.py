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
(bfloat16 as an option). A float32 conv goes through
``ops/cuda/conv_kernel.conv2d``: on a card its forward is the port's own
kernel (csrc/conv_fprop.cu, float32 FFMA) and its backward cuDNN's, on the
CPU it is ``F.conv2d``. A bfloat16 conv is ``F.conv2d`` (cuDNN on a card).
The JAX package leaves the convs to XLA. On the float32 path the caller
turns TF32 off (device.disable_tf32), or cuDNN runs the backward in TF32.

Dropout in training mode is Flax's: each cell is kept with probability
1 - rate and scaled by 1 / (1 - rate). Its mask is drawn from the
``generator`` the forward pass is given (on the input's device), or from
torch's default generator without one, so a seeded training run repeats
its masks exactly. Eval mode draws nothing.

On a mesh (parallel/mesh.py; the ``mesh`` argument of every forward, None
by default) the encoder reads this rank's frames of its songs and, with a
model axis, its share of every conv's output channels (``shard_params_tp``).
Each conv then takes its halo frames from its time neighbours
(parallel/sequence.py) and its output channels are gathered over the model
ranks after dropout (parallel/tensor.py); the pools are frequency-only and
need no exchange. The output is this rank's frames, all 128 channels.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.ops.cuda import conv_kernel
from zeronotesamba_torch.parallel import sequence, tensor

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


def fan_in_truncated_normal_(w: torch.Tensor, scale: float, generator: torch.Generator | None) -> None:
    """Flax ``variance_scaling(scale, "fan_in", "truncated_normal")``: a normal
    truncated at +-2 sd with variance scale/fan_in, where fan_in is the size
    of one output unit's weights (``he_normal`` at scale 2, ``lecun_normal``
    at 1)."""
    fan_in = w[0].numel()
    std = math.sqrt(scale / fan_in) / 0.87962566103423978  # sd of N(0,1) truncated to [-2, 2]
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


def conv2d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: Tuple[int, int]) -> torch.Tensor:
    """One encoder conv at stride 1: float32 through the port's conv
    (``conv_kernel.conv2d``), any other dtype through ``F.conv2d``."""
    if h.dtype == torch.float32:
        return conv_kernel.conv2d(h, w, b, padding)
    return F.conv2d(h, w, b, padding=padding)


def _torch_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    """torch Conv default (kaiming_uniform a=sqrt(5)) = U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound, generator=generator)


def flax_dropout(h: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Flax's dropout in training mode (each cell kept with probability
    1 - rate, scaled by 1 / (1 - rate)), its mask drawn from ``generator``;
    the identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return h
    keep = 1.0 - rate
    kept = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(kept, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


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
                    fan_in_truncated_normal_(conv.weight, 2.0, generator)  # Flax he_normal
                    conv.bias.zero_()

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return flax_dropout(h, self.dropout_rate, self.training, generator)

    def _conv(self, i: int, h: torch.Tensor, mesh) -> torch.Tensor:
        """Conv ``i`` with SAME padding; on a mesh, over this rank's frames
        and output channels."""
        conv = getattr(self, f"cv{i + 1}")
        w, b = conv.weight.to(h.dtype), conv.bias.to(h.dtype)
        if mesh is None:
            return conv2d(h, w, b, conv.padding)
        if w.shape[0] * mesh.shape["model"] != CONV_SPECS[i][0]:
            raise ValueError(f"cv{i + 1} holds {w.shape[0]} output channels on a model axis of "
                             f"{mesh.shape['model']}: shard the parameters with shard_params_tp")
        kh, kw = conv.kernel_size
        h = sequence.exchange_halo(tensor.replicated_input(h, mesh), kw // 2, mesh)
        return conv2d(h, w, b, (kh // 2, 0))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        if x.ndim != 4 or x.shape[1] != 1:
            raise ValueError("Encoder expects (B, 1, freq, time)")
        h = ((x - INPUT_MEAN) / INPUT_STD).to(self.compute_dtype)
        for i in range(len(CONV_SPECS)):
            h = self._conv(i, h, mesh)
            if i in POOL_AFTER:
                w = POOL_AFTER[i]
                h = F.max_pool2d(h, kernel_size=(w, 1), stride=(w, 1))
            h = F.relu(h)
            h = self._dropout(h, generator)
            if mesh is not None:
                h = tensor.gather_channels(h, mesh)
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

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        return self.fc1(self.pretrained(x, generator, mesh))

    def logits(self, x: torch.Tensor, generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        return self.fc1.logits(self.pretrained(x, generator, mesh))

    def embed(self, x: torch.Tensor, generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        return self.pretrained(x, generator, mesh)


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

    def forward(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None, mesh=None):
        return self.anchor(anc, generator, mesh), self.postve(pos, generator, mesh)

    def logits(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None, mesh=None):
        return self.anchor.logits(anc, generator, mesh), self.postve.logits(pos, generator, mesh)


class FusedDownstream(nn.Module):
    """Twin network with max/mean stream fusion (reference Down_CNN).

    ``freq_s2d`` is accepted as the JAX model takes it and has no effect: it
    names convs the JAX package computes through an exact frequency
    space-to-depth fold, a TPU matrix-unit schedule whose outputs equal the
    plain conv's. Here every conv is a plain conv (``conv2d``).
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

    def forward(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None,
                mesh=None) -> torch.Tensor:
        return self.fuse(*self.pretext(anc, pos, generator, mesh))

    def logits(self, anc: torch.Tensor, pos: torch.Tensor, generator: torch.Generator | None = None, mesh=None):
        """Per-stream logits; with max fusion sigmoid(max(la, lb)) equals the
        fused probability exactly (sigmoid is monotonic)."""
        return self.pretext.logits(anc, pos, generator, mesh)
