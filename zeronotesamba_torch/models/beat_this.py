"""Beat This! (Foscarin, Schlueter, Widmer, ISMIR 2024; github.com/CPJKU/beat_this).

A beat and downbeat tracker over a 128-bin log-mel at 50 fps (``ops/mel.py``):

- stem: BatchNorm1d over the bins, Conv2d(1 -> 32, (4, 3), stride (4, 1)),
  BatchNorm2d, GELU;
- three frontend blocks at 32, 64 and 128 channels (32, 16, 8 bins): a
  partial transformer (attention and feed-forward over frequency, then over
  time) and Conv2d(c -> 2c, (2, 3), stride (2, 1)), BatchNorm2d, GELU;
- (B, 256, 4, T) -> (B, T, 1,024) -> Linear -> 512; six pre-norm layers of
  gated attention (16 heads of 32) and feed-forward (2,048); RMSNorm;
- Linear(512 -> 2), the beat logit summed with the downbeat's (``SumHead``).

Module and parameter names are the source's (``model/beat_tracker.py``,
``model/roformer.py``), so its state dicts load as they are
(``models/weights.load_beat_this_state_dict``); the sizes are read from the
state dict (``BeatThisConfig.from_state_dict``). Attention is written out:
q k^T as one batched product, softmax, p v as another, float32 (with TF32
off on a card, ``device.disable_tf32``): PyTorch's fused attention would
run float32 in split-TF32 arithmetic on an H100. Rotary angles are computed
in float64 and rounded once. Dropout (0.1 in the frontend, 0.2 in the
transformer) acts only in training mode.

Songs are cut into chunks of 1,500 frames with 6-frame borders, as the
source's ``split_piece`` / ``aggregate_prediction`` do, and a song's chunks
run as one batch (``split_chunks``, ``aggregate_chunks``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.utils import profiling

CHUNK_SIZE = 1500
BORDER = 6
ROPE_THETA = 10000.0
FRONTEND_DROPOUT = 0.1
TRANSFORMER_DROPOUT = 0.2


@dataclasses.dataclass(frozen=True)
class BeatThisConfig:
    n_mels: int = 128
    stem_dim: int = 32
    frontend_blocks: int = 3
    transformer_dim: int = 512
    n_layers: int = 6
    head_dim: int = 32
    ff_mult: int = 4

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]) -> "BeatThisConfig":
        """The sizes of the model whose state dict (source key names) is ``sd``."""
        dim = sd["frontend.linear.weight"].shape[0]
        blocks = {int(m.group(1)) for k in sd if (m := re.match(r"frontend\.blocks\.(\d+)\.conv2d\.weight$", k))}
        layers = {int(m.group(1)) for k in sd
                  if (m := re.match(r"transformer_blocks\.layers\.(\d+)\.0\.to_qkv\.weight$", k))}
        heads = sd["transformer_blocks.layers.0.0.to_gates.weight"].shape[0]
        return cls(n_mels=sd["frontend.stem.bn1d.weight"].shape[0],
                   stem_dim=sd["frontend.stem.conv2d.weight"].shape[0], frontend_blocks=len(blocks),
                   transformer_dim=dim, n_layers=len(layers), head_dim=dim // heads,
                   ff_mult=sd["transformer_blocks.layers.0.1.net.1.weight"].shape[0] // dim)


class Rotary:
    """Rotary position tables (interleaved pairs over every dim of a head),
    one a device, grown to the longest sequence asked for; a shorter one
    reads their first rows. Not a module: the source's copies of its
    frequencies in a state dict are checked and dropped when it loads
    (``models/weights``)."""

    def __init__(self, head_dim: int, theta: float = ROPE_THETA):
        self.head_dim, self.theta = head_dim, theta
        self._tables: Dict[str, tuple] = {}

    def inv_freq(self) -> torch.Tensor:
        return 1.0 / self.theta ** (torch.arange(0, self.head_dim, 2, dtype=torch.float64) / self.head_dim)

    def tables(self, n: int, device: torch.device) -> tuple:
        """(cos, sin, cos / sqrt(head_dim), sin / sqrt(head_dim)), each (n, head_dim // 2), float32."""
        held = self._tables.get(str(device))
        if held is None or held[0].shape[0] < n:
            ang = torch.arange(n, dtype=torch.float64)[:, None] * self.inv_freq()[None, :]
            scale = 1.0 / math.sqrt(self.head_dim)
            held = self._tables[str(device)] = tuple(t.float().to(device) for t in
                                                     (ang.cos(), ang.sin(), ang.cos() * scale, ang.sin() * scale))
        return tuple(t[:n] for t in held)


def rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotates each pair (x0, x1) of the last dim of ``t`` (..., n, d) by its
    angle: (x0 cos - x1 sin, x1 cos + x0 sin); ``cos``, ``sin`` (n, d // 2)."""
    pairs = t.unflatten(-1, (-1, 2))
    x0, x1 = pairs[..., 0], pairs[..., 1]
    return torch.stack((x0 * cos - x1 * sin, x1 * cos + x0 * sin), dim=-1).flatten(-2)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.normalize(x, dim=-1) * self.scale * self.gamma


class Attention(nn.Module):
    """Pre-norm gated multi-head attention with rotary positions over dim 1
    of (N, n, dim). ``kind`` ("freq", "time" or "global") names the counter
    ``attn_launch.<kind>`` a call adds one to."""

    def __init__(self, dim: int, head_dim: int, rotary: Rotary, dropout: float, kind: str):
        super().__init__()
        self.heads, self.head_dim, self.kind = dim // head_dim, head_dim, kind
        self.rotary, self.dropout = rotary, dropout
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_gates = nn.Linear(dim, self.heads)
        self.to_out = nn.Sequential(nn.Linear(dim, dim, bias=False), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        profiling.count(f"attn_launch.{self.kind}")
        n_seq, n, dim = x.shape
        heads, d = self.heads, self.head_dim
        h = self.norm(x)
        q, k, v = F.linear(h, self.to_qkv.weight).view(n_seq, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        cos, sin, cos_q, sin_q = self.rotary.tables(n, x.device)
        # Both products take contiguous row-major operands, q (.., n, d) by k^T (.., d, n) and p (.., n, n)
        # by v, so cuBLAS runs them as "nn" GEMMs, which no linear layer (x W^T, "tn") shares.
        q = rotate(q, cos_q, sin_q).reshape(n_seq * heads, n, d)
        kt = rotate(k, cos, sin).transpose(-1, -2).contiguous().view(n_seq * heads, d, n)
        p = torch.softmax(torch.bmm(q, kt), dim=-1)
        if self.training and self.dropout:
            p = F.dropout(p, self.dropout)
        o = torch.bmm(p, v.reshape(n_seq * heads, n, d)).view(n_seq, heads, n, d)
        gates = torch.sigmoid(F.linear(h, self.to_gates.weight, self.to_gates.bias))  # (N, n, heads)
        return self.to_out((o.transpose(1, 2) * gates[..., None]).reshape(n_seq, n, dim))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, dropout: float):
        super().__init__()
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, mult * dim), nn.GELU(), nn.Dropout(dropout),
                                 nn.Linear(mult * dim, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PartialFTTransformer(nn.Module):
    """Attention and feed-forward over frequency, then over time, on (B, C, F, T)."""

    def __init__(self, dim: int, head_dim: int, rotary: Rotary, dropout: float):
        super().__init__()
        self.attnF = Attention(dim, head_dim, rotary, dropout, "freq")
        self.ffF = FeedForward(dim, 4, dropout)
        self.attnT = Attention(dim, head_dim, rotary, dropout, "time")
        self.ffT = FeedForward(dim, 4, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, t = x.shape
        y = x.permute(0, 3, 2, 1).reshape(b * t, f, c)  # b c f t -> (b t) f c
        y = y + self.attnF(y)
        y = y + self.ffF(y)
        y = y.view(b, t, f, c).transpose(1, 2).reshape(b * f, t, c)  # -> (b f) t c
        y = y + self.attnT(y)
        y = y + self.ffT(y)
        return y.view(b, f, t, c).permute(0, 3, 1, 2)  # -> b c f t


class Stem(nn.Module):
    def __init__(self, n_mels: int, dim: int):
        super().__init__()
        self.bn1d = nn.BatchNorm1d(n_mels)
        self.conv2d = nn.Conv2d(1, dim, kernel_size=(4, 3), stride=(4, 1), padding=(0, 1), bias=False)
        self.bn2d = nn.BatchNorm2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, bins) -> (B, dim, bins // 4, T)
        return F.gelu(self.bn2d(self.conv2d(self.bn1d(x.transpose(1, 2))[:, None])))


class FrontendBlock(nn.Module):
    def __init__(self, dim: int, head_dim: int, rotary: Rotary, dropout: float):
        super().__init__()
        self.partial = PartialFTTransformer(dim, head_dim, rotary, dropout)
        self.conv2d = nn.Conv2d(dim, 2 * dim, kernel_size=(2, 3), stride=(2, 1), padding=(0, 1), bias=False)
        self.norm = nn.BatchNorm2d(2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv2d(self.partial(x))))


class Frontend(nn.Module):
    def __init__(self, cfg: BeatThisConfig, rotary: Rotary):
        super().__init__()
        self.stem = Stem(cfg.n_mels, cfg.stem_dim)
        dim, bins = cfg.stem_dim, cfg.n_mels // 4
        blocks = []
        for _ in range(cfg.frontend_blocks):
            blocks.append(FrontendBlock(dim, cfg.head_dim, rotary, FRONTEND_DROPOUT))
            dim, bins = dim * 2, bins // 2
        self.blocks = nn.ModuleList(blocks)
        self.linear = nn.Linear(dim * bins, cfg.transformer_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for block in self.blocks:
            h = block(h)
        return self.linear(h.permute(0, 3, 1, 2).flatten(2))  # b c f t -> b t (c f)


class Transformer(nn.Module):
    def __init__(self, cfg: BeatThisConfig, rotary: Rotary):
        super().__init__()
        dim, p = cfg.transformer_dim, TRANSFORMER_DROPOUT
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, cfg.head_dim, rotary, p, "global"), FeedForward(dim, cfg.ff_mult, p)])
            for _ in range(cfg.n_layers))
        self.norm = RMSNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return self.norm(x)


class SumHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.beat_downbeat_lin = nn.Linear(dim, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.beat_downbeat_lin(x)
        return out[..., 0] + out[..., 1], out[..., 1]


class BeatThis(nn.Module):
    """(B, T, n_mels) log-mels -> (beat, downbeat) logits, (B, T) each."""

    def __init__(self, cfg: BeatThisConfig = BeatThisConfig()):
        super().__init__()
        self.cfg = cfg
        self.rotary = Rotary(cfg.head_dim)
        self.frontend = Frontend(cfg, self.rotary)
        self.transformer_blocks = Transformer(cfg, self.rotary)
        self.task_heads = SumHead(cfg.transformer_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.task_heads(self.transformer_blocks(self.frontend(x)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default draws (Linear and Conv: U(+-1/sqrt(fan_in)) for
        weights and biases), BatchNorm and RMSNorm at their identities, from
        ``generator``, on the CPU."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, (nn.Linear, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(module.weight[0].numel())
                    module.weight.uniform_(-bound, bound, generator=generator)
                    if module.bias is not None:
                        module.bias.uniform_(-bound, bound, generator=generator)
                elif isinstance(module, nn.modules.batchnorm._BatchNorm):
                    module.reset_parameters()


def chunk_starts(frames: int, size: int = CHUNK_SIZE, border: int = BORDER) -> List[int]:
    """Chunk starts of a piece of ``frames``: every ``size - 2 border`` from
    ``-border``, the last moved so the chunk ends with the piece."""
    starts = list(range(-border, frames - border, size - 2 * border))
    if frames > size - 2 * border:
        starts[-1] = frames - (size - border)
    return starts


def split_chunks(spec: torch.Tensor, size: int = CHUNK_SIZE, border: int = BORDER) -> Tuple[torch.Tensor, List[int]]:
    """(T, bins) -> ((C, L, bins) chunks, their starts): each chunk zero-padded
    at the piece's borders. A piece of at most ``size - 2 border`` frames is
    one chunk of T + 2 border frames; otherwise every chunk is ``size`` long."""
    frames = spec.shape[0]
    starts = chunk_starts(frames, size, border)
    padded = F.pad(spec, (0, 0, border, border))
    if frames <= size - 2 * border:
        return padded[None], starts
    return torch.stack([padded[s + border: s + border + size] for s in starts]), starts


def aggregate_chunks(preds: np.ndarray, starts: List[int], frames: int, size: int = CHUNK_SIZE,
                     border: int = BORDER) -> np.ndarray:
    """(C, L, k) chunk predictions -> (frames, k): each chunk's borders
    dropped, the earlier chunk kept where two overlap, -1000 where none reaches."""
    out = np.full((frames,) + preds.shape[2:], -1000.0, dtype=preds.dtype)
    for s, p in zip(reversed(starts), preds[::-1]):
        lo, hi = s + border, min(s + size - border, frames)
        out[lo:hi] = p[border: border + hi - lo]
    return out
