"""Spleeter 4stems (Hennequin, Khlif, Voituret, Moussallam, JOSS 2020;
github.com/deezer/spleeter) as the port's ``spleeter`` separation backend.

A mono song at 44,100 Hz (another rate is resampled on the device first)
goes to (anchor, positive) at 16 kHz, as every other backend hands them on:

1. ``ops/stft44.stft`` (4,096 / 1,024, Spleeter's conventions); |X| over the
   first ``F`` bins, its frames zero-padded to a multiple of ``T`` and cut
   into segments (``pad_and_partition``): (S, T, F), both channels of the
   stereo input being that one magnitude (``to_stereo`` duplicates a mono
   song).
2. One ``UNet`` an instrument (vocals, drums, bass, other), each net's S
   segments as one batch, NCHW (height time, width frequency):
   - six 5x5 stride-2 ``Conv2d`` of ``filters`` channels, TensorFlow's
     ``"same"`` padding (1 before, 2 after on each axis of an even input),
     each followed by BatchNorm (eps 1e-3) and LeakyReLU(0.2); the convs'
     pre-BatchNorm outputs c1..c6 are the skips (the source's last
     BatchNorm and activation feed nothing and are not run);
   - six 5x5 stride-2 ``ConvTranspose2d`` (the full output cropped by 1
     before and 2 after, the adjoint of that padding): u1 =
     BN(ReLU(deconv(c6))), then u_k = BN(ReLU(deconv([c_{7-k}, u_{k-1}])));
     dropout 0.5 after the first three (inactive here). On a card in eval
     with grad off, each such block is one launch of the port's own float32
     kernel (``ops/cuda/deconv_kernel.decoder_block``, csrc/deconv_fprop.cu:
     the concat, transposed conv, crop, ReLU and BatchNorm together);
     otherwise the modules run as written;
   - out = sigmoid(Conv2d(1 -> 2, 4x4, dilation 2, padding 3)(u6)) * |X|.
3. Ratio masks M_i = (out_i^2 + 1e-10 / 4) / (sum_j out_j^2 + 1e-10), cut
   back to the STFT's frames and extended with zeros from bin ``F`` to 2,049
   (``mask_extension: zeros``); the anchor is the instruments but drums
   folded in the STFT domain (iSTFT is linear) and its two channels
   averaged before the inverse, the positive the drums': two
   ``ops/stft44.istft`` in place of eight.
4. Both streams to 16 kHz at once (``ops/resample.resample_polyphase_device``).

``Spleeter.separate`` uploads the song once and downloads both streams
once. The stages run on the song zero-padded to its segments' grid, which
changes none of its own samples (``Spleeter._stages``), so every song of S
segments has the same shapes: on a card each stage is a CUDA graph,
captured at the first call of an S and replayed after, those of the last
``GRAPHS_KEPT`` counts kept. A net's strided convs, BatchNorms and
decoder blocks are dozens of kernels, which the host would otherwise launch
one by one. ``Spleeter.last`` holds that call's magnitude, masks and streams on
the device (no copy) for a caller that inspects them; on a card they are
the graphs' own tensors, which the next call of that S overwrites.
Float32: on a card it turns TF32 off (``device.disable_tf32``). Spans,
around each stage or its replay: ``spleeter.stft`` (and, eagerly, the
resample of another rate to 44.1 kHz), ``spleeter.unet``, ``spleeter.masks``
(masks and iSTFT), ``spleeter.resample``; counters ``spleeter.segments`` (S
a song), ``spleeter.unet_launch`` (a net's forward: 4 a song) and
``spleeter.deconv_launch`` (the decoder kernel's launches a song: 24 on a
card, one a net and block, 0 on the CPU). A graph replay runs no Python, so
the launches are counted when the stages run eagerly and kept with that
segment count's graphs.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.device import disable_tf32
from zeronotesamba_torch.ops import stft44
from zeronotesamba_torch.ops.cuda import deconv_kernel
from zeronotesamba_torch.ops.resample import resample_polyphase_device, resampled_length
from zeronotesamba_torch.utils import profiling

SAMPLE_RATE = 44100
OUT_RATE = 16000
INSTRUMENTS = ("vocals", "drums", "bass", "other")
SAME = (1, 2, 1, 2)  # TensorFlow's "same" at stride 2, kernel 5, even size: (left, right, top, bottom)
GRAPHS_KEPT = 4  # segment counts whose stages' CUDA graphs a Spleeter keeps


@dataclasses.dataclass(frozen=True)
class SpleeterConfig:
    """The 4stems model's sizes (``spleeter/resources/4stems.json`` and
    ``apply_unet``'s defaults)."""

    filters: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    T: int = 512
    F: int = 1024
    instruments: Tuple[str, ...] = INSTRUMENTS
    bn_eps: float = 1e-3
    leaky_slope: float = 0.2
    dropout: float = 0.5
    epsilon: float = 1e-10

    @classmethod
    def from_state_dict(cls, sd) -> "SpleeterConfig":
        """The sizes a state dict of ``Spleeter`` holds."""
        names = tuple(dict.fromkeys(k.split(".")[1] for k in sd if k.startswith("nets.")))
        first = names[0]
        filters = tuple(int(sd[f"nets.{first}.enc.{i}.weight"].shape[0]) for i in range(6))
        return cls(filters=filters, instruments=names)


class UNet(nn.Module):
    """One instrument's net (module docstring, step 2)."""

    def __init__(self, cfg: SpleeterConfig = SpleeterConfig()):
        super().__init__()
        f = cfg.filters
        self.leaky_slope = cfg.leaky_slope
        self.enc = nn.ModuleList(nn.Conv2d(cin, cout, 5, stride=2) for cin, cout in zip((2,) + f[:-1], f))
        self.enc_bn = nn.ModuleList(nn.BatchNorm2d(c, eps=cfg.bn_eps) for c in f)
        outs = f[-2::-1] + (1,)  # 256, 128, 64, 32, 16, 1
        ins = (f[-1],) + tuple(2 * c for c in f[-2::-1])  # c6, then [c_k, u] pairs
        self.dec = nn.ModuleList(nn.ConvTranspose2d(cin, cout, 5, stride=2, padding=1) for cin, cout in zip(ins, outs))
        self.dec_bn = nn.ModuleList(nn.BatchNorm2d(c, eps=cfg.bn_eps) for c in outs)
        self.drop = nn.Dropout(cfg.dropout)
        self.head = nn.Conv2d(1, 2, 4, dilation=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 2, T, F) magnitudes -> the net's (N, 2, T, F) estimate."""
        skips, h = [], x
        for k, (conv, bn) in enumerate(zip(self.enc, self.enc_bn)):
            skips.append(down(conv, h))
            if k < len(self.enc) - 1:
                h = F.leaky_relu(bn(skips[-1]), self.leaky_slope)
        u = skips[-1]
        fused = takes_kernel(x, self.training)
        for k, (deconv, bn) in enumerate(zip(self.dec, self.dec_bn)):
            if fused:
                u = deconv_kernel.decoder_block(skips[-1 - k] if k else None, u, deconv, bn)
                continue
            if k:
                u = torch.cat([skips[-1 - k], u], dim=1)
            u = bn(F.relu(up(deconv, u)))
            if k < 3:
                u = self.drop(u)
        return torch.sigmoid(self.head(u)) * x


def takes_kernel(x, training: bool) -> bool:
    """Whether ``UNet.forward`` runs its decoder blocks as the port's kernel:
    on a card, in float32, with grad off and the net in eval (the kernel has
    no backward, and dropout and BatchNorm act as in eval)."""
    return x.is_cuda and x.dtype == torch.float32 and not torch.is_grad_enabled() and not training


def down(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A stride-2 conv with TensorFlow's "same" padding: (..., h, w) -> (..., h / 2, w / 2)."""
    return conv(F.pad(x, SAME))


def up(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``down``: (..., h, w) -> (..., 2 h, 2 w), the full
    transposed output cropped by 1 before and 2 after (``padding=1`` crops 1
    on each side; the last row and column go here)."""
    return deconv(x)[..., :-1, :-1]


def pad_and_partition(x: torch.Tensor, t: int) -> torch.Tensor:
    """(frames, ...) -> (S, t, ...): zero frames appended to a multiple of ``t``."""
    pad = -x.shape[0] % t
    x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
    return x.view((-1, t) + x.shape[1:])


class Spleeter(nn.Module):
    """The four nets, the masks and the separation path (module docstring)."""

    def __init__(self, cfg: SpleeterConfig = SpleeterConfig()):
        super().__init__()
        self.cfg = cfg
        self.nets = nn.ModuleDict({name: UNet(cfg) for name in cfg.instruments})
        self.last: dict = {}
        self._graphs: OrderedDict = OrderedDict()  # S -> the stages' CUDA graphs and their tensors

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Seeded weights: conv and transposed-conv weights and biases
        U(+-1/sqrt(input channels x taps)); BatchNorm gains U(0.8, 1.2),
        shifts and running means N(0, 0.1^2), running variances U(0.5, 1.5)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    cin = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
                    bound = 1.0 / math.sqrt(cin * m.weight.shape[2] * m.weight.shape[3])
                    for p in (m.weight, m.bias):
                        p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * bound)
                elif isinstance(m, nn.BatchNorm2d):
                    m.weight.copy_(0.8 + 0.4 * torch.rand(m.weight.shape, generator=gen))
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                    m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))

    def masks(self, mag: torch.Tensor) -> torch.Tensor:
        """(S, 2, T, F) magnitudes -> (instruments, S, 2, T, F) ratio masks."""
        power = torch.stack([net(mag) for net in self.nets.values()]) ** 2
        eps = self.cfg.epsilon
        return (power + eps / power.shape[0]) / (power.sum(0) + eps)

    def stream_masks(self, masks: torch.Tensor, frames: int) -> torch.Tensor:
        """(instruments, S, 2, T, F) masks -> the anchor's (every instrument
        but drums) and the positive's (drums), each the mean of its two
        channels, joined, cut to ``frames`` and extended with zeros to every
        bin: (2, frames, 2,049)."""
        names = self.cfg.instruments
        anchor = sum(masks[i] for i, name in enumerate(names) if name != "drums")
        folded = torch.stack([anchor, masks[names.index("drums")]]).mean(2)  # (2, S, T, F)
        return F.pad(folded.flatten(1, 2)[:, :frames], (0, stft44.BINS - self.cfg.F))

    def segments(self, samples: int) -> int:
        """S: the segments of a song of ``samples`` at 44.1 kHz."""
        return -(-stft44.n_frames(samples) // self.cfg.T)

    def _stages(self) -> list:
        """The device's stages, (span, function of the tensors so far -> new
        tensors), from the song zero-padded to its segments' grid (1, S T HOP -
        FRAME) and its own length (a 0-d tensor) to the 16 kHz streams of the
        padded length. The padding's frames read only zeros, so every mask and
        stem sample of the song's own length is the song's own; the stems are
        zeroed past that length before the resample, which then gives the
        song's outputs first."""

        def analyse(t):
            spec = stft44.stft(t["song"])[0]  # (S T, 2,049)
            mag = pad_and_partition(spec[:, :self.cfg.F].abs(), self.cfg.T)[:, None].expand(-1, 2, -1, -1)
            return {"spec": spec, "magnitude": mag}

        def invert(t):
            n = t["song"].shape[-1]
            stems = stft44.istft(self.stream_masks(t["masks"], t["spec"].shape[0]) * t["spec"], n)
            return {"stems": stems * (torch.arange(n, device=stems.device) < t["length"])}

        return [("spleeter.stft", analyse), ("spleeter.unet", lambda t: {"masks": self.masks(t["magnitude"])}),
                ("spleeter.masks", invert),
                ("spleeter.resample", lambda t: {"streams": resample_polyphase_device(t["stems"], SAMPLE_RATE,
                                                                                      OUT_RATE)})]

    def _run(self, song: torch.Tensor) -> Tuple[dict, int]:
        """The stages on the song (1, L) at 44.1 kHz. On a card, the first
        call of a segment count S runs them and then captures each as a CUDA
        graph on their own tensors (the padded song and its length kept as
        the graphs' input); every later call of that S, whatever its length,
        copies its song in and replays them. The graphs of the last
        ``GRAPHS_KEPT`` segment counts used are kept. On the CPU they run.
        Returns the tensors and the decoder kernel's launches a call (those
        of the eager run, kept with the graphs)."""
        length = song.shape[-1]
        segments = self.segments(length)
        t = {"song": F.pad(song, (0, segments * self.cfg.T * stft44.HOP - stft44.FRAME - length)),
             "length": torch.full((), length, device=song.device)}
        if segments in self._graphs:
            self._graphs.move_to_end(segments)
            graphs, static, launches = self._graphs[segments]
            static["song"].copy_(t["song"])
            static["length"].copy_(t["length"])
            for name, graph in graphs:
                with profiling.span(name):
                    graph.replay()
            return static, launches
        before = profiling.totals("deconv_launch.").get("fprop", 0)
        for name, fn in self._stages():
            with profiling.span(name):
                t.update(fn(t))
        launches = profiling.totals("deconv_launch.").get("fprop", 0) - before
        if song.device.type == "cuda":
            graphs, static = [], {"song": t["song"].clone(), "length": t["length"].clone()}
            for name, fn in self._stages():
                graphs.append((name, torch.cuda.CUDAGraph()))
                with torch.cuda.graph(graphs[-1][1]):
                    static.update(fn(static))
            self._graphs[segments] = graphs, static, launches
            if len(self._graphs) > GRAPHS_KEPT:
                self._graphs.popitem(last=False)
        return t, launches

    def separate(self, signal: np.ndarray, sr: int = SAMPLE_RATE) -> Tuple[np.ndarray, np.ndarray]:
        """A mono song at ``sr`` -> (anchor, positive) float32 at 16 kHz."""
        dev = next(self.parameters()).device
        if dev.type == "cuda":
            disable_tf32()
        with torch.inference_mode():
            song = profiling.to_device(np.asarray(signal, dtype=np.float32), dev)[None]
            if sr != SAMPLE_RATE:
                with profiling.span("spleeter.stft"):
                    song = resample_polyphase_device(song, sr, SAMPLE_RATE)
            t, launches = self._run(song)
            profiling.count("spleeter.segments", t["magnitude"].shape[0])
            profiling.count("spleeter.unet_launch", len(self.nets))
            profiling.count("spleeter.deconv_launch", launches)
            streams = t["streams"][:, :resampled_length(song.shape[-1], SAMPLE_RATE, OUT_RATE)]
            self.last = {"magnitude": t["magnitude"], "masks": t["masks"], "streams": streams}
            out = profiling.to_host(streams)
        return out[0], out[1]
