"""Harmonic/percussive source separation (median-filtering HPSS) in PyTorch.

Port of zeronotesamba_tpu/ops/hpss.py: STFT -> time/frequency median masks
-> inverse STFT, batched. The STFT pair is written out by hand as in the JAX
package (reflect pad n_fft//2, periodic Hann, overlap-add normalized by the
summed squared window with a 1e-8 floor); ``torch.istft`` normalizes
differently and is not used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.ops.vqt import _reflect_pad_last
from zeronotesamba_torch.utils import profiling


def _hann(n: int, device: torch.device) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / n)


def _stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, F, T) complex STFT, centered, periodic Hann."""
    ypad = _reflect_pad_last(y, n_fft // 2)
    n_frames = 1 + y.shape[-1] // hop
    frames = ypad.unfold(-1, n_fft, hop)[:, :n_frames]  # (B, T, n_fft)
    spec = torch.fft.rfft(frames * _hann(n_fft, y.device), dim=-1)
    return spec.transpose(1, 2)  # (B, F, T)


def _istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """(B, F, T) -> (B, length) overlap-add inverse with Hann synthesis."""
    win = _hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n_fft, dim=-1) * win  # (B, T, n_fft)
    b, n_frames = frames.shape[:2]
    out_len = length + n_fft
    idx = (torch.arange(n_frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    sig = torch.zeros((b, out_len), dtype=frames.dtype, device=spec.device)
    sig.index_add_(1, idx, frames.reshape(b, -1))
    norm = torch.zeros(out_len, dtype=frames.dtype, device=spec.device)
    norm.index_add_(0, idx, (win * win).repeat(n_frames))
    sig = sig / torch.clamp(norm, min=1e-8)
    pad = n_fft // 2
    return sig[:, pad : pad + length]


def _median_filter_axis(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Median filter along one axis with edge padding (size odd)."""
    half = size // 2
    xm = x.movedim(axis, -1)
    xp = torch.cat([xm[..., :1].expand(*xm.shape[:-1], half), xm, xm[..., -1:].expand(*xm.shape[:-1], half)], dim=-1)
    med = xp.unfold(-1, size, 1).median(dim=-1).values
    return med.movedim(-1, axis)


def hpss(y: torch.Tensor, n_fft: int = 2048, hop: int = 512, kernel: int = 17, power: float = 2.0):
    """(B, L) -> (harmonic, percussive) waveforms, both (B, L)."""
    if y.ndim != 2:
        raise ValueError("hpss expects (batch, samples)")
    y = y.float()
    spec = _stft(y, n_fft, hop)
    mag = spec.abs()
    harm = _median_filter_axis(mag, kernel, axis=2)  # smooth over time
    perc = _median_filter_axis(mag, kernel, axis=1)  # smooth over frequency
    hp = harm**power
    pp = perc**power
    denom = hp + pp + 1e-10
    length = y.shape[-1]
    h = _istft(spec * (hp / denom), n_fft, hop, length)
    p = _istft(spec * (pp / denom), n_fft, hop, length)
    return h, p


def hpss_host(y: np.ndarray, device: str | torch.device = "cuda", **kw):
    """Single-signal wrapper: mono numpy -> (harmonic, percussive) numpy,
    computed on ``device``."""
    x = profiling.to_device(np.asarray(y, dtype=np.float32), resolve_device(device))[None, :]
    with torch.inference_mode():
        h, p = hpss(x, **kw)
    return profiling.to_host(h[0]), profiling.to_host(p[0])
