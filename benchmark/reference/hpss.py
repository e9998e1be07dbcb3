"""Median-filtering harmonic/percussive separation (Fitzgerald 2010), plainly.

STFT with a periodic Hann window (n_fft 2048, hop 512, centred by a reflect
pad of n_fft/2), medians over 17 frames (harmonic) and 17 bins
(percussive) with edge padding, Wiener-like soft masks at power 2 (plus
1e-10), and an overlap-add inverse divided by the summed squared window
(floored at 1e-8). Returns (harmonic, percussive) of the input's length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_FFT, HOP, KERNEL = 2048, 512, 17


def _window(device) -> torch.Tensor:
    n = torch.arange(N_FFT, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.movedim(dim, -1)
    h = KERNEL // 2
    x = torch.cat([x[..., :1].expand(*x.shape[:-1], h), x, x[..., -1:].expand(*x.shape[:-1], h)], dim=-1)
    return x.unfold(-1, KERNEL, 1).median(dim=-1).values.movedim(-1, dim)


def hpss(y: torch.Tensor):
    """(B, L) float32 -> (harmonic, percussive), each (B, L)."""
    n = y.shape[-1]
    win = _window(y.device)
    frames = F.pad(y[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = frames.unfold(-1, N_FFT, HOP)[:, : 1 + n // HOP]
    spec = torch.fft.rfft(frames * win, dim=-1)  # (B, T, F)
    mag = spec.abs()
    h = _median(mag, 1) ** 2
    p = _median(mag, 2) ** 2
    den = h + p + 1e-10
    t = spec.shape[1]
    pos = (torch.arange(t, device=y.device)[:, None] * HOP + torch.arange(N_FFT, device=y.device)).reshape(-1)
    norm = torch.zeros(n + N_FFT, device=y.device).index_add_(0, pos, (win * win).repeat(t)).clamp_min(1e-8)
    out = []
    for m in (h / den, p / den):
        fr = torch.fft.irfft(spec * m, N_FFT, dim=-1) * win
        sig = torch.zeros(y.shape[0], n + N_FFT, device=y.device).index_add_(1, pos, fr.reshape(y.shape[0], -1))
        out.append((sig / norm)[:, N_FFT // 2: N_FFT // 2 + n])
    return out[0], out[1]
