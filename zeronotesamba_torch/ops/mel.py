"""The log-mel front end of Beat This! (CPJKU beat_this, preprocessing.LogMelSpect).

Mono audio at 22,050 Hz -> (T, 128) float32: an STFT (n_fft 1,024, hop 441,
periodic Hann, centred with reflect padding, so a song of L samples gives
1 + L // 441 frames at 50 fps), its magnitude over sqrt(sum(window^2))
(torchaudio's ``normalized="frame_length"``), a 128-band triangular
filterbank on the Slaney mel scale from 30 to 11,000 Hz without area
normalisation (torchaudio's ``melscale_fbanks(..., norm=None,
mel_scale="slaney")``), then log1p(1000 x). The filterbank is built once a
device, in float64, and applied as a float32 ``F.linear``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 22050
N_FFT = 1024
HOP = 441
FPS = SAMPLE_RATE / HOP
N_MELS = 128
F_MIN = 30.0
F_MAX = 11000.0
LOG_MULTIPLIER = 1000.0


def hz_to_mel(f):
    """Slaney-style mel scale (librosa default)."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0), mel)
    return mel


def mel_to_hz(m):
    """The inverse of ``hz_to_mel``."""
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((m - 15.0) * (np.log(6.4) / 27.0)), f)
    return f


def mel_filterbank() -> np.ndarray:
    """(N_MELS, N_FFT // 2 + 1) triangular filters, float64, each peaking at 1."""
    freqs = np.linspace(0.0, SAMPLE_RATE // 2, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(F_MIN), hz_to_mel(F_MAX), N_MELS + 2))
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    return np.ascontiguousarray(fb.T)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> tuple:
    """(window, filterbank scaled by 1 / sqrt(sum(window^2))) on ``device``, float32."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64)
    fb = torch.from_numpy(mel_filterbank()) / window.square().sum().sqrt()
    return window.float().to(device), fb.float().to(device)


def log_mel(y: torch.Tensor) -> torch.Tensor:
    """(..., L) float32 signals at 22,050 Hz -> (..., 1 + L // 441, 128) log-mels."""
    window, fb = _constants(y.device)
    spec = torch.stft(y, N_FFT, hop_length=HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True).abs()  # (..., n_fft // 2 + 1, T)
    return torch.log1p(LOG_MULTIPLIER * F.linear(spec.transpose(-1, -2), fb))
