"""The log-VQT, plainly: filterbank design in float64 numpy and the
multi-rate transform as strided ``F.conv1d`` calls in any dtype.

The analytic VQT (Schoerkhuber et al. 2014, as librosa's ``vqt``): bins at
``fmin * 2^(k/12)`` from C0 over 8 octaves, bandwidth ``alpha = 2^(1/12) - 1``,
``gamma = 24.7 alpha / 0.108``, filter length ``Q sr / (f + gamma)``,
periodic-Hann windowed complex exponentials, L1-normalised and scaled by
the square root of their length. Each octave is analysed at its own rate:
the full-rate signal is halved by a zero-phase 81-tap Kaiser half-band
filter (beta 10) once per octave, and every kernel is passed through the
same halvings. Frames are centred every 256 samples (62.5 fps at 16 kHz),
``1 + L // 256`` of them, each octave's kernels spanning 256 of its samples.
Output: ``log(|X| + 1e-9)``, (B, 96, frames).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
HOP = 256
BPO = 12
N_OCTAVES = 8
WINDOW = 256
LOG_EPS = 1e-9
FMIN = 440.0 * 2.0 ** ((12 - 69) / 12.0)


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def halfband(num_taps: int = 81, beta: float = 10.0) -> np.ndarray:
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(0.5 * n) * 0.5 * np.kaiser(num_taps, beta)
    return h / np.sum(h)


def _kernel(freq: float, length: float) -> np.ndarray:
    n = int(math.ceil(length)) | 1
    t = (np.arange(n) - (n - 1) / 2.0) / SAMPLE_RATE
    k = _hann(n) * np.exp(2j * np.pi * freq * t)
    return k / np.sum(np.abs(k)) * math.sqrt(length)


def _halve(kern: np.ndarray, taps: np.ndarray) -> np.ndarray:
    pad = len(taps) // 2
    kp = np.pad(kern, (pad, pad))
    if len(kern) % 2 == 1:
        kp = np.append(kp, 0.0)
    return 2.0 * np.convolve(kp, taps, mode="valid")[::2]


def kernel_bank() -> np.ndarray:
    """Complex (octaves, 256, 12): octave j's kernels at its own rate."""
    alpha = 2.0 ** (1.0 / BPO) - 1.0
    gamma = 24.7 * alpha / 0.108
    freqs = FMIN * 2.0 ** (np.arange(BPO * N_OCTAVES) / BPO)
    lengths = SAMPLE_RATE / alpha / (freqs + gamma)
    taps = halfband()
    bank = np.zeros((N_OCTAVES, WINDOW, BPO), dtype=np.complex128)
    for j in range(N_OCTAVES):
        dec = N_OCTAVES - 1 - j
        for i in range(BPO):
            k = j * BPO + i
            kern = _kernel(freqs[k], lengths[k])
            c = (len(kern) - 1) // 2
            cc = ((c + (1 << dec) - 1) >> dec) << dec
            kern = np.pad(kern, (cc - c, cc - c))
            for _ in range(dec):
                kern = _halve(kern, taps)
            ck = cc >> dec
            lo, hi = max(0, ck - WINDOW // 2), min(len(kern), ck + WINDOW // 2)
            bank[j, WINDOW // 2 - (ck - lo): WINDOW // 2 + (hi - ck), i] = kern[lo:hi]
    return bank


def _reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    while pad > 0:
        step = min(pad, x.shape[-1] - 1)
        x = F.pad(x, (step, step), mode="reflect")
        pad -= step
    return x


def log_vqt(y: torch.Tensor, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(B, L) signals -> (B, 96, 1 + L // 256) log-magnitudes in ``dtype``."""
    bank = np.conj(kernel_bank())
    kern = np.concatenate([bank.real.transpose(0, 2, 1), bank.imag.transpose(0, 2, 1)], axis=1)[:, :, None, :]
    kern = torch.tensor(np.ascontiguousarray(kern), dtype=dtype, device=y.device)
    dec = torch.tensor(np.ascontiguousarray(halfband()[::-1]), dtype=dtype, device=y.device)[None, None]
    n_frames = 1 + y.shape[-1] // HOP
    pad = (WINDOW // 2 + 1) << (N_OCTAVES - 1)
    x = _reflect(y.to(dtype)[:, None, :], pad)
    octaves = []
    for j in range(N_OCTAVES - 1, -1, -1):
        d = N_OCTAVES - 1 - j
        hop = HOP >> d
        off = (pad >> d) - WINDOW // 2
        resp = F.conv1d(x[:, :, off: off + (n_frames - 1) * hop + WINDOW], kern[j], stride=hop)
        octaves.append(torch.sqrt(resp[:, :BPO] ** 2 + resp[:, BPO:] ** 2 + 1e-30))
        if j > 0:
            n = x.shape[-1]
            xp = _reflect(x, dec.shape[-1] // 2)
            if n % 2 == 1:
                xp = F.pad(xp, (0, 1))
            x = F.conv1d(xp, dec, stride=2)
    return torch.log(torch.cat(octaves[::-1], dim=1) + LOG_EPS)


def peak_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap between two log-VQTs' magnitudes, each cell's gap over
    the peak magnitude of its bin in ``ref`` (arrays (..., 96, frames))."""
    g, r = np.exp(np.asarray(got, np.float64)), np.exp(np.asarray(ref, np.float64))
    return float((np.abs(g - r) / r.max(axis=-1, keepdims=True)).max())
