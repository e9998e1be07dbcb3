"""Rational polyphase resampling: on the host (numpy) and on the device (torch).

The port's copy of ``resample_poly_host`` and ``_kaiser_lowpass`` from
zeronotesamba_tpu/ops/resample.py, and ``resample_device``, the counterpart
of its ``resample_jax``: one zero-stuffed ``conv1d`` over the same Kaiser
low-pass, as the JAX package leaves one dilated conv to XLA.

``resample_polyphase_device`` computes ``resample_device``'s outputs from the
same taps without the zeros: output ``m p + r`` is phase ``r``'s taps (at
most ceil(taps / p) of them: 177 for 44,100 -> 16,000 Hz) over the input
from ``m q`` on, so one matrix product of the input's windows of ``width``
samples every ``q`` (an ``unfold``) with the (width, p) matrix of the
phases' taps gives ``p`` outputs a window.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_lowpass(p: int, q: int, half_width: int = 32, beta: float = 9.0) -> np.ndarray:
    """Windowed-sinc lowpass for rational p/q resampling (gain p in passband)."""
    m = max(p, q)
    taps = 2 * half_width * m + 1
    n = np.arange(taps) - (taps - 1) / 2.0
    cutoff = 1.0 / m  # fraction of the upsampled Nyquist
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(taps, beta)
    return (h * p / np.sum(h)).astype(np.float64)


def resample_poly_host(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Rational resampling on host (scipy's resample_poly if available)."""
    if sr_in == sr_out:
        return np.asarray(x)
    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    try:
        from scipy.signal import resample_poly

        return resample_poly(np.asarray(x, dtype=np.float64), p, q).astype(np.float32)
    except ImportError:  # pure-numpy fallback
        h = _kaiser_lowpass(p, q)
        up = np.zeros(len(x) * p)
        up[::p] = x
        pad = len(h) // 2
        uppad = np.pad(up, (pad, pad))
        full = np.convolve(uppad, h, mode="valid")
        return full[::q][: int(math.ceil(len(x) * p / q))].astype(np.float32)


def resample_device(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Batched rational resampling on ``x``'s device: (B, L) -> (B, ceil(L*p/q)).

    JAX's one conv with ``lhs_dilation=p`` (zero-stuffing upsample), stride
    ``q`` (decimation) and padding ``(half, half + q)`` over the reversed
    Kaiser-sinc low-pass, written out: the input with p - 1 zeros after
    every sample but the last, padded, then ``conv1d`` at stride q.
    """
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    kern = torch.tensor(_kaiser_lowpass(p, q)[::-1].copy(), dtype=torch.float32, device=x.device)
    half = kern.shape[0] // 2
    b, n = x.shape
    up = torch.zeros((b, (n - 1) * p + 1), dtype=torch.float32, device=x.device)
    up[:, ::p] = x.float()
    y = F.conv1d(F.pad(up, (half, half + q))[:, None, :], kern[None, None, :], stride=q)
    return y[:, 0, : int(math.ceil(n * p / q))]


@functools.lru_cache(maxsize=8)
def _polyphase_plan(p: int, q: int, device: str) -> tuple:
    """(taps, lead): the (width, p) float32 matrix whose column ``r`` holds
    phase ``r``'s taps of ``resample_device``'s filter, row ``s`` weighing
    input sample ``m q + s - lead`` of output ``m p + r``."""
    kern = _kaiser_lowpass(p, q)[::-1]
    half = len(kern) // 2
    # Output j = m p + r takes input i at tap i p - j q + half (resample_device's conv).
    lead = half // p
    last = ((p - 1) * q + half) // p
    s = np.arange(last + lead + 1)[:, None]
    k = (s - lead) * p - np.arange(p)[None, :] * q + half
    taps = np.where((k >= 0) & (k < len(kern)), kern[np.clip(k, 0, len(kern) - 1)], 0.0)
    return torch.tensor(taps, dtype=torch.float32, device=device), lead


def resampled_length(n: int, sr_in: int, sr_out: int) -> int:
    """The outputs ``resample_polyphase_device`` gives for ``n`` inputs:
    ceil(n p / q), or one fewer where ``resample_device``'s conv ends there."""
    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    return min(-(-n * p // q), (n - 1) * p // q + 2)


def resample_polyphase_device(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """``resample_device`` computed at the kept outputs only (module
    docstring), float32: (B, L) -> (B, n) with ``resample_device``'s n, at
    most ceil(L*p/q)."""
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    taps, lead = _polyphase_plan(p, q, str(x.device))
    width = taps.shape[0]
    n_out = resampled_length(x.shape[-1], sr_in, sr_out)
    blocks = -(-n_out // p)
    padded = F.pad(x.float(), (lead, (blocks - 1) * q + width - lead - x.shape[-1]))
    y = padded.unfold(-1, width, q) @ taps  # (B, blocks, p)
    return y.flatten(-2)[:, :n_out]
