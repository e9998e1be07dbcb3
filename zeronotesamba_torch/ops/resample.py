"""Rational polyphase resampling on the host (numpy).

The port's copy of ``resample_poly_host`` and ``_kaiser_lowpass`` from
zeronotesamba_tpu/ops/resample.py.
"""

from __future__ import annotations

import math

import numpy as np


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
