"""Constant-Q / Variable-Q filterbank construction (host-side, numpy).

The port's own copy of the JAX package's ``ops/filterbank.py``
(zeronotesamba_tpu/ops/filterbank.py:36-176): the front end's constants are
built on the host in float64 and must equal the reference's bit for bit, so
this module repeats the same numpy code rather than importing it (the JAX
package's ``ops/__init__.py`` pulls in jax).

Convention (the analytic VQT):

- bin frequencies      f_k = fmin * 2^(k / bins_per_octave)
- bandwidth parameter  alpha = 2^(1/bins_per_octave) - 1, Q = 1/alpha
- VQT gamma            gamma = 24.7 * alpha / 0.108 (CQT: gamma = 0)
- filter length        l_k = Q * sr / (f_k + gamma) samples at full rate
- kernel               L1-normalized periodic-Hann complex exponential of
                       length ceil(l_k) | 1, scaled by sqrt(l_k)
- frame grid           centered frames every ``hop`` samples;
                       num_frames = 1 + len(y)//hop (10 s @16 kHz -> 626)
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

# C0 with A4 = 440 Hz equal temperament.
C0_HZ = 440.0 * 2.0 ** ((12 - 69) / 12.0)


@dataclasses.dataclass(frozen=True)
class XQTParams:
    """Spectral front-end parameters (defaults = the reference's generate_XQT)."""

    sample_rate: int = 16000
    hop: int = 256
    fmin: float = C0_HZ
    bins_per_octave: int = 12
    n_octaves: int = 8
    mode: str = "vqt"  # "vqt" or "cqt"
    log_eps: float = 10e-10
    window_len: int = 256  # per-octave frame length for the multi-rate path

    def __post_init__(self):
        if self.mode not in ("vqt", "cqt"):
            raise ValueError("mode must be 'vqt' or 'cqt'")
        if self.hop % (1 << (self.n_octaves - 1)) != 0:
            raise ValueError("hop must be divisible by 2**(n_octaves-1)")

    @property
    def n_bins(self) -> int:
        return self.bins_per_octave * self.n_octaves

    @property
    def alpha(self) -> float:
        return 2.0 ** (1.0 / self.bins_per_octave) - 1.0

    @property
    def q(self) -> float:
        return 1.0 / self.alpha

    @property
    def gamma(self) -> float:
        if self.mode == "cqt":
            return 0.0
        return 24.7 * self.alpha / 0.108

    @property
    def fps(self) -> float:
        return self.sample_rate / self.hop  # 62.5 for the defaults

    def bin_frequencies(self) -> np.ndarray:
        k = np.arange(self.n_bins)
        return self.fmin * 2.0 ** (k / self.bins_per_octave)

    def filter_lengths(self) -> np.ndarray:
        """Filter lengths l_k in samples at the FULL sample rate."""
        return self.q * self.sample_rate / (self.bin_frequencies() + self.gamma)

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop


def _periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def analytic_kernel(freq_hz: float, length: float, rate: float, scale: float) -> np.ndarray:
    """One complex analysis kernel sampled at ``rate``.

    ``length`` is the (float) filter length in samples at ``rate``; ``scale``
    multiplies the L1-normalized kernel. The discrete length is forced odd so
    the kernel has an exact center sample.
    """
    n = int(math.ceil(length)) | 1
    t = (np.arange(n) - (n - 1) / 2.0) / rate
    win = _periodic_hann(n)
    kern = win * np.exp(2j * np.pi * freq_hz * t)
    kern /= np.sum(np.abs(kern))
    return kern * scale


def _decimate2_complex(kern: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Decimate a (zero-padded, centered) complex kernel by 2 with gain 2."""
    pad = len(taps) // 2
    kp = np.pad(kern, (pad, pad))
    if len(kern) % 2 == 1:
        kp = np.append(kp, 0.0)
    full = np.convolve(kp, taps, mode="valid")
    return 2.0 * full[::2]


@functools.lru_cache(maxsize=8)
def octave_kernel_bank(params: XQTParams) -> np.ndarray:
    """Per-octave kernel banks, complex ``(n_octaves, window_len, bins_per_octave)``.

    Entry ``[j]`` holds the kernels of octave ``j`` (bins ``12j .. 12j+11``) at
    the octave's rate ``sr / 2**(n_octaves-1-j)``, centered within
    ``window_len`` samples. Each kernel is built at the full rate and passed
    through the same half-band cascade as the signal.
    """
    freqs = params.bin_frequencies()
    full_lengths = params.filter_lengths()
    taps = halfband_decimation_filter()
    w = params.window_len
    bank = np.zeros((params.n_octaves, w, params.bins_per_octave), dtype=np.complex128)
    for j in range(params.n_octaves):
        dec = params.n_octaves - 1 - j  # number of halvings for this octave
        for i in range(params.bins_per_octave):
            k = j * params.bins_per_octave + i
            kern = analytic_kernel(freqs[k], full_lengths[k], params.sample_rate, math.sqrt(full_lengths[k]))
            n = len(kern)
            c = (n - 1) // 2
            # Re-center on a 2**dec-aligned index by symmetric zero padding.
            cc = ((c + (1 << dec) - 1) >> dec) << dec
            kern = np.pad(kern, (cc - c, cc - c))
            for _ in range(dec):
                kern = _decimate2_complex(kern, taps)
            ck = cc >> dec
            lo = max(0, ck - w // 2)
            hi = min(len(kern), ck + w // 2)
            bank[j, w // 2 - (ck - lo) : w // 2 + (hi - ck), i] = kern[lo:hi]
    return bank


@functools.lru_cache(maxsize=4)
def halfband_decimation_filter(num_taps: int = 81, beta: float = 10.0) -> np.ndarray:
    """Zero-phase half-band lowpass for decimation by 2 (numpy Kaiser-sinc)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(0.5 * n) * 0.5 * np.kaiser(num_taps, beta)
    return (h / np.sum(h)).astype(np.float64)


@functools.lru_cache(maxsize=8)
def octave_banks_f32(params: XQTParams) -> np.ndarray:
    """Conjugated banks as real ``(n_octaves, window_len, 2*bins_per_octave)``
    float32: columns ``[cos | sin]``, the live columns of the JAX package's
    ``_banks_f32`` without its 128-lane padding."""
    conj = np.conj(octave_kernel_bank(params))
    return np.concatenate([conj.real, conj.imag], axis=2).astype(np.float32)
