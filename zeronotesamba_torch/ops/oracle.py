"""Direct-form (full-rate) numpy VQT/CQT: the test oracle.

The port's copy of zeronotesamba_tpu/ops/oracle.py, on the port's
ops/filterbank.analytic_kernel. It evaluates the analytic filterbank
exactly, with no multi-rate decimation: every bin is correlated against the
signal at the full sample rate on the centered ``hop`` frame grid. The
multi-rate path (ops/vqt.py and the two log-VQT kernels) is held against it.
"""

from __future__ import annotations

import math

import numpy as np

from zeronotesamba_torch.ops.filterbank import XQTParams, analytic_kernel


def xqt_direct(y: np.ndarray, params: XQTParams | None = None) -> np.ndarray:
    """Direct full-rate XQT magnitude of a mono signal.

    Returns ``(n_bins, num_frames)`` float64 magnitudes (no log).
    """
    params = params or XQTParams()
    y = np.asarray(y, dtype=np.float64)
    if y.ndim != 1:
        raise ValueError("xqt_direct expects a mono 1D signal")

    freqs = params.bin_frequencies()
    lengths = params.filter_lengths()
    n_frames = params.num_frames(len(y))
    out = np.empty((params.n_bins, n_frames), dtype=np.float64)

    nmax = int(math.ceil(lengths.max()))
    pad = nmax // 2 + 1
    ypad = np.pad(y, (pad, pad + params.hop), mode="reflect")

    for k in range(params.n_bins):
        kern = analytic_kernel(freqs[k], lengths[k], params.sample_rate, math.sqrt(lengths[k]))
        n = len(kern)
        # Frame m is centered at sample m*hop of the original signal; the
        # kernel's center is at (n-1)/2.
        starts = np.arange(n_frames) * params.hop + pad - (n - 1) // 2
        idx = starts[:, None] + np.arange(n)[None, :]
        frames = ypad[idx]
        out[k] = np.abs(frames @ np.conj(kern))
    return out


def log_xqt_direct(y: np.ndarray, params: XQTParams | None = None) -> np.ndarray:
    """log(|XQT| + eps), the reference's generate_XQT output convention."""
    params = params or XQTParams()
    return np.log(xqt_direct(y, params) + params.log_eps)


# The limits tests/test_vqt.py::test_multirate_matches_direct_oracle holds
# the JAX multi-rate path to, for the quantities of ``multirate_errors``.
MULTIRATE_LIMITS = {"top_octave_rel": 1e-4, "nerr_p99": 0.02, "nerr_max": 0.10, "dlog_mean": 2e-3, "dlog_p99": 0.02}


def multirate_errors(fast: np.ndarray, direct: np.ndarray, params: XQTParams | None = None) -> dict:
    """How far multi-rate magnitudes ``fast`` lie from the direct ones, both
    (n_bins, T), as ``MULTIRATE_LIMITS`` bounds them: the top octave (full
    rate, the oracle's exact kernels) relative to each bin's peak; the
    null-damped relative error of every cell (its 99th percentile and max),
    the lower octaves differing only by what decimation discards; and the
    log-domain error on energetic cells (over 5% of the bin's peak)."""
    params = params or XQTParams()
    top = slice(params.n_bins - params.bins_per_octave, params.n_bins)
    scale = direct[top].max(axis=1, keepdims=True)
    per_bin_max = direct.max(axis=1, keepdims=True)
    nerr = np.abs(fast - direct) / (direct + 0.01 * per_bin_max)
    mask = direct > per_bin_max * 0.05
    dlog = np.abs(np.log(fast[mask] + params.log_eps) - np.log(direct[mask] + params.log_eps))
    return {
        "top_octave_rel": float((np.abs(fast[top] - direct[top]) / scale).max()),
        "nerr_p99": float(np.quantile(nerr, 0.99)),
        "nerr_max": float(nerr.max()),
        "dlog_mean": float(dlog.mean()),
        "dlog_p99": float(np.quantile(dlog, 0.99)),
    }
