"""Batched multi-rate VQT/CQT in PyTorch (port of zeronotesamba_tpu/ops/vqt.py).

One octave per sample-rate halving: the 12 analysis kernels of each octave
are evaluated at that octave's rate, so the transform is 8 strided
convolutions and 7 half-band decimations. ``log_xqt`` is the plain float32
version built from ``F.conv1d``; ``best_log_xqt`` sends a CUDA tensor to the
hand-written Hopper kernels (ops/cuda/vqt_kernel.py) and a CPU tensor here.

Output convention: ``log(|X| + 1e-9)`` over 96 bins x (1 + L//256) frames at
62.5 fps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.ops.filterbank import XQTParams, halfband_decimation_filter, octave_kernel_bank
from zeronotesamba_torch.utils import profiling


@functools.lru_cache(maxsize=8)
def _conv_constants(params: XQTParams):
    """Host-side constants: analysis conv kernels + decimation kernel (numpy).

    ``F.conv1d`` computes a cross-correlation, so the conjugated (not
    reversed) bank, each kernel centered at window_len//2, evaluates
    <signal, conj(kernel)> centered on every hop-grid sample.
    Shapes: (n_octaves, 2*bins_per_octave, 1, W) and (1, 1, taps).
    """
    bank = np.conj(octave_kernel_bank(params))  # (n_oct, W, bins)
    cos_b = np.ascontiguousarray(bank.real.transpose(0, 2, 1))[:, :, None, :]
    sin_b = np.ascontiguousarray(bank.imag.transpose(0, 2, 1))[:, :, None, :]
    kern = np.concatenate([cos_b, sin_b], axis=1).astype(np.float32)
    dec = halfband_decimation_filter().astype(np.float32)[None, None, ::-1]
    return kern, np.ascontiguousarray(dec)


def _reflect_pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    # A reflect pad is capped at length-1 per application; iterate for short
    # signals (pad can exceed the signal length for sub-second clips).
    while pad > 0:
        step = min(pad, x.shape[-1] - 1)
        x = F.pad(x, (step, step), mode="reflect")
        pad -= step
    return x


def _decimate2(x: torch.Tensor, dec_kern: torch.Tensor) -> torch.Tensor:
    """(B, 1, L) -> (B, 1, ceil(L/2)) zero-phase half-band decimation."""
    taps = dec_kern.shape[-1]
    length = x.shape[-1]
    xpad = _reflect_pad_last(x, taps // 2)
    if length % 2 == 1:  # keep output length ceil(L/2) with samples at even indices
        xpad = F.pad(xpad, (0, 1))
    return F.conv1d(xpad, dec_kern, stride=2)


def xqt_magnitude(y: torch.Tensor, params: XQTParams = XQTParams()) -> torch.Tensor:
    """Batched XQT magnitudes: (B, L) float -> (B, n_bins, 1 + L//hop).

    Float32, or float64 for a float64 ``y``: the same transform of the same
    float32 constants without float32 rounding, the reference that near-empty
    cells are held against."""
    if y.ndim != 2:
        raise ValueError("xqt_magnitude expects (batch, samples)")
    dtype = torch.float64 if y.dtype == torch.float64 else torch.float32
    kerns_np, dec_np = _conv_constants(params)
    kerns = torch.tensor(kerns_np, device=y.device, dtype=dtype)
    dec_kern = torch.tensor(dec_np, device=y.device, dtype=dtype)
    n_frames = params.num_frames(y.shape[-1])
    w = params.window_len
    bpo = params.bins_per_octave
    dec_max = params.n_octaves - 1
    # Reflect-pad once at full rate so every octave analyzes the same
    # reflected signal; the pad covers the lowest octave's half-window plus
    # one spare sample per halving.
    pad = (w // 2 + 1) << dec_max

    x = _reflect_pad_last(y.to(dtype)[:, None, :], pad)
    octaves = []
    for j in range(params.n_octaves - 1, -1, -1):
        dec = params.n_octaves - 1 - j
        hop_j = params.hop >> dec
        offset = (pad >> dec) - w // 2
        span = (n_frames - 1) * hop_j + w
        resp = F.conv1d(x[:, :, offset : offset + span], kerns[j], stride=hop_j)  # (B, 2*bpo, T)
        octaves.append(torch.sqrt(resp[:, :bpo] ** 2 + resp[:, bpo:] ** 2 + 1e-30))
        if j > 0:
            x = _decimate2(x, dec_kern)
    # octaves[0] is the top octave (bins 84..95); stack lowest-first.
    return torch.cat(octaves[::-1], dim=1)


def log_xqt(y: torch.Tensor, params: XQTParams = XQTParams()) -> torch.Tensor:
    """Batched log-magnitude XQT: the model's input representation."""
    return torch.log(xqt_magnitude(y, params) + params.log_eps)


def best_log_xqt(y: torch.Tensor, params: XQTParams = XQTParams()) -> torch.Tensor:
    """The log-VQT for the tensor's device: on a CUDA tensor the two Hopper
    kernels (cascade + octave, ops/cuda/vqt_kernel.log_xqt_fused), on a CPU
    tensor the plain ``log_xqt``."""
    if y.is_cuda:
        from zeronotesamba_torch.ops.cuda.vqt_kernel import log_xqt_fused

        return log_xqt_fused(y, params)
    return log_xqt(y, params)


def generate_xqt(signal: np.ndarray, sample_rate: int, mode: str, device: str = "cuda") -> np.ndarray:
    """Reference-API front end (input_rep.generate_XQT parity).

    Accepts a mono numpy signal, returns ``(96, T)`` float32 log-magnitudes
    computed on ``device`` (the copies counted as ``h2d_bytes`` and ``d2h_syncs``).
    """
    if mode not in ("vqt", "cqt"):
        raise ValueError("Mode can only be vqt or cqt!")
    params = XQTParams(sample_rate=sample_rate, mode=mode)
    y = profiling.to_device(np.asarray(signal, dtype=np.float32), resolve_device(device))[None, :]
    with torch.inference_mode():
        out = best_log_xqt(y, params)
    return profiling.to_host(out[0])
