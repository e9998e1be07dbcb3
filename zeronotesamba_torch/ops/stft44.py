"""Spleeter's STFT pair (deezer/spleeter ``model/__init__.py``:
``EstimatorSpecBuilder._build_stft_feature`` and ``_inverse_stft``), batched.

- ``stft``: each signal with ``FRAME`` zeros prepended, frames of ``FRAME``
  samples every ``HOP``, not centred, the end zero-padded as
  ``tf.signal.stft(pad_end=True)`` pads it (``n_frames``: ceil((L + 4,096) /
  1,024) frames), a periodic Hann window, ``rfft``: (B, frames, 2,049).
- ``istft``: ``irfft`` of each frame, the periodic Hann window again,
  overlap-add at ``HOP``, times ``COMPENSATION`` (the Hann pair at 75%
  overlap sums to 3/2), and samples [``FRAME``, ``FRAME`` + L) kept: the
  inverse of ``stft`` where the mask is 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FRAME = 4096
HOP = 1024
BINS = FRAME // 2 + 1
COMPENSATION = 2.0 / 3.0


def hann(device, dtype=torch.float32) -> torch.Tensor:
    """The periodic Hann window of ``FRAME`` samples."""
    n = torch.arange(FRAME, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / FRAME)).to(dtype)


def n_frames(length: int) -> int:
    return -(-(length + FRAME) // HOP)


def stft(y: torch.Tensor) -> torch.Tensor:
    """(B, L) real -> (B, n_frames(L), BINS) complex."""
    frames = n_frames(y.shape[-1])
    total = (frames - 1) * HOP + FRAME
    padded = F.pad(y, (FRAME, total - FRAME - y.shape[-1]))
    return torch.fft.rfft(padded.unfold(-1, FRAME, HOP) * hann(y.device, y.dtype), dim=-1)


def istft(spec: torch.Tensor, length: int) -> torch.Tensor:
    """(B, frames, BINS) complex -> (B, length) real."""
    b, frames = spec.shape[:2]
    x = torch.fft.irfft(spec, n=FRAME, dim=-1) * hann(spec.device, spec.real.dtype)
    parts = x.view(b, frames, FRAME // HOP, HOP)
    out = x.new_zeros((b, frames + FRAME // HOP - 1, HOP))
    for k in range(FRAME // HOP):
        out[:, k:k + frames] += parts[:, :, k]
    return out.view(b, -1)[:, FRAME:FRAME + length] * COMPENSATION
