"""Frame RMS energy, the stem-quality-gate primitive (port of zeronotesamba_tpu/ops/rms.py).

The reference's compute_rms semantics (zeroNoteSamba/processing/stem_check.py:8-19):
frame length 2048, hop 512, centred frames. ``frame_rms`` is the batched
tensor version; ``frame_rms_host`` the numpy one that the pair-mining RMS
gate uses (data/stems.py), as the JAX package's gate does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def frame_rms(y: torch.Tensor, frame_length: int = 2048, hop: int = 512) -> torch.Tensor:
    """(B, L) -> (B, 1 + L//hop) RMS per centred frame, on ``y``'s device:
    a stride-``hop`` conv1d of a ones kernel over the padded x²."""
    if y.ndim != 2:
        raise ValueError("frame_rms expects (batch, samples)")
    n_frames = 1 + y.shape[-1] // hop
    x = F.pad(y.float(), (frame_length // 2, frame_length // 2))
    kern = torch.full((1, 1, frame_length), 1.0 / frame_length, device=y.device)
    mean_sq = F.conv1d((x * x)[:, None, :], kern, stride=hop)[:, 0, :n_frames]
    return torch.sqrt(mean_sq)


def frame_rms_host(y: np.ndarray, frame_length: int = 2048, hop: int = 512) -> np.ndarray:
    """Numpy single-signal RMS (same framing), for host-side ETL."""
    n_frames = 1 + len(y) // hop
    x = np.pad(np.asarray(y, dtype=np.float64), frame_length // 2)
    csum = np.concatenate([[0.0], np.cumsum(x * x)])
    starts = np.arange(n_frames) * hop
    energy = csum[starts + frame_length] - csum[starts]
    return np.sqrt(energy / frame_length)
