"""Beat decoders: threshold picking, Ellis DP, DBN/HMM Viterbi (C++, numpy,
batched on the card) and the online DBN."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, beat_activation_to_times, decode_beats
from zeronotesamba_torch.decode.dbn_device import decode_beats_batch_device, decode_beats_device
from zeronotesamba_torch.decode.dbn_online import OnlineBeatDecoder, decode_beats_online
from zeronotesamba_torch.decode.ellis import beat_track_dp, beat_track_signal, estimate_tempo, onset_strength
from zeronotesamba_torch.utils import profiling


def threshold_beats(activations: np.ndarray, thresh_val: float = 0.075, fps: float = 62.5) -> np.ndarray:
    """Every frame above threshold becomes a beat (reference evaluate.py:36-45)."""
    act = np.asarray(activations).ravel()
    return np.nonzero(act > thresh_val)[0] / fps


def decode(activations: np.ndarray, method: str = "dbn", *, fps: float = 62.5, thresh_val: float = 0.075,
           device: Optional[str | torch.device] = None) -> np.ndarray:
    """Dispatch on the reference's three decoder modes ('dbn'/'librosa'/'threshold').
    ``device``: the caller's; on a card the DBN's forward pass runs there (decode_beats)."""
    with profiling.span("decode"):
        if method == "dbn":
            return beat_activation_to_times(activations, fps=fps, device=device)
        if method in ("librosa", "ellis"):
            return beat_track_dp(activations, fps=fps)
        if method == "threshold":
            return threshold_beats(activations, thresh_val=thresh_val, fps=fps)
    raise ValueError(f"unknown decoder {method!r} (expected dbn|librosa|threshold)")


__all__ = [
    "DBNBeatDecoderConfig",
    "beat_activation_to_times",
    "decode_beats",
    "decode_beats_device",
    "decode_beats_batch_device",
    "decode_beats_online",
    "OnlineBeatDecoder",
    "beat_track_dp",
    "beat_track_signal",
    "estimate_tempo",
    "onset_strength",
    "threshold_beats",
    "decode",
]
