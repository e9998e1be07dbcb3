"""Beat decoders: DBN/HMM Viterbi and threshold picking.

The Ellis DP decoder (``librosa``/``ellis``), the online DBN and the device
Viterbi are not ported yet (ROADMAP "Modules to port", item 8).
"""

from __future__ import annotations

import numpy as np

from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, beat_activation_to_times, decode_beats


def threshold_beats(activations: np.ndarray, thresh_val: float = 0.075, fps: float = 62.5) -> np.ndarray:
    """Every frame above threshold becomes a beat (reference evaluate.py:36-45)."""
    act = np.asarray(activations).ravel()
    return np.nonzero(act > thresh_val)[0] / fps


def decode(activations: np.ndarray, method: str = "dbn", *, fps: float = 62.5, thresh_val: float = 0.075) -> np.ndarray:
    """Dispatch on the reference's decoder modes ('dbn'/'threshold'; 'librosa' is not ported)."""
    if method == "dbn":
        return beat_activation_to_times(activations, fps=fps)
    if method in ("librosa", "ellis"):
        raise NotImplementedError(
            f"decoder {method!r} (Ellis DP) is not ported yet (ROADMAP 'Modules to port', item 8)"
        )
    if method == "threshold":
        return threshold_beats(activations, thresh_val=thresh_val, fps=fps)
    raise ValueError(f"unknown decoder {method!r} (expected dbn|librosa|threshold)")


__all__ = ["DBNBeatDecoderConfig", "beat_activation_to_times", "decode_beats", "threshold_beats", "decode"]
