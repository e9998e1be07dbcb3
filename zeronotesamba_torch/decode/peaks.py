"""Beat This!'s "minimal" post-processing (CPJKU beat_this, model/postprocessor.py).

A frame is a peak where its logit is the largest of the 7 frames centred on
it (3 a side, the piece's ends padded with -inf) and above 0 (a probability
over one half). A peak at most one frame past the running mean of the group
before it joins that group, which becomes that mean. Times are frames over the frame rate; each
downbeat moves to the nearest beat, and the downbeats that meet are merged.
No DBN: this is the decoder of the source's default ``dbn=False``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from zeronotesamba_torch.utils import profiling

WINDOW = 7


def peak_frames(logits: np.ndarray) -> np.ndarray:
    """The frames of ``logits`` (T,) that are peaks, ascending."""
    x = np.asarray(logits, np.float32)
    padded = np.pad(x, WINDOW // 2, constant_values=-np.inf)
    # The window's max as WINDOW shifted elementwise maxima: a tenth of the time of a
    # reduction over a sliding-window view, whose inner axis is strided.
    local_max = padded[: len(x)].copy()
    for k in range(1, WINDOW):
        np.maximum(local_max, padded[k: k + len(x)], out=local_max)
    return np.flatnonzero((x == local_max) & (x > 0))


def deduplicate_peaks(peaks: np.ndarray, width: int = 1) -> np.ndarray:
    """Ascending peak frames -> groups' running means, float64: a frame at
    most ``width`` past the running mean of the group before it joins that
    group (so a plateau of three frames gives its first two's mean and its
    third, as in the source)."""
    out: list = []
    count = 0
    for p in np.asarray(peaks, np.int64).tolist():
        if out and p - out[-1] <= width:
            count += 1
            out[-1] += (p - out[-1]) / count
        else:
            out.append(float(p))
            count = 1
    return np.asarray(out, np.float64)


def decode_peaks(logits: np.ndarray, fps: float = 50.0) -> Tuple[np.ndarray, np.ndarray]:
    """(2, T) beat and downbeat logits -> (beat times, downbeat times) in seconds."""
    with profiling.span("decode.peaks"):
        beats = deduplicate_peaks(peak_frames(logits[0])) / fps
        downs = deduplicate_peaks(peak_frames(logits[1])) / fps
        if len(beats) and len(downs):
            downs = beats[nearest(beats, downs)]
        return beats, np.unique(downs)


def nearest(ascending: np.ndarray, x: np.ndarray) -> np.ndarray:
    """For each of ``x``, the index of the nearest of ``ascending`` (the
    earlier one where two are as near): ``np.abs(x[:, None] - ascending).argmin(1)``
    in O(len(x) log len(ascending))."""
    after = np.clip(np.searchsorted(ascending, x), 1, len(ascending) - 1)
    if len(ascending) == 1:
        return np.zeros(len(x), np.int64)
    before = after - 1
    return np.where(np.abs(x - ascending[before]) <= np.abs(x - ascending[after]), before, after)
