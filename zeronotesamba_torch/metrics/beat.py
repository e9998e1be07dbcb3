"""Beat-tracking evaluation metrics (mir_eval-equivalent, numpy).

The port's copy of zeronotesamba_tpu/metrics/beat.py, unchanged.

The reference scores every epoch with mir_eval.beat
(zeroNoteSamba/processing/evaluate.py:60-64): F-measure @70 ms, the
continuity family CMLc/CMLt/AMLc/AMLt, and information gain. mir_eval is not
available in this environment, so these are implemented from the published
definitions:

- F-measure: Dixon (2006); optimal 1:1 matching of beats within ±window.
- Continuity: Hainsworth (2004) / Davies & Plumbley (2007): an estimated beat
  is correct if it falls within ±17.5% of the inter-annotation-interval of its
  matched annotation AND its local tempo matches within 17.5%. CML uses the
  raw annotations; AML additionally allows double/half tempo and the off-beat.
  "c" variants score the longest continuous correct segment, "t" the total.
- Information gain: Davies, Degara & Plumbley (2010): K-L divergence of the
  41-bin circular beat-error histogram against uniform, taking the worse of
  the est→ref / ref→est directions.

Conventions (beats in seconds, 5 s trim) follow the reference's usage.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def trim_beats(beats: np.ndarray, min_beat_time: float = 5.0) -> np.ndarray:
    """Drop beats occurring before ``min_beat_time`` seconds (mir_eval convention)."""
    beats = np.asarray(beats, dtype=np.float64).ravel()
    beats = np.sort(beats)
    return beats[beats >= min_beat_time]


def f_measure(
    reference_beats: np.ndarray, estimated_beats: np.ndarray, f_measure_threshold: float = 0.07
) -> float:
    """Beat F-measure with an optimal 1:1 matching within ±threshold seconds."""
    ref = np.asarray(reference_beats, dtype=np.float64).ravel()
    est = np.asarray(estimated_beats, dtype=np.float64).ravel()
    if ref.size == 0 or est.size == 0:
        return 0.0
    # Greedy two-pointer matching is optimal for 1D interval bipartite graphs
    # when both sequences are sorted.
    ref = np.sort(ref)
    est = np.sort(est)
    matches = 0
    j = 0
    for r in ref:
        while j < est.size and est[j] < r - f_measure_threshold:
            j += 1
        if j < est.size and abs(est[j] - r) <= f_measure_threshold:
            matches += 1
            j += 1
    precision = matches / est.size
    recall = matches / ref.size
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _double_tempo(beats: np.ndarray) -> np.ndarray:
    """Interpolate midpoints: [b0, m01, b1, m12, b2, ...]."""
    if beats.size < 2:
        return beats
    out = np.empty(2 * beats.size - 1)
    out[0::2] = beats
    out[1::2] = (beats[:-1] + beats[1:]) / 2.0
    return out


def _reference_variations(ref: np.ndarray):
    dbl = _double_tempo(ref)
    return [ref, dbl[1::2], dbl, ref[0::2], ref[1::2]]


def _interval_at(ref: np.ndarray, idx: int) -> float:
    """Inter-annotation interval attributed to annotation ``idx``."""
    if ref.size < 2:
        return np.inf
    if idx + 1 < ref.size:
        return ref[idx + 1] - ref[idx]
    return ref[idx] - ref[idx - 1]


def _continuity_one(ref: np.ndarray, est: np.ndarray, phase_thr: float, period_thr: float) -> Tuple[float, float]:
    """(continuous, total) correctness ratios of ``est`` against one reference variation."""
    if ref.size < 2 or est.size < 2:
        return 0.0, 0.0
    used = np.zeros(ref.size, dtype=bool)
    correct = np.zeros(est.size, dtype=bool)
    for m in range(est.size):
        n = int(np.argmin(np.abs(ref - est[m])))
        if used[n]:
            continue
        interval = _interval_at(ref, n)
        phase_ok = abs(est[m] - ref[n]) < phase_thr * interval
        if m == 0:
            est_interval = est[1] - est[0]
        else:
            est_interval = est[m] - est[m - 1]
        period_ok = abs(est_interval - interval) < period_thr * interval
        if phase_ok and period_ok:
            correct[m] = True
            used[n] = True
    total = correct.sum() / max(ref.size, est.size)
    # Longest run of consecutive correct estimated beats.
    best = run = 0
    for c in correct:
        run = run + 1 if c else 0
        best = max(best, run)
    continuous = best / max(ref.size, est.size)
    return continuous, total


def continuity(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    phase_threshold: float = 0.175,
    period_threshold: float = 0.175,
) -> Tuple[float, float, float, float]:
    """(CMLc, CMLt, AMLc, AMLt)."""
    ref = np.sort(np.asarray(reference_beats, dtype=np.float64).ravel())
    est = np.sort(np.asarray(estimated_beats, dtype=np.float64).ravel())
    if ref.size == 0 or est.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    scores = [_continuity_one(v, est, phase_threshold, period_threshold) for v in _reference_variations(ref)]
    cmlc, cmlt = scores[0]
    amlc = max(s[0] for s in scores)
    amlt = max(s[1] for s in scores)
    return cmlc, cmlt, amlc, amlt


def _beat_error_entropy(ref: np.ndarray, est: np.ndarray, bins: int) -> float:
    """Entropy (bits) of the circular relative beat-error histogram."""
    errors = np.empty(est.size)
    for m in range(est.size):
        n = int(np.argmin(np.abs(ref - est[m])))
        err = est[m] - ref[n]
        # Normalize by the interval on the side the error falls.
        if err >= 0:
            interval = ref[n + 1] - ref[n] if n + 1 < ref.size else ref[n] - ref[n - 1]
        else:
            interval = ref[n] - ref[n - 1] if n > 0 else ref[n + 1] - ref[n]
        errors[m] = err / interval
    # Fold into [-0.5, 0.5) circularly.
    errors = np.mod(errors + 0.5, 1.0) - 0.5
    # 41 bins: centers at -0.5..0.5; first and last half-bins wrap together.
    edges = np.linspace(-0.5, 0.5, bins + 1)
    half = 0.5 / bins
    wrapped = np.mod(errors + 0.5 + half, 1.0) - 0.5 - half  # shift so the wrap bin is contiguous
    counts, _ = np.histogram(wrapped, bins=bins, range=(-0.5 - half, 0.5 - half))
    probs = counts / counts.sum()
    nz = probs[probs > 0]
    return float(-(nz * np.log2(nz)).sum())


def information_gain(reference_beats: np.ndarray, estimated_beats: np.ndarray, bins: int = 41) -> float:
    """Information gain in bits; perfect tracking scores log2(bins) ≈ 5.36."""
    ref = np.sort(np.asarray(reference_beats, dtype=np.float64).ravel())
    est = np.sort(np.asarray(estimated_beats, dtype=np.float64).ravel())
    if ref.size < 2 or est.size < 2:
        return 0.0
    fwd = _beat_error_entropy(ref, est, bins)
    bwd = _beat_error_entropy(est, ref, bins)
    return float(np.log2(bins) - max(fwd, bwd))


def evaluate_beats(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    *,
    trim: bool = True,
    f_measure_threshold: float = 0.07,
) -> Tuple[float, float, float, float, float, float]:
    """Full metric suite (F1, CMLc, CMLt, AMLc, AMLt, InfoGain).

    Mirrors the per-song scoring of the reference's beat_tracking
    (zeroNoteSamba/processing/evaluate.py:30-66).
    """
    ref = trim_beats(reference_beats) if trim else np.asarray(reference_beats, dtype=np.float64)
    est = trim_beats(estimated_beats) if trim else np.asarray(estimated_beats, dtype=np.float64)
    f1 = f_measure(ref, est, f_measure_threshold)
    cmlc, cmlt, amlc, amlt = continuity(ref, est)
    ig = information_gain(ref, est)
    return f1, cmlc, cmlt, amlc, amlt, ig
