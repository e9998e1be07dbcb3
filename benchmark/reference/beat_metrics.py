"""The beat F-measure for the benchmark's reference (numpy).

A frozen copy of the mir_eval-style definition the program scores with
(Dixon 2006): an optimal one-to-one matching within a threshold in seconds.
Kept here so that a change to the program's scoring cannot move the
yardstick.
"""

from __future__ import annotations

import numpy as np


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
