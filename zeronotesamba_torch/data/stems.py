"""Stem folding: 4-stem separations -> (anchor, positive) signal pairs.

The port's copy of ``fold_stems`` from zeronotesamba_tpu/data/stems.py
(anchor = everything but drums, positive = drums).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def fold_stems(stems: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(anchor, positive): sum of non-drum stems vs the drum stem."""
    if "drums" not in stems:
        raise ValueError("Stems do not contain any drum tracks!")
    positive = np.asarray(stems["drums"], dtype=np.float32).copy()
    anchor: Optional[np.ndarray] = None
    for name, sig in stems.items():
        if name == "drums":
            continue
        sig = np.asarray(sig, dtype=np.float32)
        anchor = sig.copy() if anchor is None else anchor + sig
    if anchor is None:
        raise ValueError("No non-drum stems present")
    return anchor, positive
