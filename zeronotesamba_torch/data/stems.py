"""Stem folding, RMS quality gate, and contrastive pair mining.

The port's copy of zeronotesamba_tpu/data/stems.py:

- fold 4-stem separations into (anchor = everything but drums, positive =
  drums) signal pairs (reference pretext.py:41-64, ballroom.py:106-139);
- RMS gate: accept a clip when the fraction of frames with
  ``ros/2 < drums < 4*ros`` lies in (lower_p, upper_p]
  (reference stem_check.py:22-51);
- rejection-sample fixed-length crops from a ``random.Random``, halving
  ``lower_p`` after every 10 failed draws (reference pretext.py:66-81), so a
  seed picks the same crops as the JAX package's.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

import numpy as np

from zeronotesamba_torch.ops.rms import frame_rms_host


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


def rms_gate(anchor: np.ndarray, positive: np.ndarray, lower_p: float, upper_p: float) -> bool:
    """True when the drums-vs-rest energy balance passes the clip gate."""
    ros = frame_rms_host(anchor)
    drum = frame_rms_host(positive)
    ok = (drum > ros / 2) & (drum < ros * 4)
    frac = ok.mean()
    return bool(lower_p < frac <= upper_p)


def mine_pair(
    anchor: np.ndarray,
    positive: np.ndarray,
    *,
    clip_len_s: float = 10.0,
    sample_rate: int = 16000,
    lower_p: float = 0.3,
    upper_p: float = 1.0,
    rng: Optional[random.Random] = None,
    max_tries: int = 200,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rejection-sample an RMS-gated crop pair; halve lower_p every 10 tries."""
    rng = rng or random.Random()
    n = int(clip_len_s * sample_rate)
    stop = len(anchor) - n - 1
    if stop < 0:
        raise ValueError(f"signal shorter than {clip_len_s}s")
    tries = 0
    lp = lower_p
    while tries < max_tries:
        start = rng.randint(0, stop)
        a = anchor[start : start + n]
        p = positive[start : start + n]
        if rms_gate(a, p, lp, upper_p):
            return a, p
        tries += 1
        if tries % 10 == 0:
            lp = lp / 2
    # Gate never passed (e.g. drumless track at lower_p -> 0): last crop.
    return a, p
