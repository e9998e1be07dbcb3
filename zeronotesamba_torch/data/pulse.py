"""Beat-pulse supervision targets at the 62.5 fps frame grid.

The port's copy of zeronotesamba_tpu/data/pulse.py, unchanged.

Replicates the reference's target construction (zeroNoteSamba/ballroom.py:198-221
and siblings): 1.0 at round(fps * t), 0.5 at the two adjacent frames, with the
peak index clamped into [1, n_frames - 2].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def beat_pulse(beat_times: Sequence[float], n_frames: int, fps: float = 62.5) -> np.ndarray:
    """Per-frame pulse target (float32, shape (n_frames,))."""
    pulse = np.zeros(n_frames, dtype=np.float32)
    if n_frames < 3:
        return pulse
    for t in beat_times:
        idx = int(round(fps * float(t)))
        idx = min(max(idx, 1), n_frames - 2)
        pulse[idx] = 1.0
        pulse[idx - 1] = max(pulse[idx - 1], 0.5)
        pulse[idx + 1] = max(pulse[idx + 1], 0.5)
    return pulse


def downbeat_pulse(
    beat_times: Sequence[float], downbeat_flags: Sequence[int], n_frames: int, fps: float = 62.5
) -> np.ndarray:
    """Pulse built only from beats flagged as downbeats (position == 1)."""
    times = [t for t, d in zip(beat_times, downbeat_flags) if int(d) == 1]
    return beat_pulse(times, n_frames, fps)
