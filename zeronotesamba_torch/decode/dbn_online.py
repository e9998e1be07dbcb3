"""Online (streaming) DBN beat decoding — madmom process_online counterpart.

The port's copy of zeronotesamba_tpu/decode/dbn_online.py (host numpy).

The reference constructs its DBN with ``online=True`` (evaluate.py:10) even
though it decodes offline; the online capability itself is part of the
decoder surface. This module provides it: a forward-algorithm (sum-product)
posterior over the same beat state space, updated one frame at a time, with
beats emitted when the MAP state enters the beat window — usable for
streaming inference where Viterbi's full-sequence backtrack is unavailable.

Functionally equivalent to madmom's online mode (beat-window MAP crossing
with a refractory period of half the current beat interval), not bit-matched.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, _state_space


class OnlineBeatDecoder:
    """Feed activations frame by frame; collects beat times incrementally."""

    def __init__(self, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig()):
        self.cfg = cfg
        (self._intervals, self._firsts, self._lasts, self._positions,
         self._state_interval_idx, log_trans, self._is_beat) = _state_space(cfg)
        self._trans = np.exp(log_trans)  # (from, to), rows normalized
        self.reset()

    def reset(self):
        n = self._positions.size
        self._alpha = np.full(n, 1.0 / n)
        self._frame = 0
        self._last_beat_frame: Optional[int] = None
        self.beats: List[float] = []

    def process_frame(self, activation: float) -> Optional[float]:
        """One activation in [0,1]; returns a beat time if one fired."""
        cfg = self.cfg
        act = float(activation)
        # Transition: chains shift by one; first states collect from lasts.
        alpha_new = np.empty_like(self._alpha)
        alpha_new[1:] = self._alpha[:-1]
        alpha_new[self._firsts] = self._alpha[self._lasts] @ self._trans
        # Observation.
        obs = np.where(self._is_beat, act, (1.0 - act) / (cfg.observation_lambda - 1))
        alpha_new *= obs
        total = alpha_new.sum()
        if total > 0:
            alpha_new /= total
        self._alpha = alpha_new

        out = None
        state = int(np.argmax(alpha_new))
        if self._is_beat[state]:
            interval = self._intervals[self._state_interval_idx[state]]
            refractory = 0.5 * interval
            if self._last_beat_frame is None or self._frame - self._last_beat_frame > refractory:
                out = self._frame / cfg.fps
                self.beats.append(out)
                self._last_beat_frame = self._frame
        self._frame += 1
        return out

    def process(self, activations: np.ndarray) -> np.ndarray:
        """Stream a whole activation array; returns all beat times."""
        for a in np.asarray(activations).ravel():
            self.process_frame(float(a))
        return np.asarray(self.beats)


def decode_beats_online(activations: np.ndarray, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig()) -> np.ndarray:
    dec = OnlineBeatDecoder(cfg)
    return dec.process(activations)
