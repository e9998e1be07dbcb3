"""DBN/HMM beat decoder — madmom-equivalent dynamic Bayesian network (numpy).

The port's copy of zeronotesamba_tpu/decode/dbn.py, decoding with the exact
numpy Viterbi. The reference's headline numbers use madmom's
DBNBeatTrackingProcessor with min_bpm=55, max_bpm=215, transition_lambda=100,
fps=62.5 (Krebs, Böck & Widmer, ISMIR 2015):

- state space: one chain of ``tau`` position states per integer beat interval
  ``tau`` in [round(60*fps/max_bpm), round(60*fps/min_bpm)];
- transitions: +1 position advance inside a beat; at beat boundaries the
  interval may change with p ∝ exp(-lambda * |tau'/tau - 1|), normalized over
  successors and pruned below machine epsilon;
- observations: states in the first 1/observation_lambda of the beat emit the
  activation ``a``, all others ``(1-a)/(observation_lambda-1)``;
- offline decoding: exact Viterbi; beats at the activation argmax within each
  decoded beat window (``correct=True``) or at the position-wrap frames
  (``correct=False``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class DBNBeatDecoderConfig:
    min_bpm: float = 55.0
    max_bpm: float = 215.0
    fps: float = 62.5
    transition_lambda: float = 100.0
    observation_lambda: int = 16
    threshold: float = 0.0  # activations below are clipped (madmom default 0)
    correct: bool = True


@functools.lru_cache(maxsize=4)
def _state_space(cfg: DBNBeatDecoderConfig):
    min_tau = int(np.round(60.0 * cfg.fps / cfg.max_bpm))
    max_tau = int(np.round(60.0 * cfg.fps / cfg.min_bpm))
    intervals = np.arange(min_tau, max_tau + 1)
    n_int = len(intervals)
    offsets = np.concatenate([[0], np.cumsum(intervals)])
    firsts = offsets[:-1]
    lasts = offsets[1:] - 1
    positions = np.concatenate([np.arange(tau) / tau for tau in intervals])
    state_interval_idx = np.repeat(np.arange(n_int), intervals)

    # Tempo transition log-probs: from interval i -> interval j.
    ratio = intervals[None, :].astype(np.float64) / intervals[:, None]
    prob = np.exp(-cfg.transition_lambda * np.abs(ratio - 1.0))
    prob[prob <= np.spacing(1)] = 0.0
    prob /= prob.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_trans = np.log(prob)

    border = 1.0 / cfg.observation_lambda
    is_beat = positions < border
    return intervals, firsts, lasts, positions, state_interval_idx, log_trans, is_beat


def _viterbi_numpy(log_act, log_nact, intervals, firsts, lasts, log_trans, is_beat) -> np.ndarray:
    """Exact Viterbi over the beat state space; returns the state path."""
    n_frames = log_act.size
    n_states = is_beat.size
    n_int = len(intervals)
    v = np.full(n_states, -np.log(n_states))  # uniform initial distribution
    first_choice = np.empty((n_frames, n_int), dtype=np.int16)
    v_new = np.empty_like(v)
    for t in range(n_frames):
        # Tempo transitions into each interval's first state.
        cand = v[lasts][:, None] + log_trans  # (from, to)
        first_choice[t] = np.argmax(cand, axis=0)
        first_vals = cand[first_choice[t], np.arange(n_int)]
        # Shift within chains: state s takes v[s-1]; firsts overwritten below.
        v_new[1:] = v[:-1]
        v_new[firsts] = first_vals
        v_new += np.where(is_beat, log_act[t], log_nact[t])
        v, v_new = v_new, v

    path = np.empty(n_frames, dtype=np.int64)
    s = int(np.argmax(v))
    first_to_int = {int(f): i for i, f in enumerate(firsts)}
    for t in range(n_frames - 1, -1, -1):
        path[t] = s
        fi = first_to_int.get(s)
        s = int(lasts[first_choice[t, fi]]) if fi is not None else s - 1
    return path


def decode_beats(activations: np.ndarray, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig()) -> np.ndarray:
    """Beat times (seconds) from a per-frame beat activation in [0, 1]."""
    act = np.asarray(activations, dtype=np.float64).ravel()
    if cfg.threshold:
        act = np.where(act >= cfg.threshold, act, 0.0)
    if act.size == 0:
        return np.empty(0)

    intervals, firsts, lasts, positions, _, log_trans, is_beat = _state_space(cfg)

    eps = np.spacing(1)
    log_act = np.log(act + eps)
    log_nact = np.log((1.0 - act) / (cfg.observation_lambda - 1) + eps)
    path = _viterbi_numpy(log_act, log_nact, intervals, firsts, lasts, log_trans, is_beat)

    beat_range = is_beat[path]
    if cfg.correct:
        frames = _argmax_per_run(beat_range, act)
    else:
        frames = np.nonzero(np.diff(positions[path]) < 0)[0] + 1
    return frames / cfg.fps


def _argmax_per_run(beat_range: np.ndarray, act: np.ndarray) -> np.ndarray:
    """One beat per contiguous run of in-beat-window frames, at the activation peak."""
    edges = np.nonzero(np.diff(beat_range.astype(np.int8)))[0] + 1
    bounds = edges.tolist()
    if beat_range[0]:
        bounds = [0] + bounds
    if beat_range[-1]:
        bounds = bounds + [beat_range.size]
    frames = []
    for left, right in zip(bounds[0::2], bounds[1::2]):
        frames.append(left + int(np.argmax(act[left:right])))
    return np.asarray(frames, dtype=np.int64)


def beat_activation_to_times(
    activations: np.ndarray,
    *,
    min_bpm: float = 55.0,
    max_bpm: float = 215.0,
    fps: float = 62.5,
    transition_lambda: float = 100.0,
) -> np.ndarray:
    """Reference-parameterized DBN decode (evaluate.py:10 defaults), with the
    reference's correct=True -> correct=False fallback semantics."""
    cfg = DBNBeatDecoderConfig(
        min_bpm=min_bpm, max_bpm=max_bpm, fps=fps, transition_lambda=transition_lambda, correct=True
    )
    try:
        return decode_beats(activations, cfg)
    except Exception:
        return decode_beats(activations, dataclasses.replace(cfg, correct=False))
