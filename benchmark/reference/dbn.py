"""The DBN beat decoder of Krebs, Boeck & Widmer (ISMIR 2015), plainly in numpy.

madmom's ``DBNBeatTrackingProcessor`` at the reference's settings: 55 to 215
BPM at 62.5 fps, one chain of ``tau`` position states a beat interval
``tau``, tempo changes at beat boundaries with probability proportional to
``exp(-100 |tau'/tau - 1|)`` (pruned below machine epsilon), observation
lambda 16 (the first 1/16 of each beat emits the activation), a uniform
start, exact Viterbi in float64, and one beat at the activation's peak in
each decoded beat window; if that fails, the frames where the position wraps.
"""

from __future__ import annotations

import numpy as np

MIN_BPM, MAX_BPM, FPS, LAMBDA, OBS_LAMBDA = 55.0, 215.0, 62.5, 100.0, 16


def _space():
    intervals = np.arange(int(np.round(60.0 * FPS / MAX_BPM)), int(np.round(60.0 * FPS / MIN_BPM)) + 1)
    offsets = np.concatenate([[0], np.cumsum(intervals)])
    firsts, lasts = offsets[:-1], offsets[1:] - 1
    positions = np.concatenate([np.arange(t) / t for t in intervals])
    ratio = intervals[None, :].astype(np.float64) / intervals[:, None]
    prob = np.exp(-LAMBDA * np.abs(ratio - 1.0))
    prob[prob <= np.spacing(1)] = 0.0
    prob /= prob.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_trans = np.log(prob)
    return intervals, firsts, lasts, positions, log_trans, positions < 1.0 / OBS_LAMBDA


def _viterbi(log_act, log_nact, firsts, lasts, log_trans, is_beat) -> np.ndarray:
    n_int = len(firsts)
    v = np.full(is_beat.size, -np.log(is_beat.size))
    choice = np.empty((log_act.size, n_int), dtype=np.int64)
    for t in range(log_act.size):
        cand = v[lasts][:, None] + log_trans
        choice[t] = np.argmax(cand, axis=0)
        new = np.empty_like(v)
        new[1:] = v[:-1]
        new[firsts] = cand[choice[t], np.arange(n_int)]
        v = new + np.where(is_beat, log_act[t], log_nact[t])
    path = np.empty(log_act.size, dtype=np.int64)
    s = int(np.argmax(v))
    first_of = {int(f): i for i, f in enumerate(firsts)}
    for t in range(log_act.size - 1, -1, -1):
        path[t] = s
        i = first_of.get(s)
        s = int(lasts[choice[t, i]]) if i is not None else s - 1
    return path


def _peaks(in_beat: np.ndarray, act: np.ndarray) -> np.ndarray:
    edges = (np.nonzero(np.diff(in_beat.astype(np.int8)))[0] + 1).tolist()
    bounds = ([0] if in_beat[0] else []) + edges + ([in_beat.size] if in_beat[-1] else [])
    return np.asarray([a + int(np.argmax(act[a:b])) for a, b in zip(bounds[0::2], bounds[1::2])], dtype=np.int64)


def beat_times(activation: np.ndarray) -> np.ndarray:
    """Beat times in seconds of a per-frame activation in [0, 1]."""
    act = np.asarray(activation, dtype=np.float64).ravel()
    if act.size == 0:
        return np.empty(0)
    _, firsts, lasts, positions, log_trans, is_beat = _space()
    eps = np.spacing(1)
    path = _viterbi(np.log(act + eps), np.log((1.0 - act) / (OBS_LAMBDA - 1) + eps), firsts, lasts, log_trans,
                    is_beat)
    try:
        frames = _peaks(is_beat[path], act)
    except ValueError:
        frames = np.nonzero(np.diff(positions[path]) < 0)[0] + 1
    return frames / FPS
