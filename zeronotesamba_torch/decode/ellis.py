"""Ellis dynamic-programming beat tracker (librosa.beat.beat_track equivalent).

The port's copy of zeronotesamba_tpu/decode/ellis.py (host numpy).

The reference uses librosa's tracker in two modes
(zeroNoteSamba/processing/evaluate.py:47-49 on model pulses;
zeroNoteSamba/old_school.py:29 on raw audio). librosa is unavailable here, so
this implements the published algorithm (D. Ellis, "Beat Tracking by Dynamic
Programming", JNMR 2007) with librosa's conventions: sr 16000, hop 256,
start_bpm 120, log-normal tempo prior (std 1 octave), tightness 100.
"""

from __future__ import annotations

import numpy as np

from zeronotesamba_torch.ops.mel import hz_to_mel, mel_to_hz


def estimate_tempo(
    onset_env: np.ndarray,
    fps: float,
    *,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_tempo: float = 320.0,
) -> float:
    """Tempo (BPM) from the onset autocorrelation with a log-normal prior."""
    onset = np.asarray(onset_env, dtype=np.float64)
    onset = onset - onset.mean()
    n = len(onset)
    if n < 4:
        return start_bpm
    # Autocorrelation via FFT.
    fft_n = int(2 ** np.ceil(np.log2(2 * n)))
    spec = np.fft.rfft(onset, fft_n)
    ac = np.fft.irfft(spec * np.conj(spec), fft_n)[:n]
    ac = np.maximum(ac, 0.0)

    lags = np.arange(1, n)
    bpms = 60.0 * fps / lags
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    prior[bpms > max_tempo] = 0.0
    weighted = ac[1:] * prior
    if weighted.max() <= 0:
        return start_bpm
    return float(bpms[np.argmax(weighted)])


def _local_score(onset_env: np.ndarray, period: int) -> np.ndarray:
    """Gaussian-smoothed, std-normalized onset envelope (Ellis' local score)."""
    onset = np.asarray(onset_env, dtype=np.float64)
    std = onset.std(ddof=1) if len(onset) > 1 else 1.0
    if std == 0:
        std = 1.0
    window = np.exp(-0.5 * ((np.arange(-period, period + 1) * 32.0 / period) ** 2))
    return np.convolve(onset / std, window, mode="same")


def beat_track_dp(
    onset_env: np.ndarray,
    fps: float = 62.5,
    *,
    bpm: float | None = None,
    start_bpm: float = 120.0,
    tightness: float = 100.0,
    trim: bool = True,
) -> np.ndarray:
    """Beat times (seconds) from an onset envelope / beat activation."""
    onset = np.asarray(onset_env, dtype=np.float64).ravel()
    if onset.size == 0 or not np.any(onset):
        return np.empty(0)
    if bpm is None:
        bpm = estimate_tempo(onset, fps, start_bpm=start_bpm)
    period = max(1, int(round(60.0 * fps / bpm)))

    localscore = _local_score(onset, period)
    backlink = np.full(len(localscore), -1, dtype=np.int64)
    cumscore = np.zeros(len(localscore))

    # Search window: previous beat in [-2*period, -period/2].
    window = np.arange(-2 * period, -int(np.round(period / 2)) + 1)
    txcost = -tightness * (np.log(-window / period) ** 2)

    first_beat = True
    score_thresh = 0.01 * np.abs(localscore).max()
    for i in range(len(localscore)):
        lo = i + window[0]
        candidates = txcost.copy()
        valid_from = max(0, -lo)
        candidates[:valid_from] = -np.inf
        idx = window + i
        scores = np.where(idx >= 0, cumscore[np.maximum(idx, 0)], -np.inf)
        total = candidates + scores
        best = int(np.argmax(total))
        cumscore[i] = localscore[i] + (total[best] if np.isfinite(total[best]) else 0.0)
        if first_beat and localscore[i] < score_thresh:
            backlink[i] = -1
        else:
            backlink[i] = idx[best] if np.isfinite(total[best]) else -1
            first_beat = False

    # Pick the last beat: last local max of cumscore above half the median peak.
    maxes = _local_max(cumscore)
    if not np.any(maxes):
        return np.empty(0)
    med = np.median(cumscore[maxes])
    good = np.nonzero(maxes & (cumscore >= 0.5 * med))[0]
    if good.size == 0:
        return np.empty(0)
    tail = int(good[-1])

    beats = [tail]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1], dtype=np.int64)

    if trim and beats.size:
        # Trim weak leading/trailing beats (below half the RMS of the
        # smoothed local score at beat locations) — librosa's trim behavior.
        smooth = localscore
        thresh = 0.5 * np.sqrt(np.mean(np.maximum(smooth[beats], 0.0) ** 2))
        keep = smooth[beats] > thresh
        if np.any(keep):
            first, last = np.argmax(keep), len(keep) - np.argmax(keep[::-1]) - 1
            beats = beats[first : last + 1]
        else:
            beats = beats[:0]
    return beats / fps


def _local_max(x: np.ndarray) -> np.ndarray:
    pad = np.r_[-np.inf, x, -np.inf]
    return (pad[1:-1] > pad[:-2]) & (pad[1:-1] >= pad[2:])


def onset_strength(
    signal: np.ndarray,
    sr: int = 16000,
    hop: int = 256,
    n_fft: int = 2048,
    n_mels: int = 128,
) -> np.ndarray:
    """Spectral-flux onset envelope (librosa.onset.onset_strength equivalent):
    mel power spectrogram -> dB -> first-order time difference -> half-wave
    rectify -> mean over bands. Used by the old-school baseline on raw audio
    (reference old_school.py:29)."""
    y = np.asarray(signal, dtype=np.float64)
    ypad = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + len(y) // hop
    window = np.hanning(n_fft + 1)[:-1]
    frames = np.lib.stride_tricks.sliding_window_view(ypad, n_fft)[:: hop][:n_frames]
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2  # (T, n_fft//2+1)
    mel_fb = _mel_filterbank(sr, n_fft, n_mels)
    mels = spec @ mel_fb.T
    db = 10.0 * np.log10(np.maximum(mels, 1e-10))
    db -= db.max()
    diff = np.diff(db, axis=0, prepend=db[:1])
    flux = np.maximum(diff, 0.0).mean(axis=1)
    return flux


def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    fmax = sr / 2.0
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, fmax, n_fft // 2 + 1)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / max(freqs[i + 1] - freqs[i], 1e-9)
        upper = (freqs[i + 2] - fft_freqs) / max(freqs[i + 2] - freqs[i + 1], 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
        # Slaney normalization: constant energy per band.
        enorm = 2.0 / (freqs[i + 2] - freqs[i])
        fb[i] *= enorm
    return fb


def beat_track_signal(signal: np.ndarray, sr: int = 16000, hop: int = 256) -> np.ndarray:
    """Raw-audio Ellis baseline (reference old_school.dp_ellis equivalent)."""
    env = onset_strength(signal, sr=sr, hop=hop)
    return beat_track_dp(env, fps=sr / hop)
