"""Synthetic click tracks with known beat annotations.

The port's copy of ``click_track``, ``percussive_pair`` and the helpers they
call from zeronotesamba_tpu/data/synthetic.py: clicks + harmonic
accompaniment + noise with exactly known beat times, the fixture for the
tests, the synthetic dataset (data/datasets.build_synthetic) and the chip
smoke run. With all difficulty knobs at 0 the tracks are metronomic and
clean. For a seed, each returns the JAX package's arrays bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _beat_grid(
    duration_s: float,
    bpm: float,
    phase_s: float,
    rng: np.random.Generator,
    *,
    jitter_s: float = 0.0,
    drift: float = 0.0,
    drift_cycle_beats: float = 12.0,
) -> np.ndarray:
    """Beat times with optional slow tempo drift and per-beat timing jitter.

    ``drift`` sinusoidally modulates the inter-beat period by up to that
    fraction over a ~``drift_cycle_beats``-beat cycle (rubato); ``jitter_s``
    adds i.i.d. Gaussian offsets to each beat (expressive micro-timing).
    The returned times are where the onsets actually land — they are the
    annotation, exactly as human annotators mark played (not nominal) beats.
    """
    period = 60.0 / bpm
    phi = rng.uniform(0, 2 * np.pi) if drift else 0.0
    times = []
    t = phase_s
    k = 0
    while t < duration_s - 0.05:
        times.append(t)
        p_k = period * (1.0 + drift * np.sin(2 * np.pi * k / drift_cycle_beats + phi))
        t += p_k
        k += 1
    times = np.asarray(times, dtype=np.float64)
    if jitter_s:
        times = times + rng.normal(0.0, jitter_s, size=times.shape)
        times = np.sort(times)
        times = times[(times >= 0.0) & (times < duration_s - 0.02)]
    return times


def _tone_burst(
    freq: float, length_s: float, sr: int, harmonics: int, decay: float = 0.2
) -> np.ndarray:
    """Exponentially enveloped harmonic stack (one synthetic drum hit)."""
    n = max(1, int(length_s * sr))
    env = np.exp(-np.arange(n) / (decay * n))
    tt = np.arange(n) / sr
    tone = np.zeros(n)
    if freq > 0:
        for h in range(1, max(1, harmonics) + 1):
            f_h = freq * h
            if f_h >= sr / 2:
                break
            tone += np.sin(2 * np.pi * f_h * tt) / np.sqrt(h)
    return env * tone


def _add_hits(
    sig: np.ndarray,
    times: np.ndarray,
    amps: np.ndarray,
    proto: np.ndarray,
    sr: int,
    rng: np.random.Generator,
    burst: float = 0.0,
) -> None:
    """Mix amplitude-scaled copies of ``proto`` into ``sig`` at ``times``."""
    n = len(sig)
    m = len(proto)
    env = np.exp(-np.arange(m) / (0.2 * m))
    for bt, a in zip(times, amps):
        i = int(round(bt * sr))
        if i >= n:
            continue
        piece = proto[: min(m, n - i)]
        if burst:
            piece = piece + burst * (env * rng.standard_normal(m))[: len(piece)]
        sig[i : i + len(piece)] += a * piece


def click_track(
    duration_s: float,
    bpm: float,
    sr: int = 16000,
    *,
    click_freq: float = 1500.0,
    click_len_s: float = 0.02,
    accomp: bool = True,
    noise: float = 0.003,
    phase_s: float = 0.1,
    harmonics: int = 1,
    burst: float = 0.0,
    jitter_s: float = 0.0,
    drift: float = 0.0,
    amp_sd: float = 0.0,
    drop_p: float = 0.0,
    offbeat: float = 0.0,
    offbeat_p: float = 0.75,
    offbeat_freq: Optional[float] = None,
    offbeat_swing: float = 0.0,
    offbeat_accent: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """A percussive click track at ``bpm`` with optional harmonic accompaniment.

    Returns ``(signal, beat_times)``; signal is float32 mono at ``sr``.

    ``harmonics > 1`` stacks 1/sqrt(h)-weighted partials on the click so its
    spectrum spans multiple octaves like a real drum hit. Pure-tone clicks
    (the default, kept for the DSP/decoder tests) concentrate all energy in
    ~1 VQT bin, which makes any click_freq change an unrealistically total
    domain shift.

    ``burst > 0`` adds an enveloped white-noise transient of that relative
    amplitude to each click — the broadband attack real drum hits have.

    Difficulty knobs (all default 0 = the metronomic clean fixture):

    - ``jitter_s``: per-beat Gaussian timing offset (expressive microtiming;
      annotations follow the played time).
    - ``drift``: sinusoidal tempo modulation depth over a ~12-beat cycle.
    - ``amp_sd``: per-beat log-normal amplitude sd (dynamics).
    - ``drop_p``: probability a beat's hit is attenuated to 10% (ghost
      beat — still annotated, like a drummer leaving out a hit).
    - ``offbeat``: relative amplitude of a hat layer on the half-beat grid
      (mid-beat AND on-beat slots) with its own brighter/shorter timbre
      (``offbeat_freq``, default 2.7x the click fundamental — a "hi-hat"
      against the "kick"). Because the hats play through, they carry no
      phase information: only the kick's timbre marks the beat, which is
      the onset-vs-beat ambiguity that makes real beat tracking a learning
      problem rather than onset thresholding.
    - ``offbeat_p``: per-slot probability of a hat hit.
    - ``offbeat_swing``: uniform jitter of the mid-slot position, as a
      fraction of the gap (swung hats) — keeps a spectral-flux + DP decoder
      from simply locking onto a clean half-period comb.
    """
    rng = np.random.default_rng(seed)
    n = int(round(duration_s * sr))
    t = np.arange(n) / sr
    sig = np.zeros(n, dtype=np.float64)

    beat_times = _beat_grid(duration_s, bpm, phase_s, rng, jitter_s=jitter_s, drift=drift)
    proto = _tone_burst(click_freq, click_len_s, sr, harmonics)

    amps = np.ones(len(beat_times))
    if amp_sd:
        amps *= np.exp(rng.normal(0.0, amp_sd, size=amps.shape))
    if drop_p:
        amps[rng.random(len(amps)) < drop_p] *= 0.1
    _add_hits(sig, beat_times, amps, proto, sr, rng, burst=burst)

    if offbeat and len(beat_times) > 1:
        gaps = np.diff(beat_times)
        # A hat layer that plays THROUGH: hits on every half-beat slot
        # INCLUDING the beats themselves, so the hat comb carries no phase
        # information — an amplitude/flux decoder sees a near-uniform
        # 8th-note grid and only the kick's timbre marks the beat (real kit
        # structure; this is what holds the no-learning old_school baseline
        # below the learned trackers, as in the reference's 0.748 < 0.875).
        pos = 0.5 + (rng.uniform(-offbeat_swing, offbeat_swing, size=len(gaps)) if offbeat_swing else 0.0)
        mids = beat_times[:-1] + pos * gaps
        slots = np.concatenate([mids, beat_times])
        # Off-beat ACCENTS (offbeat_accent > 1): the "and" hats play louder
        # than the on-beat hats — the classic disco/backbeat accent. Strong
        # accents put the flux maxima at the WRONG phase, which is the real
        # failure mode that holds amplitude-only trackers (old_school) to
        # ~0.75 on GTZAN while timbre-aware learned trackers sail past.
        accents = np.concatenate([
            np.full(len(mids), float(offbeat_accent)), np.ones(len(beat_times))
        ])
        keep = rng.random(len(slots)) < offbeat_p
        ob_freq = offbeat_freq if offbeat_freq is not None else 2.7 * max(click_freq, 200.0)
        ob_proto = _tone_burst(min(ob_freq, 0.45 * sr), 0.6 * click_len_s, sr, harmonics, decay=0.12)
        ob_amps = offbeat * accents[keep] * np.exp(rng.normal(0.0, 0.3, size=int(keep.sum())))
        _add_hits(sig, slots[keep], ob_amps, ob_proto, sr, rng, burst=burst)

    if accomp:
        # A slow chord progression so the "anchor" stream is non-trivial.
        for f0 in (220.0, 277.18, 329.63):
            sig += 0.08 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    if noise:
        sig += noise * rng.standard_normal(n)

    sig /= max(1.0, np.abs(sig).max() / 0.95)
    return sig.astype(np.float32), beat_times


def percussive_pair(
    duration_s: float,
    bpm: float,
    sr: int = 16000,
    seed: int = 0,
    *,
    harmonics: int = 1,
    click_freq: float = 1500.0,
    burst: float = 0.0,
    jitter_s: float = 0.0,
    drift: float = 0.0,
    amp_sd: float = 0.0,
    drop_p: float = 0.0,
    offbeat: float = 0.0,
    offbeat_p: float = 0.75,
    offbeat_swing: float = 0.0,
    offbeat_accent: float = 1.0,
    harm_offbeat: float = 0.0,
    harm_depth: float = 0.4,
    noise: float = 0.002,
    bleed: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchor, positive, beat_times): harmonic-only vs percussive-only stems.

    Mimics the pretext pair structure (drums stem vs rest-of-signal,
    reference pretext.py:30-86) for contrastive-training tests.
    ``click_freq`` sets the percussive fundamental — vary it per song so a
    corpus carries timbre diversity like a real dataset (each Ballroom/GTZAN
    song has its own drum sound); a corpus with ONE global click frequency
    lets the encoder memorize exact VQT bins, which destroys cross-corpus
    transfer in a way the reference's cross_data.xlsx never exhibits.

    Difficulty knobs forward to :func:`click_track` on the percussive stem;
    ``harm_offbeat`` additionally spikes the harmonic stem's amplitude
    envelope at off-beat positions (syncopated comping — a distractor pulse
    in the NON-percussive stream, so the beat is not recoverable from
    "any amplitude bump anywhere"). ``bleed`` cross-mixes a fraction of each
    stem into the other — the residual a real separator (Spleeter/HPSS)
    always leaves, so the pretext views are never perfectly disjoint.
    """
    clicks, beats = click_track(
        duration_s, bpm, sr, accomp=False, noise=0.0, harmonics=harmonics,
        click_freq=click_freq, burst=burst, jitter_s=jitter_s, drift=drift,
        amp_sd=amp_sd, drop_p=drop_p, offbeat=offbeat, offbeat_p=offbeat_p,
        offbeat_swing=offbeat_swing, offbeat_accent=offbeat_accent, seed=seed,
    )
    harm, _ = click_track(duration_s, bpm, sr, click_freq=0.0, click_len_s=1e-4, accomp=True, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    # Amplitude-modulate the harmonic stem at the played beats so both
    # streams carry the pulse (as real music stems do). The envelope follows
    # the ACTUAL (jittered/drifting) beat times, not a fixed cosine grid;
    # ``harm_depth`` sets how strongly the pulse shows in this stem (legato
    # accompaniment barely pulses — a deep fixed modulation hands an
    # onset-flux baseline a free beat comb in the mix).
    t = np.arange(len(harm)) / sr
    env = np.zeros(len(harm))
    width = 0.5 * 60.0 / bpm
    for bt in beats:
        env += np.clip(1.0 - np.abs(t - bt) / width, 0.0, 1.0) ** 2
    mod = (1.0 - harm_depth) + harm_depth * np.clip(env, 0.0, 1.0)
    if harm_offbeat and len(beats) > 1:
        mids = beats[:-1] + 0.5 * np.diff(beats)
        keep = rng.random(len(mids)) < 0.6
        spike = np.zeros(len(harm))
        for mt in mids[keep]:
            spike += np.clip(1.0 - np.abs(t - mt) / (0.35 * width), 0.0, 1.0) ** 2
        mod = mod + harm_offbeat * np.clip(spike, 0.0, 1.0)
    anchor = harm * mod
    if bleed:
        anchor, clicks = anchor + bleed * clicks, clicks + bleed * anchor
    anchor = (anchor + noise * rng.standard_normal(len(harm))).astype(np.float32)
    if noise:
        clicks = (clicks + noise * rng.standard_normal(len(clicks))).astype(np.float32)
    return anchor, clicks, beats
