"""Serving driver for whole songs: one caller tracks songs of 2 to 5 minutes
back to back (a closed loop) with Beat This!.

Set-up makes the traffic's pool (one click-track song a length in
``lengths_s``, at ``sample_rate``, the ``tempos`` in an order drawn from the
seed) and the configuration's weights from the seed, sets the head's biases
from the reference on each song's first 1,488 frames (``beat_this.bias_head``: about
2 beats and 0.5 downbeats a second, where random weights' offset would leave
no peak or too many), builds the program's ``BeatTracker(model="beat_this")``
on them (a program without Beat This! raises there) and tracks one song of
each distinct chunk count once. The window calls ``track_signal`` on the
pool's songs in turn until ``seconds`` have passed; the last call ends the
window. Each call is timed from its start to its return with beats and
downbeats.

The check: for songs of the window drawn from the seed (each song's last
answer), stage by stage, the log-mel against the reference's float64 one
from the raw song; the logits against the reference model run chunk by
chunk on the answer's own log-mel; the beat and downbeat times against the
reference's post-processing on the answer's own logits.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.reference import beat_this, songs


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from zeronotesamba_torch.infer import BeatTracker

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.songs = make_pool(traffic, seed)
        self.weights = beat_this.make_weights(config, seed, device)
        one_chunk = (config["chunk_size"] - 2 * config["border_size"] - 1) * config["hop"]  # samples: 1,488 frames
        beat_this.bias_head(self.weights, [beat_this.log_mel(s[:one_chunk], config, device)
                                           for s, _ in self.songs], config, device)
        self.tracker = BeatTracker(self.weights, model="beat_this", device=device)
        self.kw = dict(separation=traffic["separation"], decoder=traffic["decoder"])
        warm: dict = {}  # the first song of each chunk count
        for signal, _ in self.songs:
            warm.setdefault(len(chunk_frames(song_frames(signal, config), config)), signal)
        for signal in warm.values():
            self.tracker.track_signal(signal, traffic["sample_rate"], **self.kw)
        self.latencies: list = []
        self.tracked: list = []  # pool index of each song of the window
        self.answers: dict = {}
        self.attempted = self.failed = 0
        self.window_s = 0.0

    def window(self, seconds: float, span) -> None:
        sr = self.traffic["sample_rate"]
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            k = self.attempted % len(self.songs)
            self.attempted += 1
            t0 = time.perf_counter()
            with span("song"):
                res = self.tracker.track_signal(self.songs[k][0], sr, **self.kw)
            self.latencies.append(time.perf_counter() - t0)
            self.tracked.append(k)
            self.answers[k] = res
        self.window_s = time.perf_counter() - t_start

    def end_to_end(self) -> dict:
        minutes = sum(self.songs[k][1] for k in self.tracked) / 60.0
        lat = np.asarray(self.latencies)
        print(f"songs {lat.size}: latency median {np.median(lat) * 1e3:.3f} ms, p95 "
              f"{np.percentile(lat, 95) * 1e3:.3f} ms, max {lat.max() * 1e3:.3f} ms", flush=True)
        return {"song_latency_p95_ms": float(np.percentile(lat, 95) * 1e3),
                "audio_min_per_s": minutes / self.window_s}

    def facts(self) -> dict:
        """The window's frozen counts: forward and attention FLOPs of every
        chunk of every song tracked, and the chunks."""
        flops = attn = 0.0
        chunks = 0
        for k in self.tracked:
            for frames in chunk_frames(song_frames(self.songs[k][0], self.config), self.config):
                flops += beat_this.forward_flops(self.config, frames)
                attn += beat_this.attention_flops(self.config, frames)
                chunks += 1
        return {"flops": flops, "attn_flops": attn, "chunks": chunks}

    def release(self) -> None:
        self.tracker = None

    def readings(self, control: bool = False) -> dict:
        """The compared numbers over the songs drawn from the seed, stage by
        stage (module docstring). ``mel_gap``: the largest absolute gap;
        ``logit_gap``: the largest gap of either logit over the largest
        reference logit; ``beat_gap``: the beat and downbeat times in one
        answer and not the other, counted. With ``control``, the answers are
        the reference's own one precision below: its log-mel in bfloat16, its
        model with TF32 on."""
        cfg, dev = self.config, self.device
        rng = np.random.default_rng(int(self.seed) % 2**64)
        keys = sorted(self.answers)
        pick = rng.choice(keys, size=min(self.traffic["check_songs"], len(keys)), replace=False)
        out = {"mel_gap": 0.0, "logit_gap": 0.0, "beat_gap": 0.0}
        counts = []
        for k in pick:
            signal = self.songs[k][0]
            got = reference_answer(signal, self.weights, cfg, dev) if control else _as_dict(self.answers[k])
            ref_mel = beat_this.log_mel(signal, cfg, dev)
            out["mel_gap"] = max(out["mel_gap"], float(np.abs(got["mel"] - ref_mel).max()))
            rb, rd = beat_this.predict(self.weights, got["mel"], cfg, dev)
            scale = max(float(np.abs(rb).max()), float(np.abs(rd).max()))
            gap = max(float(np.abs(got["beat_logits"] - rb).max()), float(np.abs(got["downbeat_logits"] - rd).max()))
            out["logit_gap"] = max(out["logit_gap"], gap / scale)
            beats, downs = beat_this.postprocess(got["beat_logits"], got["downbeat_logits"], cfg["fps"])
            missed = (len(np.setxor1d(beats, got["beat_times"])) + len(np.setxor1d(downs, got["downbeat_times"])))
            out["beat_gap"] = max(out["beat_gap"], float(missed))
            counts.append((int(k), len(beats), len(downs)))
        print(f"checked songs (pool index, beats, downbeats): {counts}", file=sys.stderr, flush=True)
        return out


def make_pool(traffic: dict, seed: int) -> list:
    """(float32 signal, length in s) of each song of the pool: one a length
    of ``lengths_s``; the ``tempos`` evenly spaced values of ``bpm_range`` in
    an order drawn from the seed, song ``i`` at the ``i % tempos``-th, so
    every seed tracks each tempo as often; its timbre, phase and every other
    draw from its own seed."""
    lengths, n = traffic["lengths_s"], traffic["tempos"]
    order = np.random.default_rng(songs.song_seed(seed, len(lengths))).permutation(n)
    tempos = np.linspace(*traffic["bpm_range"], n)[order]
    out = []
    for i, length in enumerate(lengths):
        s = songs.song_seed(seed, i)
        rng = np.random.default_rng(s)
        flo, fhi = traffic["click_freq_range"]
        bpm = float(tempos[i % n])
        signal, _ = songs.click_track(float(length), bpm, traffic["sample_rate"],
                                      click_freq=float(rng.uniform(flo, fhi)),
                                      phase_s=float(rng.uniform(0.0, 60.0 / bpm)), seed=s, **traffic["song"])
        out.append((signal, float(length)))
    return out


def song_frames(signal: np.ndarray, cfg: dict) -> int:
    return 1 + len(signal) // cfg["hop"]


def chunk_frames(frames: int, cfg: dict) -> list:
    """The frames of each chunk of a song of ``frames``."""
    starts = beat_this.chunk_starts(frames, cfg)
    if frames <= cfg["chunk_size"] - 2 * cfg["border_size"]:
        return [frames + 2 * cfg["border_size"]]
    return [cfg["chunk_size"]] * len(starts)


def _as_dict(res) -> dict:
    return {"mel": res.mel, "beat_logits": res.beat_logits, "downbeat_logits": res.downbeat_logits,
            "beat_times": res.beat_times, "downbeat_times": res.downbeat_times}


def reference_answer(signal: np.ndarray, weights: dict, cfg: dict, device: str) -> dict:
    """The control: the reference's whole answer for one song, its log-mel in
    bfloat16 and its model with TF32 on."""
    mel = beat_this.log_mel(signal, cfg, device, torch.bfloat16)
    beat, down = beat_this.predict(weights, mel, cfg, device, tf32_on=True)
    beats, downs = beat_this.postprocess(beat, down, cfg["fps"])
    return {"mel": mel, "beat_logits": beat, "downbeat_logits": down, "beat_times": beats, "downbeat_times": downs}
