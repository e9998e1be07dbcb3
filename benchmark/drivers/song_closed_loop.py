"""Serving driver: one caller tracks whole songs back to back (a closed loop).

Set-up makes the traffic's pool of songs and the configuration's weights
from the seed, builds the program's ``BeatTracker`` on them and tracks one
song twice, which builds and warms every kernel of the one song shape. The
window calls ``track_signal`` on the pool's songs in turn until
``seconds`` have passed; the last call ends the window. Each call is timed
from its start to its return with beats.

The check: for songs of the window drawn from the seed (each song's last
answer), the reference separates, transforms, encodes and decodes the same
signal with the same weights, and the answers are compared stage by stage.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import counts, dbn, hpss, models, vqt
from benchmark.reference.beat_metrics import f_measure
from benchmark.reference.songs import make_songs
from benchmark.reference.weights import make_weights

STREAMS = ("anchor_pulse", "positive_pulse", "fused_pulse")


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from zeronotesamba_torch.infer import BeatTracker

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.songs = make_songs(traffic, seed, traffic["pool"])
        self.weights = make_weights(config, seed, device)
        self.tracker = BeatTracker(self.weights, device=device)
        self.kw = dict(separation=traffic["separation"], decoder=traffic["decoder"])
        for _ in range(traffic["warm_calls"]):
            self.tracker.track_signal(self.songs[0][0], **self.kw)
        self.latencies: list = []
        self.answers: dict = {}
        self.attempted = self.failed = 0
        self.window_s = 0.0

    def window(self, seconds: float, span) -> None:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            k = self.attempted % len(self.songs)
            self.attempted += 1
            t0 = time.perf_counter()
            with span("song"):
                res = self.tracker.track_signal(self.songs[k][0], **self.kw)
            self.latencies.append(time.perf_counter() - t0)
            self.answers[k] = res
        self.window_s = time.perf_counter() - t_start

    def end_to_end(self) -> dict:
        minutes = len(self.latencies) * self.traffic["duration_s"] / 60.0
        lat = np.asarray(self.latencies)
        print(f"songs {lat.size}: latency median {np.median(lat) * 1e3:.3f} ms, p95 "
              f"{np.percentile(lat, 95) * 1e3:.3f} ms, max {lat.max() * 1e3:.3f} ms", flush=True)
        return {"song_latency_p95_ms": float(np.percentile(lat, 95) * 1e3),
                "audio_min_per_s": minutes / self.window_s}

    def facts(self) -> dict:
        samples = int(round(self.traffic["duration_s"] * self.traffic["sample_rate"]))
        frames = 1 + samples // vqt.HOP
        return {"flops": len(self.latencies) * counts.forward_flops(self.config, 1, frames),
                "vqt_bounds_s": counts.vqt_kernel_bounds_s(2, samples)}

    def release(self) -> None:
        self.tracker = None

    def readings(self, control: bool = False) -> dict:
        """The compared numbers over the songs drawn from the seed, stage by
        stage: the log-VQT against the reference's from the raw song; the
        pulses against the reference's encoders on the answer's own log-VQT;
        the beats against the reference's DBN on the answer's own fused
        pulse. With ``control``, the answers are the reference's own one
        precision below: its log-VQT in bfloat16 (TF32 leaves that
        transform as it is), its encoders with TF32 on."""
        rng = np.random.default_rng(int(self.seed) % 2**64)
        keys = sorted(self.answers)
        pick = rng.choice(keys, size=min(self.traffic["check_songs"], len(keys)), replace=False)
        out = {"vqt_gap": 0.0, "pulse_gap": 0.0, "beat_gap": 0.0}
        for k in pick:
            signal = self.songs[k][0]
            got = reference_answer(signal, self.weights, self.config, self.device, control=True) if control \
                else _as_dict(self.answers[k])
            ref_vqt = reference_vqt(signal, self.device, torch.float64)
            ref = reference_pulses(got["vqt"], self.weights, self.config, self.device, tf32=False)
            out["vqt_gap"] = max(out["vqt_gap"], vqt.peak_gap(got["vqt"], ref_vqt))
            out["pulse_gap"] = max(out["pulse_gap"], max(float(np.abs(got[s] - ref[s]).max()) for s in STREAMS))
            beats = dbn.beat_times(got["fused_pulse"])
            out["beat_gap"] = max(out["beat_gap"], 1.0 - f_measure(beats, got["beat_times"], 0.5 * vqt.HOP
                                                                 / vqt.SAMPLE_RATE))
        return out


def _as_dict(res) -> dict:
    return {"vqt": res.vqt, "anchor_pulse": res.anchor_pulse, "positive_pulse": res.positive_pulse,
            "fused_pulse": res.fused_pulse, "beat_times": res.beat_times}


def reference_vqt(signal: np.ndarray, device: str, dtype: torch.dtype) -> np.ndarray:
    """HPSS and the log-VQT in ``dtype`` of one song: (2, 96, frames),
    anchor (harmonic) then positive (percussive)."""
    with models.tf32(False), torch.no_grad():
        harm, perc = hpss.hpss(torch.as_tensor(signal, device=device)[None])
        return vqt.log_vqt(torch.cat([harm, perc]), dtype).double().cpu().numpy()


def reference_pulses(log_vqt: np.ndarray, weights: dict, config: dict, device: str, tf32: bool) -> dict:
    """The twin encoders in float32 (TF32 as asked) on a (2, 96, frames) log-VQT."""
    with models.tf32(tf32), torch.no_grad():
        x = torch.as_tensor(np.asarray(log_vqt), dtype=torch.float32, device=device)[None]
        la, lb = models.twin_logits(weights, x, config)
        pa, pb = torch.sigmoid(la)[0], torch.sigmoid(lb)[0]
        return {"anchor_pulse": pa.cpu().numpy(), "positive_pulse": pb.cpu().numpy(),
                "fused_pulse": torch.maximum(pa, pb).cpu().numpy()}


def reference_answer(signal: np.ndarray, weights: dict, config: dict, device: str, control: bool = False) -> dict:
    """The reference's whole answer for one song: separation, log-VQT, encoders, DBN; with
    ``control``, the log-VQT in bfloat16 and the encoders with TF32 on."""
    out = {"vqt": reference_vqt(signal, device, torch.bfloat16 if control else torch.float64)}
    out.update(reference_pulses(out["vqt"], weights, config, device, control))
    out["beat_times"] = dbn.beat_times(out["fused_pulse"])
    return out
