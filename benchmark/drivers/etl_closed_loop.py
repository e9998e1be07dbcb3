"""Dataset-ETL driver: one caller builds records back to back (a closed loop),
as the program's dataset builders do (``data/datasets._iter_build``), with
Spleeter separation.

Set-up loads the program's Spleeter (a program without it fails here, at
once), makes the traffic's pool (``pool`` songs of ``duration_s`` at
``sample_rate``, the ``tempos`` in an order drawn from the seed, exact
beats; held in memory, so no file is read in the window) and the
configuration's weights from the seed (``reference/spleeter.make_weights``,
the source's names), loads them into the program's ``Spleeter`` and builds
``warm_calls`` records of the first song. The window calls
``build_record(name, song, beats, sr=sample_rate, separation="spleeter",
sep_model=<that Spleeter>)`` on the pool's songs in turn until ``seconds``
have passed; the last call ends the window. Each call is timed from its
start to its return with the record.

The check: for ``check_songs`` songs drawn from the seed at set-up, each
one's last record of the window and the stages of that call as the program
computed them (``Spleeter.last``, copied on the device: the magnitude, the
four masks and the two 16 kHz streams), stage by stage against the
reference: the magnitude against its float64 STFT of the raw song; the
masks against its nets on the answer's own magnitude; the streams against
its float64 inverse STFTs, fold and resample on the answer's own masks; the
record's log-VQTs against its float64 log-VQT of the answer's own streams.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import counts, songs, spleeter, vqt


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from zeronotesamba_torch.data.annotations import BeatAnnotation
        from zeronotesamba_torch.data.datasets import build_record
        from zeronotesamba_torch.models.spleeter import Spleeter, SpleeterConfig
        from zeronotesamba_torch.models.weights import spleeter_state_dict_from_source

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.build, self.annotation = build_record, BeatAnnotation
        self.songs = make_pool(traffic, seed)
        self.weights = spleeter.make_weights(config, seed, device)
        cfg = SpleeterConfig(filters=tuple(config["conv_n_filters"]), T=config["T"], F=config["F"],
                             instruments=tuple(config["instrument_list"]), bn_eps=config["bn_eps"],
                             leaky_slope=config["leaky_relu_alpha"], dropout=config["dropout"],
                             epsilon=config["epsilon"])
        with torch.device(device):  # its default initialisation, overwritten next, on the device
            self.model = Spleeter(cfg)
        self.model.load_state_dict(spleeter_state_dict_from_source(self.weights, cfg.instruments))
        self.model.eval()
        if spleeter.n_segments(len(self.songs[0][0]), config) != traffic["segments"]:
            raise ValueError(f"a song of {traffic['duration_s']} s is not {traffic['segments']} segments")
        rng = np.random.default_rng(int(seed) % 2**64)
        self.pick = sorted(rng.choice(len(self.songs), size=min(traffic["check_songs"], len(self.songs)),
                                      replace=False).tolist())
        for _ in range(traffic["warm_calls"]):
            self._record(0)
        self.latencies: list = []
        self.built: list = []  # pool index of each record of the window
        self.kept: dict = {}  # a checked song's last record's log-VQTs and the separator's stages
        self.attempted = self.failed = 0
        self.window_s = 0.0

    def _record(self, k: int):
        signal, beats = self.songs[k]
        return self.build(f"song{k:03d}", signal, self.annotation(list(beats)), sr=self.traffic["sample_rate"],
                          separation=self.traffic["separation"], sep_model=self.model, device=self.device)

    def window(self, seconds: float, span) -> None:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            k = self.attempted % len(self.songs)
            self.attempted += 1
            t0 = time.perf_counter()
            with span("build"):
                rec = self._record(k)
            self.latencies.append(time.perf_counter() - t0)
            self.built.append(k)
            if k in self.pick:  # a copy: on a card the next call overwrites the graphs' tensors
                self.kept[k] = dict({name: t.clone() for name, t in self.model.last.items()}, vqt=rec.vqt)
        self.window_s = time.perf_counter() - t_start

    def end_to_end(self) -> dict:
        minutes = len(self.latencies) * self.traffic["duration_s"] / 60.0
        lat = np.asarray(self.latencies)
        print(f"records {lat.size}: latency median {np.median(lat) * 1e3:.3f} ms, p95 "
              f"{np.percentile(lat, 95) * 1e3:.3f} ms, max {lat.max() * 1e3:.3f} ms", flush=True)
        return {"audio_min_per_s": minutes / self.window_s}

    def facts(self) -> dict:
        """The window's frozen counts: the four nets' FLOPs on every segment
        of every record built, the records and the segments; the log-VQT
        kernels' least times a launch (one stream a launch, two a record, of
        ``duration_s`` at the downstream rate)."""
        segments = sum(spleeter.n_segments(len(self.songs[k][0]), self.config) for k in self.built)
        samples = round(self.traffic["duration_s"] * self.config["downstream_sample_rate"])
        return {"flops": spleeter.spleeter_flops(self.config, segments), "records": len(self.built),
                "segments": segments, "vqt_bounds_s": counts.vqt_kernel_bounds_s(1, samples)}

    def release(self) -> None:
        self.model = None

    def _control(self, signal: np.ndarray) -> dict:
        """The reference's own answer one precision below: its STFT rounded
        to bfloat16, its nets with TF32 on, its inverse and resample in
        float32 on that STFT, its log-VQT in bfloat16."""
        cfg = self.config
        spec = spleeter.stft(signal, cfg, self.device, torch.bfloat16)
        mag = spleeter.magnitude(spec, cfg, torch.bfloat16)
        masks = spleeter.masks(self.weights, mag, cfg, tf32_on=True)
        streams = spleeter.streams(spec, masks, len(signal), cfg)
        with torch.no_grad():
            log_vqt = vqt.log_vqt(streams, torch.bfloat16).double().cpu().numpy()
        return {"magnitude": mag, "masks": masks, "streams": streams, "vqt": log_vqt}

    def readings(self, control: bool = False) -> dict:
        """The compared numbers over the checked songs, stage by stage
        (module docstring). ``spec_gap``: the largest gap of the magnitude
        over the song's largest reference magnitude; ``mask_gap``: the
        largest gap of any mask; ``stream_gap``: the largest gap of either
        stream over that stream's reference peak; ``etl_vqt_gap``: as the
        fine-tune cell's (``vqt.peak_gap``). A checked song the window never
        built reads NaN. With ``control``, the answers are ``_control``'s."""
        cfg = self.config
        out = {"spec_gap": 0.0, "mask_gap": 0.0, "stream_gap": 0.0, "etl_vqt_gap": 0.0}
        for k in self.pick:
            if k not in self.kept and not control:
                return {name: float("nan") for name in out}
            signal = self.songs[k][0]
            got = self._control(signal) if control else self.kept[k]
            spec = spleeter.stft(signal, cfg, self.device)
            ref_mag = spleeter.magnitude(spec, cfg, torch.float64)
            gap = (got["magnitude"].double() - ref_mag).abs().max() / ref_mag.max()
            out["spec_gap"] = max(out["spec_gap"], float(gap))
            ref_masks = spleeter.masks(self.weights, got["magnitude"], cfg)
            out["mask_gap"] = max(out["mask_gap"], float((got["masks"] - ref_masks).abs().max()))
            ref_streams = spleeter.streams(spec, got["masks"], len(signal), cfg)
            streams = got["streams"].double()
            if streams.shape != ref_streams.shape:
                return {name: float("nan") for name in out}
            gap = ((streams - ref_streams).abs().amax(-1) / ref_streams.abs().amax(-1)).max()
            out["stream_gap"] = max(out["stream_gap"], float(gap))
            with torch.no_grad():
                ref_vqt = vqt.log_vqt(streams, torch.float64).cpu().numpy()
            out["etl_vqt_gap"] = max(out["etl_vqt_gap"], vqt.peak_gap(got["vqt"], ref_vqt))
        return out


def make_pool(traffic: dict, seed: int) -> list:
    """(float32 signal, beat times) of each of the pool's ``pool`` songs of
    ``duration_s``: the ``tempos`` evenly spaced values of ``bpm_range`` in
    an order drawn from the seed, song ``i`` at the ``i % tempos``-th, so
    every seed builds each tempo as often; its timbre, phase and every other
    draw from its own seed."""
    n = traffic["tempos"]
    order = np.random.default_rng(songs.song_seed(seed, traffic["pool"])).permutation(n)
    tempos = np.linspace(*traffic["bpm_range"], n)[order]
    out = []
    for i in range(traffic["pool"]):
        s = songs.song_seed(seed, i)
        rng = np.random.default_rng(s)
        flo, fhi = traffic["click_freq_range"]
        bpm = float(tempos[i % n])
        out.append(songs.click_track(traffic["duration_s"], bpm, traffic["sample_rate"],
                                     click_freq=float(rng.uniform(flo, fhi)),
                                     phase_s=float(rng.uniform(0.0, 60.0 / bpm)), seed=s, **traffic["song"]))
    return out
