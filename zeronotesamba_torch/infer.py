"""One-call inference API (the reference sample_script.py as a library).

Port of zeronotesamba_tpu/infer.py. Pipeline: audio -> (anchor, positive)
streams via a separation backend -> 16 kHz -> batched log-VQT on the device
(the two Hopper kernels on a card) -> twin encoders -> per-stream and fused
per-frame pulse -> optional beat decode on the host.

``BeatThisTracker`` (``BeatTracker(model="beat_this")`` builds it) runs Beat
This! (models/beat_this.py) instead, on the mix: 22,050 Hz -> the log-mel on
the device -> the song's chunks of 1,500 frames as one batch -> beat and
downbeat logits -> the peak picker on the host (decode/peaks.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.separation import separate
from zeronotesamba_torch.decode import decode as decode_fn
from zeronotesamba_torch.decode.peaks import decode_peaks
from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.models import beat_this
from zeronotesamba_torch.models.encoder import FusedDownstream
from zeronotesamba_torch.models.separator import SEPARATOR_NPZ
from zeronotesamba_torch.models.weights import (load_beat_this_file, load_beat_this_state_dict, load_state_dict_file,
                                                load_weights, reference_state_dict)
from zeronotesamba_torch.ops import mel
from zeronotesamba_torch.ops.filterbank import XQTParams
from zeronotesamba_torch.ops.vqt import best_log_xqt
from zeronotesamba_torch.utils import profiling

SAMPLE_RATE = 16000
FPS = 62.5


@dataclasses.dataclass
class InferenceResult:
    anchor_pulse: np.ndarray  # (T,)
    positive_pulse: np.ndarray  # (T,)
    fused_pulse: np.ndarray  # (T,)
    beat_times: Optional[np.ndarray]  # decoded beats (seconds) or None
    vqt: np.ndarray  # (2, 96, T)

    def to_json(self) -> dict:
        """The frames and the beat times, as ``infer`` prints them."""
        return {"n_frames": int(self.fused_pulse.shape[0]),
                "beat_times": [float(t) for t in (self.beat_times if self.beat_times is not None else [])]}


class BeatTracker:
    """Pretrained fused model + decoder, reusable across files.

    ``params_or_state_dict``: None (random init from ``seed``), a state dict
    in the reference key names (``anchor.pretrained.cv1.weight``, ...), or a
    Flax params tree of numpy arrays (``{'params': {'pretext': ...}}``).
    ``model``: ``"down_cnn"`` (this tracker) or ``"beat_this"``, for which the
    call returns a ``BeatThisTracker`` on the other arguments; any other name
    raises.
    """

    # The CLI's track_file arguments where no flag sets them; load_file reads --params.
    TRACK_DEFAULTS = {"separation": "hpss", "decoder": "dbn", "sep_model": SEPARATOR_NPZ}
    load_file = staticmethod(load_state_dict_file)

    def __new__(cls, *args, model: str = "down_cnn", **kw):
        if model == "beat_this":
            return BeatThisTracker(*args, **kw)
        if model != "down_cnn":
            raise ValueError(f"unknown model {model!r} (expected down_cnn|beat_this)")
        return super().__new__(cls)

    def __init__(
        self,
        params_or_state_dict: Optional[Mapping[str, Any]] = None,
        *,
        model: str = "down_cnn",
        reduction: str = "max",
        seed: int = 0,
        device: str | torch.device = "cuda",
        compute_dtype: torch.dtype = torch.float32,
    ):
        self.device = resolve_device(device)
        if compute_dtype == torch.float32:
            disable_tf32()
        self.model = FusedDownstream(reduction=reduction, compute_dtype=compute_dtype)
        if params_or_state_dict is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            load_weights(self.model, params_or_state_dict)
        self.model.to(self.device).eval()

    def state_dict(self) -> dict:
        """The weights in the reference key names, on the CPU."""
        return reference_state_dict(self.model)

    def track_signal(
        self,
        signal: np.ndarray,
        sr: int = SAMPLE_RATE,
        *,
        separation: str = "hpss",
        stem_dir: Optional[str] = None,
        sep_model: Optional[str] = None,
        decoder: Optional[str] = "dbn",
        mode: str = "vqt",
    ) -> InferenceResult:
        with profiling.span("track", request=True):
            sig = np.asarray(signal, dtype=np.float32)
            if sr != SAMPLE_RATE:
                from zeronotesamba_torch.ops.resample import resample_poly_host

                sig = resample_poly_host(sig, sr, SAMPLE_RATE)
            with profiling.span("track.separate"):
                anchor, positive = separate(sig, SAMPLE_RATE, backend=separation, stem_dir=stem_dir,
                                            model_path=sep_model, device=self.device)
            params = XQTParams(sample_rate=SAMPLE_RATE, mode=mode)
            with torch.inference_mode():
                with profiling.span("track.upload"):
                    y = profiling.to_device(np.stack([anchor, positive]), self.device)
                with profiling.span("track.transform"):
                    vqts = best_log_xqt(y, params)  # (2, 96, T)
                with profiling.span("track.encode"):
                    anc_p, pos_p = self.model.pretext(vqts[0:1, None], vqts[1:2, None])
                    fused = self.model.fuse(anc_p, pos_p)
                with profiling.span("track.download"):
                    anc_np, pos_np, fused_np, vqt_np = (profiling.to_host(t)
                                                        for t in (anc_p[0], pos_p[0], fused[0], vqts))
            beats = decode_fn(fused_np, decoder, fps=FPS) if decoder else None
        return InferenceResult(
            anchor_pulse=anc_np,
            positive_pulse=pos_np,
            fused_pulse=fused_np,
            beat_times=beats,
            vqt=vqt_np,
        )

    def track_file(self, path: str, **kw) -> InferenceResult:
        sig, _ = audio_io.load_audio(path, target_sr=SAMPLE_RATE)
        return self.track_signal(sig, SAMPLE_RATE, **kw)


@dataclasses.dataclass
class BeatThisResult:
    beat_logits: np.ndarray  # (T,) at 50 fps
    downbeat_logits: np.ndarray  # (T,)
    beat_times: Optional[np.ndarray]  # decoded beats (seconds) or None
    downbeat_times: Optional[np.ndarray]  # decoded downbeats (seconds) or None
    mel: np.ndarray  # (T, 128) log-mel

    def to_json(self) -> dict:
        """The frames, the beat and the downbeat times, as ``infer`` prints them."""
        def times(t):
            return [float(x) for x in (t if t is not None else [])]

        return {"n_frames": int(self.beat_logits.shape[0]), "beat_times": times(self.beat_times),
                "downbeat_times": times(self.downbeat_times)}


class BeatThisTracker:
    """Beat This! + its peak picker, reusable across files.

    ``params_or_state_dict``: None (random init from ``seed``) or a state
    dict in the source's key names (``frontend.stem.conv2d.weight``, ...),
    whose shapes set the model's sizes. Float32, TF32 off.
    """

    # The CLI's track_file arguments where no flag sets them; load_file reads --params.
    TRACK_DEFAULTS = {"separation": "none", "decoder": "peaks"}
    load_file = staticmethod(load_beat_this_file)

    def __init__(self, params_or_state_dict: Optional[Mapping[str, Any]] = None, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        disable_tf32()
        if params_or_state_dict is None:
            self.model = beat_this.BeatThis()
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            sd = load_beat_this_state_dict(params_or_state_dict)
            self.model = beat_this.BeatThis(beat_this.BeatThisConfig.from_state_dict(sd))
            self.model.load_state_dict(sd)
        self.model.to(self.device).eval()

    def state_dict(self) -> dict:
        """The weights in the source's key names, on the CPU."""
        return reference_state_dict(self.model)

    def track_signal(self, signal: np.ndarray, sr: int = mel.SAMPLE_RATE, *, separation: str = "none",
                     decoder: Optional[str] = "peaks") -> BeatThisResult:
        """Tracks one song: the mix uploaded once, its log-mel on the device,
        the chunks as one batch, the logits and the log-mel downloaded, the
        peaks picked on the host (``decoder`` None: logits only). Beat This!
        tracks the mix: any other ``separation`` or ``decoder`` raises."""
        if separation != "none":
            raise ValueError(f"Beat This! tracks the mix: separation must be 'none', not {separation!r}")
        if decoder not in ("peaks", None):
            raise ValueError(f"Beat This! decodes with 'peaks' (or None), not {decoder!r}")
        with profiling.span("track", request=True):
            sig = np.asarray(signal, dtype=np.float32)
            if sr != mel.SAMPLE_RATE:
                from zeronotesamba_torch.ops.resample import resample_poly_host

                sig = resample_poly_host(sig, sr, mel.SAMPLE_RATE)
            with torch.inference_mode():
                with profiling.span("track.upload"):
                    y = profiling.to_device(sig, self.device)
                with profiling.span("track.transform"):
                    spec = mel.log_mel(y)  # (T, 128)
                with profiling.span("track.encode"):
                    chunks, starts = beat_this.split_chunks(spec)
                    profiling.count("beat_this.chunks", len(starts))
                    logits = torch.stack(self.model(chunks), dim=-1)  # (chunks, 1,500, 2)
                with profiling.span("track.download"):
                    logits_np = beat_this.aggregate_chunks(profiling.to_host(logits), starts, spec.shape[0])
                    mel_np = profiling.to_host(spec)
            beats = downbeats = None
            if decoder:
                with profiling.span("decode"):
                    beats, downbeats = decode_peaks(logits_np.T, fps=mel.FPS)
        return BeatThisResult(beat_logits=logits_np[:, 0], downbeat_logits=logits_np[:, 1], beat_times=beats,
                              downbeat_times=downbeats, mel=mel_np)

    def track_file(self, path: str, **kw) -> BeatThisResult:
        sig, _ = audio_io.load_audio(path, target_sr=mel.SAMPLE_RATE)
        return self.track_signal(sig, mel.SAMPLE_RATE, **kw)


# The trackers by the CLI's --model.
TRACKERS = {"down_cnn": BeatTracker, "beat_this": BeatThisTracker}
