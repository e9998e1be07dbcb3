"""One-call inference API (the reference sample_script.py as a library).

Port of zeronotesamba_tpu/infer.py. Pipeline: audio -> (anchor, positive)
streams via a separation backend -> 16 kHz -> batched log-VQT on the device
(the two Hopper kernels on a card) -> twin encoders -> per-stream and fused
per-frame pulse -> optional beat decode on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.separation import separate
from zeronotesamba_torch.decode import decode as decode_fn
from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.models.encoder import FusedDownstream
from zeronotesamba_torch.models.weights import load_weights, reference_state_dict
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


class BeatTracker:
    """Pretrained fused model + decoder, reusable across files.

    ``params_or_state_dict``: None (random init from ``seed``), a state dict
    in the reference key names (``anchor.pretrained.cv1.weight``, ...), or a
    Flax params tree of numpy arrays (``{'params': {'pretext': ...}}``).
    """

    def __init__(
        self,
        params_or_state_dict: Optional[Mapping[str, Any]] = None,
        *,
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
