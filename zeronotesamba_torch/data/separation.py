"""Source-separation interface: stems from disk, built-in HPSS, or passthrough.

Port of zeronotesamba_tpu/data/separation.py with the backends

- ``stems``: pre-separated 4-stem WAVs ``<stem_dir>/{bass,drums,other,vocals}.wav``;
- ``hpss``: median-filter HPSS (ops/hpss.py) on ``device``, the percussive
  stream standing in for drums;
- ``learned``: the trained STFT-mask separator (models/separator.py, trained
  by train/separator.py) on ``device``, from an ``.npz`` of its Flax tree
  (the shipped ``models/separator.SEPARATOR_NPZ`` by default on the CLI);
- ``spleeter``: Spleeter 4stems (models/spleeter.py) on ``device``: the
  song at its own rate in, (anchor, positive) at 16 kHz out, whatever
  ``sr``; its weights from ``model_path``, an ``.npz`` under the source's
  variable names (``models/weights.load_spleeter_file``), or seeded (seed 0)
  without one, or the loaded ``model`` a caller passes;
- ``mix``: anchor = positive = mix.

Every other backend returns the streams at ``sr``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.stems import fold_stems

STEM_NAMES = ("bass", "drums", "other", "vocals")


def load_stem_dir(track_dir: str, target_sr: int = 16000) -> Dict[str, np.ndarray]:
    stems = {}
    for name in STEM_NAMES:
        path = os.path.join(track_dir, f"{name}.wav")
        if os.path.exists(path):
            sig, _ = audio_io.load_audio(path, target_sr=target_sr)
            stems[name] = sig
    if not stems:
        raise FileNotFoundError(f"no stem wavs in {track_dir}")
    n = min(len(s) for s in stems.values())
    return {k: v[:n] for k, v in stems.items()}


_LEARNED_MODEL_CACHE: Dict[tuple, object] = {}
_SPLEETER_CACHE: Dict[tuple, object] = {}


def _learned_model(model_path: str, device):
    """The MaskNet of ``model_path`` on ``device``, loaded once per (path,
    device): a track-dir sweep calls ``separate`` once per file."""
    from zeronotesamba_torch.device import resolve_device
    from zeronotesamba_torch.models.separator import load_separator

    key = (os.path.abspath(model_path), str(resolve_device(device)))
    if key not in _LEARNED_MODEL_CACHE:
        _LEARNED_MODEL_CACHE[key] = load_separator(key[0], device=key[1])
    return _LEARNED_MODEL_CACHE[key]


def _spleeter_model(model_path: str | None, device):
    """Spleeter from ``model_path`` (seeded, seed 0, for None) on ``device``,
    loaded once per (path, device)."""
    from zeronotesamba_torch.device import resolve_device
    from zeronotesamba_torch.models.spleeter import Spleeter
    from zeronotesamba_torch.models.weights import load_spleeter_file

    dev = resolve_device(device)
    key = (model_path and os.path.abspath(model_path), str(dev))
    if key not in _SPLEETER_CACHE:
        if model_path is None:
            model = Spleeter()
            model.reset_parameters(torch.Generator().manual_seed(0))
            model = model.to(dev).eval()
        else:
            model = load_spleeter_file(key[0], dev)
        _SPLEETER_CACHE[key] = model
    return _SPLEETER_CACHE[key]


def separate(
    signal: np.ndarray,
    sr: int,
    backend: str = "hpss",
    *,
    stem_dir: str | None = None,
    model_path: str | None = None,
    model=None,
    device: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (anchor, positive) streams for a mono signal (at 16 kHz for
    ``spleeter``, at ``sr`` for the rest)."""
    if backend == "spleeter":
        if model is None:
            model = _spleeter_model(model_path, device)
        return model.separate(signal, sr)
    if backend == "stems":
        if stem_dir is None:
            raise ValueError("backend='stems' requires stem_dir")
        return fold_stems(load_stem_dir(stem_dir, target_sr=sr))
    if backend == "hpss":
        from zeronotesamba_torch.ops.hpss import hpss_host

        harmonic, percussive = hpss_host(signal, device=device)
        return harmonic, percussive
    if backend == "learned":
        if model_path is None:
            raise ValueError("backend='learned' requires model_path (train via `train-separator`)")
        from zeronotesamba_torch.train.separator import separate_learned

        drums, rest = separate_learned(signal, _learned_model(model_path, device))
        return rest, drums  # (anchor=rest-of-signal, positive=drums)
    if backend == "mix":
        sig = np.asarray(signal, dtype=np.float32)
        return sig, sig.copy()
    raise ValueError(f"unknown separation backend {backend!r} (stems|hpss|learned|spleeter|mix)")
