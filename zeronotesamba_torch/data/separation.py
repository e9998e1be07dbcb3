"""Source-separation interface: stems from disk, built-in HPSS, or passthrough.

Port of zeronotesamba_tpu/data/separation.py with the backends

- ``stems``: pre-separated 4-stem WAVs ``<stem_dir>/{bass,drums,other,vocals}.wav``;
- ``hpss``: median-filter HPSS (ops/hpss.py) on ``device``, the percussive
  stream standing in for drums;
- ``mix``: anchor = positive = mix.

The ``learned`` backend needs the JAX package's orbax separator checkpoint
and is not ported yet (ROADMAP "Modules to port", item 9).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

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


def separate(
    signal: np.ndarray,
    sr: int,
    backend: str = "hpss",
    *,
    stem_dir: str | None = None,
    model_path: str | None = None,
    device: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (anchor, positive) streams for a mono signal."""
    if backend == "stems":
        if stem_dir is None:
            raise ValueError("backend='stems' requires stem_dir")
        return fold_stems(load_stem_dir(stem_dir, target_sr=sr))
    if backend == "hpss":
        from zeronotesamba_torch.ops.hpss import hpss_host

        harmonic, percussive = hpss_host(signal, device=device)
        return harmonic, percussive
    if backend == "learned":
        raise NotImplementedError(
            "separation backend 'learned' is not ported yet: it needs the orbax separator "
            "checkpoint (ROADMAP 'Modules to port', item 9)"
        )
    if backend == "mix":
        sig = np.asarray(signal, dtype=np.float32)
        return sig, sig.copy()
    raise ValueError(f"unknown separation backend {backend!r} (stems|hpss|learned|mix)")
