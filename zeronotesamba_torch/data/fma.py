"""FMA-scale stem mining pipeline (port of zeronotesamba_tpu/data/fma.py).

Capability parity with the reference's FMA ETL (fma_loader.py):

- ``mine_stems``: walk an audio corpus in sorted order, separate each track
  (data/separation.separate; HPSS on ``device``), RMS-gate the drum stem
  (reference drum_load, fma_loader.py:153-175) and write
  ``<out>/<track_id>/{drums,other}.wav`` at 16 kHz (fma_loader.py:129-148).
  Resumable through a JSON watermark, ``<out>/.mined.json``, in place of the
  reference's hardcoded track-id marker (fma_loader.py:106-127).
- ``gen_clmr_bank``: the CLMR-baseline pair bank, two random crops of the
  SAME full-mix log-VQT per sample (reference gen_clmr, fma_loader.py:21-88),
  each log-VQT computed on ``device`` (the two Hopper kernels on a card).

Too-short audio, gate rejections and unreadable files are skipped, as the
reference does.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional

import numpy as np
import torch

from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.stems import rms_gate
from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.ops.vqt import generate_xqt
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("data.fma")
SAMPLE_RATE = 16000


def _watermark_path(out_root: str) -> str:
    return os.path.join(out_root, ".mined.json")


def load_watermark(out_root: str) -> set:
    try:
        with open(_watermark_path(out_root)) as fh:
            return set(json.load(fh)["done"])
    except (FileNotFoundError, json.JSONDecodeError, KeyError):
        return set()


def save_watermark(out_root: str, done: set):
    with open(_watermark_path(out_root), "w") as fh:
        json.dump({"done": sorted(done)}, fh)


def mine_stems(
    corpus_root: str,
    out_root: str,
    *,
    separation: str = "hpss",
    lower_p: float = 0.3,
    upper_p: float = 1.0,
    min_len_s: float = 10.0,
    limit: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> List[str]:
    """Separate + gate every wav under corpus_root; write accepted stems.

    Returns the track ids written this run. The drums/rest RMS gate mirrors
    check_drum_stem (stem_check.py:54-104): the drum stem must carry between
    half and 4x the rest-of-signal energy over (lower_p, upper_p) of frames.
    """
    from zeronotesamba_torch.data.separation import separate

    dev = resolve_device(device)
    os.makedirs(out_root, exist_ok=True)
    done = load_watermark(out_root)
    written = []
    for dirpath, _, files in sorted(os.walk(corpus_root)):
        for f in sorted(files):
            if not f.endswith(".wav"):
                continue
            tid = os.path.splitext(f)[0]
            if tid in done:
                continue
            if limit is not None and len(written) >= limit:
                return written
            try:
                sig, _ = audio_io.load_audio(os.path.join(dirpath, f), target_sr=SAMPLE_RATE)
                if len(sig) < min_len_s * SAMPLE_RATE:
                    log.info("too short: %s", tid)
                else:
                    anchor, positive = separate(sig, SAMPLE_RATE, backend=separation, device=dev)
                    if not rms_gate(anchor, positive, lower_p, upper_p):
                        log.info("gate rejected %s", tid)
                    else:
                        tdir = os.path.join(out_root, tid)
                        os.makedirs(tdir, exist_ok=True)
                        audio_io.write_wav(os.path.join(tdir, "drums.wav"), positive, SAMPLE_RATE)
                        audio_io.write_wav(os.path.join(tdir, "other.wav"), anchor, SAMPLE_RATE)
                        written.append(tid)
            except (ValueError, OSError) as e:  # bad audio: skip, like the reference
                log.warning("skipping %s: %s", tid, e)
            done.add(tid)
            save_watermark(out_root, done)
    return written


def gen_clmr_bank(
    corpus_root: str,
    n_samples: int,
    *,
    clip_frames: int = 313,
    clip_len_s: float = 10.0,
    seed: int = 0,
    mode: str = "vqt",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(N, 2, 96, clip_frames) bank of two random crops per full-mix VQT."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    wavs = []
    for dirpath, _, files in sorted(os.walk(corpus_root)):
        wavs.extend(os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".wav"))
    rng.shuffle(wavs)
    bank = []
    for path in wavs:
        if len(bank) >= n_samples:
            break
        try:
            sig, _ = audio_io.load_audio(path, target_sr=SAMPLE_RATE)
            n = int(clip_len_s * SAMPLE_RATE)
            if len(sig) < n + 1:
                continue
            start = rng.randint(0, len(sig) - n - 1)
            vqt = generate_xqt(sig[start : start + n], SAMPLE_RATE, mode, device=dev)
            t = vqt.shape[-1]
            if t < clip_frames + 1:
                continue
            s1 = rng.randint(0, t - clip_frames)
            s2 = rng.randint(0, t - clip_frames)
            bank.append(np.stack([vqt[:, s1 : s1 + clip_frames], vqt[:, s2 : s2 + clip_frames]]))
        except (ValueError, OSError) as e:
            log.warning("skipping %s: %s", path, e)
    return np.stack(bank).astype(np.float32)
