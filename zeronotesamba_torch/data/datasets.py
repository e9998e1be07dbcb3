"""Dataset ETL: Ballroom / GTZAN / Hainsworth / SMC -> array records.

Port of zeronotesamba_tpu/data/datasets.py. One builder per dataset emits a
``BeatDataset`` of per-song records:

- ``vqt``: (S, 96, T) float32 log-VQT, S=1 (mix) or S=2 (anchor/positive via
  a separation backend; the reference used Spleeter here);
- ``pulse`` / ``down_pulse``: (T,) supervision targets (data/pulse.py);
- ``beat_times`` / ``downbeat_times``: seconds.

Storage is one compressed .npz per song under a dataset directory plus an
``index.json``, in the JAX package's format, so a cache written by either
package loads in the other. Each stream's log-VQT is one ``generate_xqt``
call on ``device``: on a card that is the two Hopper kernels
(ops/cuda/vqt_kernel.log_xqt_fused), one cascade and one octave launch.
Unlike the JAX builders, every builder here takes that ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.annotations import (
    BeatAnnotation,
    parse_ballroom_beats,
    parse_hainsworth_master,
    parse_jams_beats,
    parse_smc_beats,
)
from zeronotesamba_torch.data.pulse import beat_pulse
from zeronotesamba_torch.ops.vqt import generate_xqt

SAMPLE_RATE = 16000
FPS = 62.5

# Known Ballroom duplicates skipped by the reference (ballroom.py:34-49).
BALLROOM_DUPLICATES = (
    "Albums-AnaBelen_Veneo-11",
    "Albums-Fire-08",
    "Albums-Latin_Jam2-05",
    "Albums-Secret_Garden-01",
    "Albums-AnaBelen_Veneo-03",
    "Albums-Ballroom_Magic-03",
    "Albums-Latin_Jam-04",
    "Albums-Latin_Jam-08",
    "Albums-Latin_Jam-06",
    "Albums-Latin_Jam2-02",
    "Albums-Latin_Jam2-07",
    "Albums-Latin_Jam3-02",
    "Media-103402",
    "README",
)

BALLROOM_GENRES = (
    "ChaChaCha",
    "Jive",
    "Quickstep",
    "Rumba-American",
    "Rumba-International",
    "Rumba-Misc",
    "Samba",
    "Tango",
    "VienneseWaltz",
    "Waltz",
)


@dataclasses.dataclass
class SongRecord:
    name: str
    vqt: np.ndarray  # (S, 96, T)
    pulse: np.ndarray  # (T,)
    down_pulse: np.ndarray  # (T,)
    beat_times: np.ndarray
    downbeat_times: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.vqt.shape[-1]


class BeatDataset:
    """An ordered collection of SongRecords with npz-directory persistence."""

    def __init__(self, records: Optional[List[SongRecord]] = None):
        self.records: List[SongRecord] = records or []

    def __len__(self):
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def __getitem__(self, i):
        return self.records[i]

    @property
    def names(self) -> List[str]:
        return [r.name for r in self.records]

    def add(self, rec: SongRecord):
        self.records.append(rec)

    def save(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        names = []
        for rec in self.records:
            safe = rec.name.replace("/", "__")
            np.savez_compressed(
                os.path.join(out_dir, safe + ".npz"),
                vqt=rec.vqt.astype(np.float32),
                pulse=rec.pulse.astype(np.float32),
                down_pulse=rec.down_pulse.astype(np.float32),
                beat_times=np.asarray(rec.beat_times, dtype=np.float64),
                downbeat_times=np.asarray(rec.downbeat_times, dtype=np.float64),
            )
            names.append(safe)
        with open(os.path.join(out_dir, "index.json"), "w") as fh:
            json.dump({"songs": names}, fh)

    @classmethod
    def load(cls, in_dir: str) -> "BeatDataset":
        with open(os.path.join(in_dir, "index.json")) as fh:
            index = json.load(fh)
        ds = cls()
        for safe in index["songs"]:
            with np.load(os.path.join(in_dir, safe + ".npz")) as z:
                ds.add(
                    SongRecord(
                        name=safe,
                        vqt=z["vqt"],
                        pulse=z["pulse"],
                        down_pulse=z["down_pulse"],
                        beat_times=z["beat_times"],
                        downbeat_times=z["downbeat_times"],
                    )
                )
        return ds


def build_record(
    name: str,
    signal: np.ndarray,
    ann: BeatAnnotation,
    *,
    separation: str = "none",
    stem_dir: Optional[str] = None,
    mode: str = "vqt",
    device: str = "cuda",
) -> SongRecord:
    """Signal + annotation -> SongRecord (optionally two-stream)."""
    if separation == "none":
        streams = [signal]
    else:
        from zeronotesamba_torch.data.separation import separate

        anchor, positive = separate(signal, SAMPLE_RATE, backend=separation, stem_dir=stem_dir, device=device)
        streams = [anchor, positive]
    vqts = np.stack([generate_xqt(s, SAMPLE_RATE, mode, device=device) for s in streams])
    n_frames = vqts.shape[-1]
    return SongRecord(
        name=name,
        vqt=vqts,
        pulse=beat_pulse(ann.beat_times, n_frames, FPS),
        down_pulse=beat_pulse(ann.downbeat_times, n_frames, FPS),
        beat_times=np.asarray(ann.beat_times, dtype=np.float64),
        downbeat_times=np.asarray(ann.downbeat_times, dtype=np.float64),
    )


def _iter_build(
    items: Iterable[Tuple[str, str, BeatAnnotation]],
    separation: str,
    device: str,
) -> BeatDataset:
    ds = BeatDataset()
    for name, wav_path, ann in items:
        sig, _ = audio_io.load_audio(wav_path, target_sr=SAMPLE_RATE)
        ds.add(build_record(name, sig, ann, separation=separation, device=device))
    return ds


def build_ballroom(root: str, separation: str = "none", device: str = "cuda") -> BeatDataset:
    """root contains BallroomData/<genre>/*.wav and
    BallroomAnnotations-master/*.beats (reference ballroom.py layout)."""
    ann_dir = os.path.join(root, "BallroomAnnotations-master")
    items = []
    for genre in BALLROOM_GENRES:
        gdir = os.path.join(root, "BallroomData", genre)
        if not os.path.isdir(gdir):
            continue
        for wav in sorted(os.listdir(gdir)):
            if not wav.endswith(".wav") or wav.startswith("._"):
                continue
            if any(dup in wav for dup in BALLROOM_DUPLICATES):
                continue
            beats_path = os.path.join(ann_dir, wav.replace(".wav", ".beats"))
            if not os.path.exists(beats_path):
                continue
            items.append((wav, os.path.join(gdir, wav), parse_ballroom_beats(beats_path)))
    return _iter_build(items, separation, device)


def build_gtzan(root: str, separation: str = "none", device: str = "cuda") -> BeatDataset:
    """root contains audio/*.wav (or genre subdirs) and jams/*.jams."""
    jams_dir = os.path.join(root, "jams")
    wav_paths: Dict[str, str] = {}
    for dirpath, _, files in os.walk(root):
        if os.path.abspath(dirpath).startswith(os.path.abspath(jams_dir)):
            continue
        for f in files:
            if f.endswith(".wav") and not f.startswith("._"):
                wav_paths[f] = os.path.join(dirpath, f)
    items = []
    for wav, path in sorted(wav_paths.items()):
        jams_path = os.path.join(jams_dir, wav + ".jams")
        if not os.path.exists(jams_path):
            continue
        items.append((wav, path, parse_jams_beats(jams_path)))
    return _iter_build(items, separation, device)


def build_hainsworth(root: str, separation: str = "none", device: str = "cuda") -> BeatDataset:
    """root contains wavs/*.wav and data.txt (reference hainsworth.py layout)."""
    master = os.path.join(root, "data.txt")
    entries = parse_hainsworth_master(master)
    items = []
    for e in entries:
        wav_path = os.path.join(root, "wavs", e.wav_name)
        if not os.path.exists(wav_path):
            continue
        items.append((e.wav_name, wav_path, BeatAnnotation(e.beat_times, e.downbeat_times)))
    return _iter_build(items, separation, device)


def build_smc(root: str, separation: str = "none", device: str = "cuda") -> BeatDataset:
    """root contains SMC_MIREX_Audio/*.wav + SMC_MIREX_Annotations*/*.txt."""
    audio_dir = os.path.join(root, "SMC_MIREX_Audio")
    ann_dirs = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("SMC_MIREX_Annotations")]
    ann_files: Dict[str, str] = {}
    for ad in ann_dirs:
        for f in os.listdir(ad):
            if f.endswith(".txt"):
                key = f.split(".")[0].split("_")[-1] if "_" in f else f[:-4]
                ann_files[key] = os.path.join(ad, f)
    items = []
    for wav in sorted(os.listdir(audio_dir)):
        if not wav.endswith(".wav"):
            continue
        key = wav[:-4].split("_")[-1]
        if key not in ann_files:
            continue
        items.append((wav, os.path.join(audio_dir, wav), parse_smc_beats(ann_files[key])))
    return _iter_build(items, separation, device)


BUILDERS: Dict[str, Callable[..., BeatDataset]] = {
    "ballroom": build_ballroom,
    "gtzan": build_gtzan,
    "hainsworth": build_hainsworth,
    "smc": build_smc,
}


def build_synthetic(
    n_songs: int = 16,
    duration_s: float = 12.0,
    *,
    bpm_range: Tuple[float, float] = (70, 180),
    two_stream: bool = True,
    seed: int = 0,
    device: str = "cuda",
) -> BeatDataset:
    """Synthetic click-track dataset with exact annotations (tests/demos)."""
    from zeronotesamba_torch.data.synthetic import percussive_pair

    rng = np.random.default_rng(seed)
    ds = BeatDataset()
    for i in range(n_songs):
        bpm = float(rng.uniform(*bpm_range))
        anchor, positive, beats = percussive_pair(duration_s, bpm, seed=seed * 1000 + i)
        ann = BeatAnnotation(list(beats))
        if two_stream:
            streams = [anchor, positive]
        else:
            streams = [anchor + positive]
        vqts = np.stack([generate_xqt(s, SAMPLE_RATE, "vqt", device=device) for s in streams])
        ds.add(
            SongRecord(
                name=f"synth_{i:03d}_bpm{bpm:.0f}",
                vqt=vqts,
                pulse=beat_pulse(ann.beat_times, vqts.shape[-1], FPS),
                down_pulse=np.zeros(vqts.shape[-1], dtype=np.float32),
                beat_times=np.asarray(ann.beat_times),
                downbeat_times=np.zeros(0),
            )
        )
    return ds
