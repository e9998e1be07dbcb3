"""Beat-annotation parsers for the four reference datasets.

The port's copy of zeronotesamba_tpu/data/annotations.py, unchanged.

Formats (capability parity with the reference's ETL scripts):

- Ballroom ``.beats``: lines "<time> <beat-position>"; position 1 = downbeat
  (reference ballroom.py:190-221).
- GTZAN JAMS: JSON files with beat (+ optional downbeat-as-position)
  namespaces (reference gtzan.py:143-181). Parsed with stdlib json — the jams
  package is not needed.
- Hainsworth ``data.txt``: "<sep>"-delimited master file; beat sample indices
  at 44.1 kHz (reference hainsworth.py:41-63,172). The reference's downbeat
  substring-membership bug (hainsworth.py:184) is documented and NOT
  replicated: downbeats are matched by index, not by string containment.
- SMC ``.txt``: one beat time per line (no downbeats; reference smc_mirex.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List


@dataclass
class BeatAnnotation:
    beat_times: List[float]
    downbeat_times: List[float] = field(default_factory=list)


def parse_ballroom_beats(path: str) -> BeatAnnotation:
    beats, downs = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            t = float(parts[0])
            beats.append(t)
            if len(parts) > 1 and int(float(parts[1])) == 1:
                downs.append(t)
    return BeatAnnotation(beats, downs)


def _obs_time(obs) -> float:
    if isinstance(obs, dict):
        return float(obs["time"])
    return float(obs[0])  # list-form JAMS observation


def parse_jams_beats(path: str) -> BeatAnnotation:
    """GTZAN-Rhythm style JAMS: 'beat' namespaces with
    sandbox.annotation_type 'beat' / 'downbeat' (reference gtzan.py:143-181)."""
    with open(path) as fh:
        doc = json.load(fh)
    beats, downs = [], []
    for ann in doc.get("annotations", []):
        namespace = ann.get("namespace", "")
        if not namespace.startswith("beat"):
            continue
        ann_type = ann.get("sandbox", {}).get("annotation_type", "beat")
        data = ann.get("data", [])
        if isinstance(data, dict):  # dense JAMS form
            data = [{"time": t} for t in data.get("time", [])]
        for obs in data:
            t = _obs_time(obs)
            if ann_type == "downbeat":
                downs.append(t)
            elif ann_type == "beat":
                beats.append(t)
    return BeatAnnotation(sorted(set(beats)), sorted(set(downs)))


def parse_smc_beats(path: str) -> BeatAnnotation:
    beats = []
    with open(path) as fh:
        for line in fh:
            line = line.strip().replace(",", " ")
            if not line:
                continue
            for tok in line.split():
                beats.append(float(tok))
    return BeatAnnotation(sorted(beats))


@dataclass
class HainsworthEntry:
    wav_name: str
    beat_times: List[float]
    downbeat_times: List[float]


def parse_hainsworth_master(path: str, header_lines: int = 13, sep: str = "<sep>") -> List[HainsworthEntry]:
    """Parse Hainsworth's data.txt master file.

    Field layout follows the reference (hainsworth.py:41-63): field 0 is the
    wav name, field 9 the space-separated beat sample indices (at 44.1 kHz),
    field 10 the downbeat *indices into the beat list* (1-based). Downbeats
    are resolved by index — the reference's substring test (hainsworth.py:184)
    misclassifies and is intentionally not replicated.
    """
    entries = []
    with open(path, errors="replace") as fh:
        lines = fh.readlines()[header_lines:]
    for line in lines:
        line = line.strip()
        if not line:
            continue
        fields = [f.strip() for f in line.split(sep)]
        if len(fields) < 10:
            continue
        wav = fields[0]
        beat_samples = [float(x) for x in fields[9].split()]
        beats = [s / 44100.0 for s in beat_samples]
        downs: List[float] = []
        if len(fields) > 10 and fields[10]:
            try:
                idxs = [int(float(x)) for x in fields[10].split()]
                downs = [beats[i - 1] for i in idxs if 1 <= i <= len(beats)]
            except (ValueError, IndexError):
                downs = []
        entries.append(HainsworthEntry(wav, beats, downs))
    return entries
