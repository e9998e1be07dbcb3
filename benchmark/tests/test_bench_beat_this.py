"""The Beat This! cell at a tiny size on the CPU (the program's plain paths):
its run is correct, traced and untraced; each fault makes ``correct`` false;
its frozen counts match the reference's; a program without Beat This! fails
at set-up. On a card, the control fails at a small size.
On a CUDA card: python -m pytest benchmark/tests -q -m cuda"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import beat_this
from benchmark.run import measure
from benchmark.tests.conftest import ROOT

CELL = "beatthis-song-full"
# A song of two chunks (31 s: 1,551 frames), tracked first in any window, and one of one chunk; the
# model cut in width and depth.
TINY_TRAFFIC = {"lengths_s": [31.0, 1.0], "check_songs": 2, "trace_seconds": 1}
TINY_MODEL = {"transformer_dim": 64, "n_layers": 1}
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "beat_this.json").read_text())


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(traffic=TINY_TRAFFIC, model=TINY_MODEL):
    cell = harness.Cell(CELL)
    cell.traffic.update(traffic)
    cell.config = dict(cell.config, **model)
    return cell


def _run(seed: int = 2**40 + 31) -> dict:
    return measure(tiny_cell(), seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_driver_runs_and_is_correct(trace):
    # Traced: two short songs and a window of 4 s, so that the program's spans have two anchors.
    cell = tiny_cell(dict(TINY_TRAFFIC, lengths_s=[1.0, 1.0], trace_seconds=4) if trace else TINY_TRAFFIC)
    result = measure(cell, 2**40 + 17, 4.0 if trace else 0.5, bool(trace), "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits) == {"mel_gap", "logit_gap", "beat_gap"}
    wanted = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    if trace:
        # No device here: the readers of device events find nothing and are left out.
        assert set(result["metrics"]) <= wanted
        # Three frontend blocks (over frequency and over time) and the layers: one call each a song.
        assert result["metrics"]["attn_launches_per_song.beatthis"]["value"] == 6 + cell.config["n_layers"]
        # The entry layer's counters read (no copies on the CPU: 0 a song).
        assert result["metrics"]["h2d_bytes_per_song.beatthis"]["value"] == 0
        assert result["metrics"]["syncs_per_song.beatthis"]["value"] == 0
    else:
        assert set(result["metrics"]) == wanted == {"song_latency_p95_ms", "audio_min_per_s", "setup_s"}


def _alter(monkeypatch, fault: str):
    from zeronotesamba_torch import infer
    from zeronotesamba_torch.models import beat_this as program

    if fault == "chunk":
        split = program.split_chunks

        def dropped(spec, *a, **kw):
            chunks, starts = split(spec, *a, **kw)
            return (chunks[:-1], starts[:-1]) if len(starts) > 1 else (chunks, starts)

        monkeypatch.setattr(program, "split_chunks", dropped)
        return
    track = infer.BeatThisTracker.track_signal

    def altered(self, *a, **kw):
        res = track(self, *a, **kw)
        if fault == "beat":
            res.beat_times = res.beat_times[1:]
        elif fault == "logit":
            res.beat_logits = res.beat_logits.copy()
            res.beat_logits[len(res.beat_logits) // 2] += 0.01 * np.abs(res.beat_logits).max()
        return res

    monkeypatch.setattr(infer.BeatThisTracker, "track_signal", altered)


@pytest.mark.parametrize("fault,check", [("logit", "logit_gap"), ("beat", "beat_gap"), ("chunk", "logit_gap")])
def test_fault_fails(monkeypatch, fault, check):
    _alter(monkeypatch, fault)
    result = _run()
    assert not result["correct"]
    assert result["checks"][check]["value"] > result["checks"][check]["limit"]


def test_facts_count_the_reference_flops():
    # 120 s: 6,001 frames, 5 chunks of 1,500; 9 s: 451 frames, one chunk of 463.
    from benchmark.drivers import song_full_closed_loop as driver

    assert driver.chunk_frames(6001, CONFIG) == [1500] * 5 and driver.chunk_frames(451, CONFIG) == [463]
    assert beat_this.forward_flops(CONFIG, 1500) == 134_710_272_000
    assert beat_this.attention_flops(CONFIG, 1500) == 55_640_064_000
    run = driver.Run.__new__(driver.Run)
    run.config = CONFIG
    run.songs = [(np.zeros(120 * 22050, np.float32), 120.0), (np.zeros(9 * 22050, np.float32), 9.0)]
    run.tracked = [0, 1, 0]
    facts = run.facts()
    assert facts["chunks"] == 11
    assert facts["flops"] == 10 * 134_710_272_000 + beat_this.forward_flops(CONFIG, 463)
    assert facts["attn_flops"] == 10 * 55_640_064_000 + beat_this.attention_flops(CONFIG, 463)


def test_mean_song_of_the_pool():
    # 16 lengths from 120 to 300 s: 7.625 chunks and 1.03 TFLOP a song on average.
    from benchmark.drivers import song_full_closed_loop as driver

    traffic = harness.Cell(CELL).traffic
    chunks = [len(driver.chunk_frames(1 + int(s * 22050) // 441, CONFIG)) for s in traffic["lengths_s"]]
    assert (min(chunks), max(chunks), sum(chunks) / len(chunks)) == (5, 11, 7.625)
    assert round(sum(chunks) * 134.710272 / len(chunks)) == 1027


def test_program_without_beat_this_fails_at_setup(monkeypatch):
    from zeronotesamba_torch import infer

    class OnlyDownCNN:  # a BeatTracker that takes no model, as before Beat This!
        def __init__(self, params=None, *, device="cuda"):
            raise AssertionError("not reached: the model argument is refused first")

    monkeypatch.setattr(infer, "BeatTracker", OnlyDownCNN)
    cell = tiny_cell()
    with pytest.raises(TypeError, match="model"):
        cell.driver.Run(cell.config, cell.traffic, 5, "cpu")


@pytest.mark.cuda
def test_program_passes_and_control_fails(card):
    from benchmark.calibrate import readings

    cell = tiny_cell({"lengths_s": [40.0, 31.0], "check_songs": 2}, {})
    for seed in (2**35 + 3, 11, 2**31 + 13):
        line = readings(cell, seed, 1.0, card)
        assert all(line["program"][k] <= lim for k, lim in cell.limits.items()), line
        assert line["control"]["mel_gap"] > cell.limits["mel_gap"], line
        assert line["control"]["logit_gap"] > cell.limits["logit_gap"], line
