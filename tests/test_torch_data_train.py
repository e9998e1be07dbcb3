"""The port's data layer against the JAX package's: pulses, synthetic pairs,
annotation parsers, the ETL, the npz cache, the staged buckets and the beat
metrics. Same seeded inputs through both packages.

Tolerances: pulses, synthetic signals, parsers, cache contents, buckets and
plans exact; metrics 1e-12; the ETL's log-VQT 5e-4, except near-empty cells
(log |X| <= -7), which sit at float32 rounding level and are held at 1e-2
(tests/test_torch_infer.py::test_low_cells_sit_at_float32_rounding).
"""

import json
import os

import numpy as np
import pytest
import torch

from zeronotesamba_tpu.data import annotations as jann
from zeronotesamba_tpu.data import datasets as jds
from zeronotesamba_tpu.data.pulse import beat_pulse as j_beat_pulse
from zeronotesamba_tpu.data.synthetic import click_track
from zeronotesamba_tpu.data.synthetic import percussive_pair as j_percussive_pair
from zeronotesamba_tpu.metrics.beat import evaluate_beats as j_evaluate_beats
from zeronotesamba_tpu.train.supervised import StagedDataset as JStaged
from zeronotesamba_torch.data import annotations as ann
from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data import datasets as ds_mod
from zeronotesamba_torch.data.pulse import beat_pulse
from zeronotesamba_torch.data.synthetic import percussive_pair
from zeronotesamba_torch.metrics.beat import evaluate_beats
from zeronotesamba_torch.train.supervised import PAD_VALUE, StagedDataset

torch.set_num_threads(2)

VQT_ATOL = 5e-4
NEAR_EMPTY_ATOL = 1e-2
LOG_FLOOR = -7.0
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("n_frames", [2, 3, 50, 751])
def test_beat_pulse_equals_jax(n_frames):
    times = np.random.default_rng(n_frames).uniform(-1.0, n_frames / 62.5 + 1.0, size=20)
    np.testing.assert_array_equal(beat_pulse(times, n_frames), j_beat_pulse(times, n_frames))
    np.testing.assert_array_equal(beat_pulse([], n_frames), j_beat_pulse([], n_frames))


@pytest.mark.parametrize("kw", [
    dict(duration_s=4.0, bpm=120.0, seed=0),
    dict(duration_s=3.0, bpm=97.3, seed=5, harmonics=4, click_freq=900.0, burst=0.3),
    dict(duration_s=5.0, bpm=150.0, seed=2, jitter_s=0.01, drift=0.05, amp_sd=0.2, drop_p=0.3,
         offbeat=0.5, offbeat_swing=0.1, offbeat_accent=1.5, harm_offbeat=0.4, bleed=0.1),
], ids=["clean", "harmonic_burst", "hard"])
def test_percussive_pair_bit_equal(kw):
    for got, ref in zip(percussive_pair(**kw), j_percussive_pair(**kw)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _same_annotation(a, b):
    assert a.beat_times == b.beat_times and a.downbeat_times == b.downbeat_times


def test_parsers_equal_jax(tmp_path):
    beats = tmp_path / "a.beats"
    beats.write_text("0.50 1\n1.00 2\n\n1.50 3\n2.00 4\n2.50 1.0\n")
    _same_annotation(ann.parse_ballroom_beats(str(beats)), jann.parse_ballroom_beats(str(beats)))

    doc = {"annotations": [
        {"namespace": "beat", "sandbox": {"annotation_type": "beat"},
         "data": [{"time": 1.0, "value": 2}, {"time": 0.5, "value": 1}, [1.5, 3]]},
        {"namespace": "beat", "sandbox": {"annotation_type": "downbeat"}, "data": {"time": [0.5, 2.5]}},
        {"namespace": "tempo", "data": [{"time": 9.0}]},
    ]}
    jams = tmp_path / "b.jams"
    jams.write_text(json.dumps(doc))
    _same_annotation(ann.parse_jams_beats(str(jams)), jann.parse_jams_beats(str(jams)))

    smc = tmp_path / "s.txt"
    smc.write_text("1.5, 0.5\n1.0\n\n")
    _same_annotation(ann.parse_smc_beats(str(smc)), jann.parse_smc_beats(str(smc)))

    fields = [["song1.wav"] + ["x"] * 8 + ["44100 88200 132300", "1 3"],
              ["song2.wav"] + ["x"] * 8 + ["22050 66150"],
              ["song3.wav"] + ["x"] * 8 + ["44100", "bad"],
              ["too", "short"]]
    master = tmp_path / "data.txt"
    master.write_text("\n" * 13 + "".join("<sep>".join(f) + "\n" for f in fields))
    got, ref = ann.parse_hainsworth_master(str(master)), jann.parse_hainsworth_master(str(master))
    assert [(e.wav_name, e.beat_times, e.downbeat_times) for e in got] == \
        [(e.wav_name, e.beat_times, e.downbeat_times) for e in ref]


def _assert_vqt_close(got, ref):
    low = ref <= LOG_FLOOR
    np.testing.assert_allclose(got[~low], ref[~low], atol=VQT_ATOL)
    np.testing.assert_allclose(got[low], ref[low], atol=NEAR_EMPTY_ATOL)


def _assert_records_match(got, ref, exact_vqt=False):
    assert got.names == ref.names
    for g, r in zip(got, ref):
        assert g.vqt.shape == r.vqt.shape and g.vqt.dtype == np.float32
        if exact_vqt:
            np.testing.assert_array_equal(g.vqt, r.vqt)
        else:
            _assert_vqt_close(g.vqt, r.vqt)
        for f in ("pulse", "down_pulse", "beat_times", "downbeat_times"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f), err_msg=f)


@pytest.fixture(scope="module")
def synth():
    """build_synthetic(n_songs=2, duration_s=4) from both packages."""
    return (ds_mod.build_synthetic(n_songs=2, duration_s=4.0, seed=1, device="cpu"),
            jds.build_synthetic(n_songs=2, duration_s=4.0, seed=1))


def test_build_synthetic_matches_jax(synth):
    got, ref = synth
    assert len(got) == 2 and got[0].vqt.shape == (2, 96, 251)
    _assert_records_match(got, ref)


def test_build_synthetic_one_stream(synth):
    one = ds_mod.build_synthetic(n_songs=1, duration_s=4.0, seed=1, two_stream=False, device="cpu")
    ref = jds.build_synthetic(n_songs=1, duration_s=4.0, seed=1, two_stream=False)
    assert one[0].vqt.shape == (1, 96, 251)
    _assert_records_match(one, ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_cache_loads_in_the_other_package(synth, tmp_path, writer):
    got, ref = synth
    out = str(tmp_path / "cache")
    if writer == "jax":
        ref.save(out)
        _assert_records_match(ds_mod.BeatDataset.load(out), ref, exact_vqt=True)
    else:
        got.save(out)
        _assert_records_match(jds.BeatDataset.load(out), got, exact_vqt=True)


def test_builders_on_dataset_trees(tmp_path):
    """build_ballroom (no separation) and build_hainsworth (HPSS) on
    miniature trees: the same records as the JAX builders'."""
    sig, beats = click_track(4.0, 120.0, seed=2)
    bdir, adir = tmp_path / "b" / "BallroomData" / "Jive", tmp_path / "b" / "BallroomAnnotations-master"
    os.makedirs(bdir)
    os.makedirs(adir)
    for name in ("Media-1", "Media-103402"):  # the second is a known duplicate
        audio_io.write_wav(str(bdir / f"{name}.wav"), sig, 16000)
        (adir / f"{name}.beats").write_text("".join(f"{t:.3f} {i % 4 + 1}\n" for i, t in enumerate(beats)))
    got = ds_mod.build_ballroom(str(tmp_path / "b"), device="cpu")
    assert got.names == ["Media-1.wav"]
    _assert_records_match(got, jds.build_ballroom(str(tmp_path / "b")))

    hroot = tmp_path / "h"
    os.makedirs(hroot / "wavs")
    audio_io.write_wav(str(hroot / "wavs" / "song1.wav"), sig, 16000)
    samples = " ".join(str(int(t * 44100)) for t in beats)
    (hroot / "data.txt").write_text("\n" * 13 + "<sep>".join(["song1.wav"] + ["x"] * 8 + [samples, "1 5"]) + "\n")
    got = ds_mod.build_hainsworth(str(hroot), separation="hpss", device="cpu")
    assert got[0].vqt.shape[0] == 2 and got[0].down_pulse.sum() > 0
    _assert_records_match(got, jds.build_hainsworth(str(hroot), separation="hpss"))


@pytest.fixture(scope="module")
def ragged_records():
    """Songs of several lengths (three buckets at 64 frames), with downbeats."""
    rng = np.random.default_rng(7)
    recs = []
    for i, t in enumerate([100, 130, 64, 200, 120, 65]):
        beats = np.sort(rng.uniform(0.1, t / 62.5, size=5))
        downs = beats[::2]
        recs.append(dict(name=f"song{i}", vqt=rng.standard_normal((2, 96, t)).astype(np.float32),
                         pulse=j_beat_pulse(beats, t), down_pulse=j_beat_pulse(downs, t),
                         beat_times=beats, downbeat_times=downs))
    return recs


@pytest.mark.parametrize("target", ["beat", "downbeat"])
def test_staged_dataset_equals_jax(ragged_records, target):
    ours = StagedDataset([ds_mod.SongRecord(**r) for r in ragged_records], 64, target, device="cpu")
    ref = JStaged([jds.SongRecord(**r) for r in ragged_records], 64, target)
    assert list(ours.buckets) == list(ref.buckets) == [64, 128, 192, 256]
    assert ours.location == ref.location
    for t, b in ours.buckets.items():
        rb = ref.buckets[t]
        assert b.vqt.device.type == "cpu" and b.vqt.dtype == torch.float32
        for f in ("vqt", "pulse", "mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(rb, f)), err_msg=f)
        assert b.names == rb.names and b.n_frames == rb.n_frames
        for x, y in zip(b.beat_times, rb.beat_times):
            np.testing.assert_array_equal(x, y)
    assert ours.buckets[192].vqt[0, 0, 0, -1].item() == np.float32(PAD_VALUE)
    names = [r["name"] for r in ragged_records]
    assert [(t, r.tolist()) for t, r in ours.plan(names, 2)] == [(t, r.tolist()) for t, r in ref.plan(names, 2)]
    for seed in (0, 1):
        got = ours.plan(names[1:], 2, shuffle_rng=np.random.default_rng(seed))
        want = ref.plan(names[1:], 2, shuffle_rng=np.random.default_rng(seed))
        assert [(t, r.tolist()) for t, r in got] == [(t, r.tolist()) for t, r in want]


def test_staged_dataset_rejects_unknown_target(ragged_records):
    with pytest.raises(ValueError):
        StagedDataset([ds_mod.SongRecord(**ragged_records[0])], 64, "tempo", device="cpu")


def test_evaluate_beats_on_golden_fixture():
    with open(os.path.join(FIXTURES, "metrics_golden.json")) as fh:
        cases = json.load(fh)
    for case in cases:
        ref, est = np.asarray(case["ref"]), np.asarray(case["est"])
        np.testing.assert_allclose(evaluate_beats(ref, est), j_evaluate_beats(ref, est), rtol=0, atol=1e-12,
                                   err_msg=case["name"])
        if case["kind"] == "frozen_eval":
            np.testing.assert_allclose(evaluate_beats(ref, est), case["expected"], atol=1e-12, err_msg=case["name"])


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_beats_on_random_sets(seed):
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.uniform(0.4, 0.6, size=60))
    keep = rng.random(60) < 0.8  # missed beats, jitter and spurious beats
    est = np.sort(np.concatenate([ref[keep] + rng.normal(0, 0.03, size=keep.sum()), rng.uniform(0, 30, size=5)]))
    for trim in (True, False):
        got = evaluate_beats(ref, est, trim=trim)
        assert len(got) == 6
        np.testing.assert_allclose(got, j_evaluate_beats(ref, est, trim=trim), rtol=0, atol=1e-12)
