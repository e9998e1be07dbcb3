"""Beat This! in the port against the plain reference (benchmark/reference/beat_this.py)
on seeded random weights, on the CPU: the model at a small size, the
parameter count at the published widths, the log-mel, the chunks, the peak
picker, ``track_signal(model="beat_this")`` end to end, the weights loader
and the CLI. The reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import beat_this as ref
from zeronotesamba_torch import cli
from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.decode.peaks import decode_peaks
from zeronotesamba_torch.infer import TRACKERS, BeatThisResult, BeatThisTracker, BeatTracker
from zeronotesamba_torch.models import beat_this
from zeronotesamba_torch.models.weights import load_beat_this_file, load_beat_this_state_dict
from zeronotesamba_torch.ops import mel
from zeronotesamba_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "benchmark", "configs", "beat_this.json")))
SMALL = dict(CONFIG, n_mels=32, transformer_dim=64, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(weights: dict) -> beat_this.BeatThis:
    sd = load_beat_this_state_dict(weights)
    model = beat_this.BeatThis(beat_this.BeatThisConfig.from_state_dict(sd))
    model.load_state_dict(sd)
    return model.eval()


def _song(seconds: float, bpm: float = 120.0, seed: int = 3) -> np.ndarray:
    from benchmark.reference.songs import click_track

    sig, _ = click_track(seconds, bpm, mel.SAMPLE_RATE, click_freq=700.0, harmonics=3, burst=0.2, amp_sd=0.1,
                         offbeat=0.3, seed=seed)
    return sig


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("frames", [64, 200])
@pytest.mark.parametrize("dim", [32, 64])
def test_model_matches_reference(dim, frames):
    cfg = dict(SMALL, transformer_dim=dim)
    w = ref.make_weights(cfg, 2**40 + dim, "cpu")
    x = torch.randn(2, frames, cfg["n_mels"], generator=torch.Generator().manual_seed(frames)) * 2.0 + 1.0
    with torch.no_grad():
        beat, down = _model(w)(x)
        want_beat, want_down = ref.forward(w, x, cfg)
    # float32 rounding through 2 layers and 3 blocks, in other orders of summation.
    assert _rel_gap(beat, want_beat) < 2e-5 and _rel_gap(down, want_down) < 2e-5


def test_parameter_count_at_published_widths():
    model = beat_this.BeatThis()
    assert sum(p.numel() for p in model.parameters()) == CONFIG["parameters"] == ref.param_count(CONFIG) == 20_251_696
    assert set(model.state_dict()) - {k for k in model.state_dict() if k.endswith("num_batches_tracked")} == \
        {k for k, _, _ in ref.shapes(CONFIG)}
    assert beat_this.BeatThisConfig.from_state_dict(model.state_dict()) == beat_this.BeatThisConfig()


@pytest.mark.parametrize("seconds", [3.0, 12.345])
def test_log_mel_matches_float64(seconds):
    sig = _song(seconds)
    got = mel.log_mel(torch.from_numpy(sig)).numpy()
    want = ref.log_mel(sig, CONFIG)
    assert got.shape == want.shape == (1 + len(sig) // 441, 128)
    # float32 STFT and filterbank against float64; values run up to about 7.
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("frames", [1, 500, 1488, 1489, 1490, 1494, 1495, 3100, 6001, 15001])
def test_chunk_starts_and_shapes(frames):
    starts = beat_this.chunk_starts(frames)
    assert starts == ref.chunk_starts(frames, CONFIG)
    chunks, _ = beat_this.split_chunks(torch.arange(frames, dtype=torch.float32)[:, None] + 1.0)
    want, _ = ref.split_piece(torch.arange(frames, dtype=torch.float32)[:, None] + 1.0, CONFIG)
    assert len(chunks) == len(want) and all(torch.equal(a, b) for a, b in zip(chunks, want))
    # Every frame of the piece comes back, once.
    got = beat_this.aggregate_chunks(chunks.numpy(), starts, frames)
    assert np.array_equal(got[:, 0], np.arange(frames, dtype=np.float32) + 1.0)


@pytest.mark.parametrize("frames", [3100, 1488, 500])
def test_chunked_batch_matches_reference_chunk_by_chunk(frames):
    cfg = dict(SMALL, n_mels=128)
    w = ref.make_weights(cfg, 2**41 + frames, "cpu")
    spec = torch.rand(frames, 128, generator=torch.Generator().manual_seed(frames)) * 6.0
    chunks, starts = beat_this.split_chunks(spec)
    assert len(starts) == (3 if frames == 3100 else 1)
    with torch.no_grad():
        got = beat_this.aggregate_chunks(torch.stack(_model(w)(chunks), -1).numpy(), starts, frames)
    want_beat, want_down = ref.predict(w, spec.numpy(), cfg, "cpu")
    assert _rel_gap(got[:, 0], want_beat) < 2e-5 and _rel_gap(got[:, 1], want_down) < 2e-5


def _logits(frames: int, peaks: dict) -> np.ndarray:
    x = np.full(frames, -1.0, np.float32)
    for f, v in peaks.items():
        x[f] = v
    return x


PEAK_CASES = {
    # A plateau of three: the first two merge to their mean, the third is past it by 1.5.
    "plateau": ({20: 2.0, 21: 2.0, 22: 2.0}, {}, [20.5, 22.0], []),
    # Two equal neighbours merge; peaks 4 apart both stand; a lower peak 3 from a higher one is no peak.
    "adjacent": ({30: 2.0, 31: 2.0, 40: 1.0, 44: 1.0, 50: 1.0, 53: 0.9}, {}, [30.5, 40.0, 44.0, 50.0], []),
    # Downbeats between beats move to the nearest beat and merge there.
    "downbeat_between": ({100: 1.0, 110: 1.0}, {104: 1.0, 107: 1.0, 111: 0.5}, [100.0, 110.0], [100.0, 110.0]),
    # Nothing above 0 (a peak at exactly 0 is none).
    "none": ({10: -0.5, 20: 0.0}, {30: 0.0}, [], []),
}


@pytest.mark.parametrize("case", sorted(PEAK_CASES))
def test_peak_picker(case):
    beats, downs, want_beats, want_downs = PEAK_CASES[case]
    logits = np.stack([_logits(160, beats), _logits(160, downs)])
    got_beats, got_downs = decode_peaks(logits, fps=50.0)
    assert np.array_equal(got_beats, np.asarray(want_beats) / 50.0)
    assert np.array_equal(got_downs, np.asarray(want_downs) / 50.0)
    ref_beats, ref_downs = ref.postprocess(logits[0], logits[1], 50.0)
    assert np.array_equal(got_beats, ref_beats) and np.array_equal(got_downs, ref_downs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peak_picker_on_noise_matches_reference(seed):
    # Thousands of peaks, plateaus from rounding to a coarse grid, downbeats snapped between them.
    rng = np.random.default_rng(seed)
    logits = (np.round(rng.standard_normal((2, 5000)) * 4.0) / 8.0 + 0.1).astype(np.float32)
    got_beats, got_downs = decode_peaks(logits, fps=50.0)
    ref_beats, ref_downs = ref.postprocess(logits[0], logits[1], 50.0)
    assert len(got_beats) > 500 and len(got_downs) > 100
    assert np.array_equal(got_beats, ref_beats) and np.array_equal(got_downs, ref_downs)


def test_track_signal_end_to_end():
    sig = _song(10.0)
    w = ref.make_weights(CONFIG, 2**42 + 5, "cpu")
    ref.bias_head(w, [ref.log_mel(sig, CONFIG)], CONFIG, "cpu")
    tracker = BeatTracker(w, model="beat_this", device="cpu")
    assert type(tracker) is BeatThisTracker
    before = profiling.totals()
    res = tracker.track_signal(sig, mel.SAMPLE_RATE, separation="none", decoder="peaks")
    after = profiling.totals()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in
            ("beat_this.chunks", "attn_launch.freq", "attn_launch.time", "attn_launch.global")} == \
        {"beat_this.chunks": 1, "attn_launch.freq": 3, "attn_launch.time": 3, "attn_launch.global": 6}
    assert isinstance(res, BeatThisResult) and res.mel.shape == (501, 128)
    assert np.abs(res.mel - ref.log_mel(sig, CONFIG)).max() < 1e-4
    want_beat, want_down = ref.predict(w, res.mel, CONFIG, "cpu")
    # float32 rounding through the whole model at its published widths.
    assert _rel_gap(res.beat_logits, want_beat) < 5e-5 and _rel_gap(res.downbeat_logits, want_down) < 5e-5
    want_beats, want_downs = ref.postprocess(res.beat_logits, res.downbeat_logits, 50.0)
    # The head's biases leave 20 beat and 5 downbeat maxima above 0 in the song's 10.02 s (2 and 0.5 a
    # second); neighbours merge, downbeats snap to beats.
    assert 15 <= len(want_beats) <= 20 and 1 <= len(want_downs) <= 5
    assert np.array_equal(res.beat_times, want_beats)
    assert np.array_equal(res.downbeat_times, want_downs)


def test_unsupported_model_and_paths_raise():
    with pytest.raises(ValueError, match="unknown model"):
        BeatTracker(model="bock_tcn", device="cpu")
    cfg = dict(CONFIG, transformer_dim=64, n_layers=1)
    tracker = BeatTracker(ref.make_weights(cfg, 1, "cpu"), model="beat_this", device="cpu")
    sig = _song(1.0)
    with pytest.raises(ValueError, match="separation"):
        tracker.track_signal(sig, mel.SAMPLE_RATE, separation="hpss", decoder="peaks")
    with pytest.raises(ValueError, match="peaks"):
        tracker.track_signal(sig, mel.SAMPLE_RATE, separation="none", decoder="dbn")


def _checkpoint(cfg: dict, seed: int) -> tuple:
    """The reference's weights, and the same as a published checkpoint holds
    them: under ``state_dict``, keys prefixed ``model.``, each attention with
    its rotary frequencies."""
    w = ref.make_weights(cfg, seed, "cpu")
    sd = {f"model.{k}": v for k, v in w.items()}
    freqs = 1.0 / 10000.0 ** (torch.arange(0, 32, 2).float() / 32)
    for k in w:
        if k.endswith("to_qkv.weight"):
            sd["model." + k.replace("to_qkv.weight", "rotary_embed.freqs")] = freqs
    return w, {"state_dict": sd, "epoch": 3}


def test_load_source_state_dict():
    cfg = dict(CONFIG, transformer_dim=64, n_layers=1)
    w, ckpt = _checkpoint(cfg, 7)
    sd = load_beat_this_state_dict(ckpt)
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(w)
    assert all(torch.equal(sd[k], w[k]) for k in w)
    bad = {k: (v * 2 if k.endswith("freqs") else v) for k, v in ckpt["state_dict"].items()}
    with pytest.raises(ValueError, match="rotary"):
        load_beat_this_state_dict(bad)
    with pytest.raises(ValueError, match="ckpt"):
        load_beat_this_file("beat_this.pth")


@pytest.mark.parametrize("command", ["infer", "track-dir"])
def test_cli_model_flag(tmp_path, capsys, command):
    cfg = dict(CONFIG, transformer_dim=64, n_layers=1)
    w, ckpt = _checkpoint(cfg, 11)
    path = str(tmp_path / "beat_this.ckpt")
    torch.save(ckpt, path)
    sig = _song(4.0, bpm=150.0)
    wav = tmp_path / "songs" / "a.wav"
    wav.parent.mkdir()
    audio_io.write_wav(str(wav), sig, mel.SAMPLE_RATE)
    out = str(tmp_path / "out.json")
    where = str(wav) if command == "infer" else str(wav.parent)
    cli.main([command, where, "--model", "beat_this", "--params", path, "--device", "cpu", "--out", out])
    got = json.load(open(out))
    res = BeatTracker(load_beat_this_file(path), model="beat_this", device="cpu").track_file(
        str(wav), separation="none", decoder="peaks")
    if command == "infer":
        assert got["n_frames"] == 1 + len(sig) // 441
        assert got["beat_times"] == res.beat_times.tolist() and got["downbeat_times"] == res.downbeat_times.tolist()
    else:
        assert got == {"a.wav": res.beat_times.tolist()}


def test_cli_defaults_follow_the_model():
    from zeronotesamba_torch.models.separator import SEPARATOR_NPZ

    parser = cli.build_parser()
    down = parser.parse_args(["infer", "x.wav", "--device", "cpu"])
    assert down.model == "down_cnn"
    tracker, kw = cli._tracker(down)
    assert type(tracker) is BeatTracker is TRACKERS["down_cnn"]
    assert kw == {"separation": "hpss", "decoder": "dbn", "sep_model": SEPARATOR_NPZ}
    beat = parser.parse_args(["track-dir", "d", "--out", "o.json", "--model", "beat_this", "--device", "cpu"])
    tracker, kw = cli._tracker(beat)
    assert type(tracker) is BeatThisTracker is TRACKERS["beat_this"]
    assert kw == {"separation": "none", "decoder": "peaks"}
    _, kw = cli._tracker(parser.parse_args(["infer", "x.wav", "--device", "cpu", "--decoder", "threshold"]))
    assert kw["decoder"] == "threshold" and kw["separation"] == "hpss"


def test_reference_is_plain():
    path = os.path.join(ROOT, "benchmark", "reference", "beat_this.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}
