"""Spleeter 4stems in the port (models/spleeter.py, ops/stft44.py, the
polyphase resampler, the ``spleeter`` separation backend) against the plain
reference (benchmark/reference/spleeter.py) on seeded weights, at a small
size on the CPU: T 64, F 128, filters 2 to 64, so that six halvings leave
whole maps."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import spleeter as ref
from benchmark.reference.songs import click_track
from zeronotesamba_torch.data.annotations import BeatAnnotation
from zeronotesamba_torch.data.datasets import build_record
from zeronotesamba_torch.data.separation import separate
from zeronotesamba_torch.models import spleeter
from zeronotesamba_torch.models.weights import load_spleeter_file, save_spleeter_file, spleeter_state_dict_from_source
from zeronotesamba_torch.ops import stft44
from zeronotesamba_torch.ops.resample import resample_device, resample_polyphase_device
from zeronotesamba_torch.ops.filterbank import XQTParams
from zeronotesamba_torch.ops.vqt import best_log_xqt, generate_xqt
from zeronotesamba_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "benchmark", "configs", "spleeter_4stems.json")))
SMALL = dict(CONFIG, conv_n_filters=[2, 4, 8, 16, 32, 64], T=64, F=128)
SEED = 2**35 + 9


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(SMALL, SEED, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    cfg = spleeter.SpleeterConfig(filters=tuple(SMALL["conv_n_filters"]), T=SMALL["T"], F=SMALL["F"])
    m = spleeter.Spleeter(cfg)
    m.load_state_dict(spleeter_state_dict_from_source(weights, cfg.instruments))
    return m.eval()


@pytest.fixture(scope="module")
def song():
    # 3 s at 44.1 kHz: 134 frames, 3 segments of 64.
    sig, beats = click_track(3.0, 120.0, 44100, harmonics=3, burst=0.2, offbeat=0.3, seed=4)
    return sig, beats


@pytest.mark.parametrize("n", [2, 8, 64, 128])
def test_same_padding_halves_and_its_adjoint_doubles(n):
    # TensorFlow's "same" at stride 2 pads 1 before and 2 after; the transposed conv is its adjoint, which
    # pins the side its crop takes.
    gen = torch.Generator().manual_seed(n)
    conv, deconv = torch.nn.Conv2d(3, 4, 5, stride=2, bias=False), torch.nn.ConvTranspose2d(4, 3, 5, stride=2,
                                                                                             padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        deconv.weight.copy_(conv.weight)
    conv, deconv = conv.double(), deconv.double()
    x = torch.randn(1, 3, n, 2 * n, generator=gen, dtype=torch.float64)
    y = torch.randn(1, 4, n // 2, n, generator=gen, dtype=torch.float64)
    down, up = spleeter.down(conv, x), spleeter.up(deconv, y)
    assert down.shape == y.shape and up.shape == x.shape
    assert torch.allclose((down * y).sum(), (x * up).sum(), rtol=1e-12)
    # The encoder's output k uses input rows 2k - 1 .. 2k + 3.
    ref_down = F.conv2d(F.pad(x, (1, 2, 1, 2)), conv.weight, stride=2)
    torch.testing.assert_close(down, ref_down, rtol=0, atol=0)


def test_unet_shapes_and_values_match_the_reference(model, weights):
    x = torch.rand(2, 2, SMALL["T"], SMALL["F"], generator=torch.Generator().manual_seed(1)) * 10
    with torch.no_grad():
        for i, net in enumerate(model.nets.values()):
            got = net(x)
            assert got.shape == x.shape
            torch.testing.assert_close(got, ref.unet(weights, x, i, SMALL), rtol=1e-5, atol=1e-5)


def test_masks_sum_to_one_below_f_and_zero_above(model):
    mag = torch.rand(3, 2, SMALL["T"], SMALL["F"], generator=torch.Generator().manual_seed(2)) * 5
    mag[2] = 0.0  # a padded segment: every net reads 0, every mask 1/4
    with torch.no_grad():
        masks = model.masks(mag)
        torch.testing.assert_close(masks.sum(0), torch.ones_like(mag), rtol=0, atol=1e-6)
        torch.testing.assert_close(masks[:, 2], torch.full_like(masks[:, 2], 0.25), rtol=0, atol=1e-7)
        both = model.stream_masks(masks, 150)
    assert both.shape == (2, 150, stft44.BINS)
    torch.testing.assert_close(both[:, :, :SMALL["F"]].sum(0), torch.ones(150, SMALL["F"]), rtol=0, atol=1e-6)
    assert not both[:, :, SMALL["F"]:].any()


@pytest.mark.parametrize("length", [44100, 44100 + 517, 30 * 44100])
def test_stft_then_istft_with_unit_masks_gives_the_signal_back(length):
    y = torch.randn(2, length, generator=torch.Generator().manual_seed(length))
    spec = stft44.stft(y)
    assert spec.shape == (2, stft44.n_frames(length), stft44.BINS)
    torch.testing.assert_close(stft44.istft(spec, length), y, rtol=0, atol=2e-6)
    # And it is the reference's STFT (the 4,096 leading zeros, the frame count).
    cfg = dict(CONFIG)
    torch.testing.assert_close(spec[0].to(torch.complex128), ref.stft(y[0].numpy(), cfg, "cpu")[0], rtol=0,
                               atol=2e-5 * float(spec.abs().max()))
    assert stft44.n_frames(30 * 44100) == 1296


@pytest.mark.parametrize("rates,length", [((44100, 16000), 3 * 44100 + 11), ((16000, 44100), 16000),
                                          ((22050, 16000), 5000)])
def test_polyphase_resample_is_the_zero_stuffed_one(rates, length):
    x = torch.randn(2, length, generator=torch.Generator().manual_seed(length))
    got = resample_polyphase_device(x, *rates)
    torch.testing.assert_close(got, resample_device(x, *rates), rtol=0, atol=2e-6)
    exact = ref.resample(x.double(), *rates)
    n = got.shape[-1]
    assert exact.shape[-1] - n in (0, 1)  # the zero-stuffed conv can end one output short of ceil(L p / q)
    torch.testing.assert_close(got.double(), exact[:, :n], rtol=0, atol=2e-6)


def test_separate_matches_the_reference_stage_by_stage(model, weights, song):
    sig = song[0]
    anchor, positive = separate(sig, 44100, backend="spleeter", model=model, device="cpu")
    last = model.last
    spec = ref.stft(sig, SMALL, "cpu")
    mag = ref.magnitude(spec, SMALL, torch.float64)
    assert last["magnitude"].shape == mag.shape == (3, 2, 64, 128)
    assert float((last["magnitude"].double() - mag).abs().max() / mag.max()) < 1e-6
    torch.testing.assert_close(last["masks"], ref.masks(weights, last["magnitude"], SMALL), rtol=0, atol=1e-6)
    streams = ref.streams(spec, last["masks"], len(sig), SMALL)
    got = torch.tensor(np.stack([anchor, positive]), dtype=torch.float64)
    assert got.shape == streams.shape == (2, 48000)
    assert float(((got - streams).abs().amax(-1) / streams.abs().amax(-1)).max()) < 5e-6


def _stage_gaps(model, weights, sig, anchor, positive) -> dict:
    """The separation's last call against the reference, stage by stage, as the cell's check reads them."""
    last = model.last
    spec = ref.stft(sig, SMALL, "cpu")
    mag = ref.magnitude(spec, SMALL, torch.float64)
    streams = ref.streams(spec, last["masks"].cpu(), len(sig), SMALL)
    got = torch.tensor(np.stack([anchor, positive]), dtype=torch.float64)
    assert last["magnitude"].shape == mag.shape and got.shape == streams.shape
    return {"spec_gap": float((last["magnitude"].cpu().double() - mag).abs().max() / mag.max()),
            "mask_gap": float((last["masks"].cpu() - ref.masks(weights, last["magnitude"].cpu(), SMALL)).abs().max()),
            "stream_gap": float(((got - streams).abs().amax(-1) / streams.abs().amax(-1)).max())}


@pytest.fixture(scope="module")
def long_song():
    return click_track(4.5, 97.0, 44100, harmonics=3, burst=0.2, offbeat=0.3, seed=6)[0]


@pytest.mark.parametrize("length,segments", [(22050, 1), (132300, 3), (192512, 3), (192513, 4)])
def test_separate_pads_to_the_segment_grid_and_keeps_the_song(model, weights, long_song, length, segments):
    # The stages run on the song zero-padded to S segments (192,512 samples fill 3 of 64 frames exactly, one
    # more starts a 4th); the padding changes none of the song's own masks or samples.
    sig = long_song[:length]
    assert model.segments(length) == segments
    anchor, positive = separate(sig, 44100, backend="spleeter", model=model, device="cpu")
    assert anchor.shape == positive.shape == (-(-length * 160 // 441),)
    gaps = _stage_gaps(model, weights, sig, anchor, positive)
    assert gaps["spec_gap"] < 1e-6 and gaps["mask_gap"] < 1e-6 and gaps["stream_gap"] < 5e-6, gaps
    assert not model._graphs  # on the CPU the stages run


@pytest.mark.cuda
def test_card_graphs_are_kept_per_segment_count_and_bounded(weights, long_song):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = spleeter.SpleeterConfig(filters=tuple(SMALL["conv_n_filters"]), T=SMALL["T"], F=SMALL["F"])
    with torch.device("cuda"):
        m = spleeter.Spleeter(cfg)
    m.load_state_dict(spleeter_state_dict_from_source(weights, cfg.instruments))
    m.eval()
    limits = json.load(open(os.path.join(ROOT, "benchmark", "limits", "spleeter-etl-30s.json")))
    # Two lengths of 3 segments: the second replays the first's graphs with its own length.
    for length in (132300, 150001, 192512):
        sig = long_song[:length]
        anchor, positive = m.separate(sig, 44100)
        gaps = _stage_gaps(m, weights, sig, anchor, positive)
        assert all(gaps[k] <= limits[k] for k in gaps), (length, gaps)
        assert list(m._graphs) == [3]
    # Every other segment count captures its own, and only the last GRAPHS_KEPT are kept.
    for s in range(1, spleeter.GRAPHS_KEPT + 3):
        m.separate(np.resize(long_song, s * SMALL["T"] * stft44.HOP - stft44.FRAME), 44100)
        assert len(m._graphs) <= spleeter.GRAPHS_KEPT and next(reversed(m._graphs)) == s
    assert list(m._graphs) == list(range(3, spleeter.GRAPHS_KEPT + 3))


def test_build_record_and_track_signal_end_to_end(model, song, tmp_path):
    from zeronotesamba_torch.infer import BeatTracker

    sig, beats = song
    anchor, positive = separate(sig, 44100, backend="spleeter", model=model, device="cpu")
    want = np.stack([generate_xqt(s, 16000, "vqt", device="cpu") for s in (anchor, positive)])
    profiling.reset()
    profiling.enable()
    try:
        rec = build_record("song", sig, BeatAnnotation(list(beats)), sr=44100, separation="spleeter",
                           sep_model=model, device="cpu")
        spans, counts = profiling.spans(), profiling.counts()
    finally:
        profiling.enable(False)
        profiling.reset()
    np.testing.assert_array_equal(rec.vqt, want)
    assert rec.pulse.shape == (want.shape[-1],)
    names = [s.name for s in spans]
    assert names == ["record", "record.separate", "spleeter.stft", "spleeter.unet", "spleeter.masks",
                     "spleeter.resample"]
    assert {s.request for s in spans} == {1}
    got = {}
    for c in counts:
        got[c.name] = got.get(c.name, 0) + c.n
    assert got["spleeter.segments"] == 3 and got["spleeter.unet_launch"] == 4

    # track_signal reads the weights from an .npz under the source's names, and separates before 16 kHz.
    path = str(tmp_path / "spleeter_small.npz")
    save_spleeter_file(path, model)
    loaded = load_spleeter_file(path)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), model.state_dict().values()))
    with np.load(path) as data:
        assert {"conv2d/kernel", "conv2d_27/bias", "conv2d_transpose_23/kernel",
                "batch_normalization_47/moving_variance"} <= set(data.files)
        assert data["conv2d/kernel"].shape == (5, 5, 2, 2)
    tracker = BeatTracker(seed=0, device="cpu")
    res = tracker.track_signal(sig, 44100, separation="spleeter", sep_model=path, decoder=None)
    # The file holds the widths, not T and F: its nets run at the published 512 x 1,024 segments.
    big = spleeter.Spleeter(spleeter.SpleeterConfig(filters=model.cfg.filters))
    big.load_state_dict(model.state_dict())
    a, p = big.eval().separate(sig, 44100)
    with torch.inference_mode():
        want = best_log_xqt(torch.as_tensor(np.stack([a, p])), XQTParams(sample_rate=16000, mode="vqt"))
    np.testing.assert_array_equal(res.vqt, want.numpy())  # the two streams as one batch, as track_signal sends them


def test_other_rates_resample_to_44k_first(model, song):
    sig = song[0]
    at_22k = resample_device(torch.as_tensor(sig)[None], 44100, 22050)[0].numpy()
    anchor, _ = separate(at_22k, 22050, backend="spleeter", model=model, device="cpu")
    assert anchor.shape == (48000,)  # 3 s at 16 kHz, whatever the rate in
    assert model.last["magnitude"].shape[0] == 3


def test_mine_stems_reads_tracks_at_44k(model, song, tmp_path, monkeypatch):
    from zeronotesamba_torch.data import audio_io, separation
    from zeronotesamba_torch.data.fma import mine_stems

    monkeypatch.setitem(separation._SPLEETER_CACHE, (None, "cpu"), model)  # the small nets as the seeded default
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    audio_io.write_wav(str(corpus / "t1.wav"), song[0], 44100)
    written = mine_stems(str(corpus), str(tmp_path / "out"), separation="spleeter", min_len_s=2.0, lower_p=-1.0,
                         device="cpu")
    assert written == ["t1"]
    drums, sr = audio_io.load_audio(str(tmp_path / "out" / "t1" / "drums.wav"))
    assert sr == 16000 and drums.shape == (48000,)


def test_unknown_backend_raises_at_once():
    with pytest.raises(ValueError, match="unknown separation backend 'nope'.*spleeter"):
        separate(np.zeros(16000, np.float32), 16000, backend="nope", device="cpu")


def test_published_widths_and_counts():
    m = spleeter.Spleeter()
    held = sum(t.numel() for k, t in m.state_dict().items() if not k.endswith("num_batches_tracked"))
    assert held == ref.param_count(CONFIG) == CONFIG["parameters"] == 39_307_036
    assert ref.unet_flops(CONFIG) == 12_197_036_032 and ref.spleeter_flops(CONFIG, 3) == 146_364_432_384


@pytest.mark.parametrize("cmd", [["infer", "song.wav"], ["track-dir", "wavs", "--out", "o.json"],
                                 ["build-data", "gtzan", "--root", "r", "--out", "o"]])
def test_cli_offers_spleeter(cmd):
    from zeronotesamba_torch.cli import _tracker, build_parser

    args = build_parser().parse_args(cmd + ["--separation", "spleeter", "--device", "cpu"])
    assert args.separation == "spleeter"
    if cmd[0] != "build-data":
        _, kw = _tracker(args)
        assert kw["separation"] == "spleeter" and kw["sep_model"] is None
