"""The port's pretext data path against the JAX package's: frame RMS, the
RMS gate, pair mining, stem mining with its watermark, and both banks.
Same seeded inputs through both packages, on the CPU.

Tolerances: ``frame_rms`` 1e-5 relative (a float32 conv in another order);
``frame_rms_host``, gate decisions, mined crops, track ids and watermarks
exact; written stems within one int16 step (HPSS sums in another order, then
rounding to 16 bits); bank log-VQTs 5e-4, except near-empty cells (log |X|
<= -7), which sit at float32 rounding level and are held at 1e-2
(tests/test_torch_infer.py::test_low_cells_sit_at_float32_rounding).
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.data import fma as jfma
from zeronotesamba_tpu.data import stems as jstems
from zeronotesamba_tpu.experiments.pretext_driver import build_bank_from_stem_root as j_build_bank
from zeronotesamba_tpu.ops import rms as jrms
from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.fma import gen_clmr_bank, load_watermark, mine_stems
from zeronotesamba_torch.data.stems import mine_pair, rms_gate
from zeronotesamba_torch.data.synthetic import percussive_pair
from zeronotesamba_torch.experiments.pretext_driver import build_bank_from_stem_root
from zeronotesamba_torch.ops.rms import frame_rms, frame_rms_host

torch.set_num_threads(2)

SR = 16000
VQT_ATOL = 5e-4
NEAR_EMPTY_ATOL = 1e-2
LOG_FLOOR = -7.0
INT16_STEP = 1.0 / 32767.0


def _assert_vqt_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    low = ref <= LOG_FLOOR
    np.testing.assert_allclose(got[~low], ref[~low], rtol=0, atol=VQT_ATOL)
    np.testing.assert_allclose(got[low], ref[low], rtol=0, atol=NEAR_EMPTY_ATOL)


@pytest.mark.parametrize("length", [20000, 511, 4096])
def test_frame_rms_matches_jax(length):
    y = np.random.default_rng(length).standard_normal((3, length)).astype(np.float32)
    y[1] *= 1e-3
    got = frame_rms(torch.tensor(y)).numpy()
    ref = np.asarray(jrms.frame_rms(jnp.asarray(y)))
    assert got.shape == ref.shape == (3, 1 + length // 512)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    for row in y:
        np.testing.assert_array_equal(frame_rms_host(row), jrms.frame_rms_host(row))
    with pytest.raises(ValueError):
        frame_rms(torch.tensor(y[0]))


def test_rms_gate_decisions_equal_jax():
    rng = np.random.default_rng(0)
    decisions = []
    for i in range(24):
        a = rng.standard_normal(8000).astype(np.float32)
        p = (rng.standard_normal(8000) * rng.uniform(0.1, 6.0)).astype(np.float32)
        p[: rng.integers(0, 8000)] = 0.0
        for lo, hi in ((0.3, 1.0), (0.0, 0.5), (0.05, 0.9)):
            got = rms_gate(a, p, lo, hi)
            assert got == jstems.rms_gate(a, p, lo, hi)
            decisions.append(got)
    assert any(decisions) and not all(decisions)


def _pair(kind):
    rng = np.random.default_rng(5)
    anchor = rng.standard_normal(3 * SR).astype(np.float32)
    positive = rng.standard_normal(3 * SR).astype(np.float32)
    if kind == "halving":  # drums balanced in about 10% of the frames
        positive *= (np.arange(3 * SR) % SR < SR // 10).astype(np.float32)
    elif kind == "never":  # no drums at all: the gate never passes
        positive[:] = 0.0
    return anchor, positive


@pytest.mark.parametrize("kind", ["pass", "halving", "never"])
def test_mine_pair_draws_the_jax_crops(kind):
    anchor, positive = _pair(kind)
    ours, ref = random.Random(3), random.Random(3)
    kw = dict(clip_len_s=1.0, sample_rate=SR, lower_p=0.3, upper_p=1.0)
    a, p = mine_pair(anchor, positive, rng=ours, **kw)
    ja, jp = jstems.mine_pair(anchor, positive, rng=ref, **kw)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(p, jp)
    assert ours.random() == ref.random()  # the same number of draws
    assert len(a) == SR
    if kind == "halving":  # passed only once lower_p was halved
        assert not rms_gate(a, p, 0.3, 1.0) and rms_gate(a, p, 0.3 / 8, 1.0)
    if kind == "never":  # the 200th draw's crop
        fresh = random.Random(3)
        starts = [fresh.randint(0, 2 * SR - 1) for _ in range(200)]
        np.testing.assert_array_equal(a, anchor[starts[-1]: starts[-1] + SR])
    with pytest.raises(ValueError):
        mine_pair(anchor[:100], positive[:100], rng=ours, **kw)


def _corpus(root):
    """Two drum mixes (one in a subdirectory), a pure tone, a short clip, a
    corrupt wav and a non-wav file, 10.5 s each where long enough."""
    os.makedirs(os.path.join(root, "sub"))
    for i, (bpm, path) in enumerate(((100.0, "sub/track000.wav"), (128.0, "track001.wav"))):
        anchor, positive, _ = percussive_pair(10.5, bpm, seed=i)
        audio_io.write_wav(os.path.join(root, path), 0.5 * (anchor + positive), SR)
    t = np.arange(int(10.5 * SR)) / SR
    audio_io.write_wav(os.path.join(root, "tone.wav"), 0.3 * np.sin(2 * np.pi * 440.0 * t), SR)
    audio_io.write_wav(os.path.join(root, "short.wav"), np.zeros(SR, np.float32), SR)
    with open(os.path.join(root, "corrupt.wav"), "wb") as fh:
        fh.write(b"RIFFgarbage")
    with open(os.path.join(root, "notes.txt"), "w") as fh:
        fh.write("not audio")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    _corpus(root)
    return root


@pytest.mark.parametrize("separation", ["mix", "hpss"])
def test_mine_stems_matches_jax(corpus, tmp_path, separation):
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(separation=separation, lower_p=0.1, upper_p=1.0)
    first = mine_stems(corpus, out, limit=1, device="cpu", **kw)
    assert first == jfma.mine_stems(corpus, jout, limit=1, **kw) and len(first) == 1
    rest = mine_stems(corpus, out, device="cpu", **kw)
    assert rest == jfma.mine_stems(corpus, jout, **kw)
    written = first + rest
    # The walk is sorted by directory, then by file: sub/ comes last. The tone
    # fails the HPSS gate.
    expected = {"mix": ["tone", "track001", "track000"], "hpss": ["track001", "track000"]}[separation]
    assert written == expected
    with open(os.path.join(out, ".mined.json")) as a, open(os.path.join(jout, ".mined.json")) as b:
        assert a.read() == b.read()
    assert load_watermark(out) == {"track000", "track001", "tone", "short", "corrupt"}
    for tid in written:
        for stem in ("drums.wav", "other.wav"):
            got, _ = audio_io.load_audio(os.path.join(out, tid, stem))
            ref, _ = audio_io.load_audio(os.path.join(jout, tid, stem))
            np.testing.assert_allclose(got, ref, rtol=0, atol=INT16_STEP * 1.0001, err_msg=f"{tid}/{stem}")
    assert mine_stems(corpus, out, device="cpu", **kw) == []  # resumed: nothing left


def test_gen_clmr_bank_matches_jax(tmp_path):
    """Four 3 s drum mixes and a clip too short for a 2 s crop."""
    root = str(tmp_path / "mixes")
    os.makedirs(root)
    for i in range(5):
        anchor, positive, _ = percussive_pair(3.0 if i < 4 else 1.5, 90.0 + 20 * i, seed=20 + i)
        audio_io.write_wav(os.path.join(root, f"mix{i}.wav"), 0.5 * (anchor + positive), SR)
    kw = dict(clip_frames=64, clip_len_s=2.0, seed=4)
    got = gen_clmr_bank(root, 3, device="cpu", **kw)
    ref = jfma.gen_clmr_bank(root, 3, **kw)
    assert got.shape == (3, 2, 96, 64)
    _assert_vqt_close(got, ref)


def _stem_tree(root):
    """Three 4 s stem tracks (one with a bass stem), one too short for a
    2 s clip, and one directory without stems."""
    for i, bpm in enumerate((90.0, 120.0, 150.0, 110.0)):
        secs = 4.0 if i < 3 else 2.0
        anchor, positive, _ = percussive_pair(secs, bpm, seed=10 + i)
        tdir = os.path.join(root, f"t{i}")
        os.makedirs(tdir)
        audio_io.write_wav(os.path.join(tdir, "drums.wav"), positive, SR)
        audio_io.write_wav(os.path.join(tdir, "other.wav"), 0.7 * anchor, SR)
        if i == 1:
            audio_io.write_wav(os.path.join(tdir, "bass.wav"), 0.3 * anchor, SR)
    os.makedirs(os.path.join(root, "empty"))


def test_build_bank_from_stem_root_matches_jax(tmp_path):
    root = str(tmp_path / "stems")
    _stem_tree(root)
    kw = dict(clip_len_s=2.0, lower_p=0.3, seed=2)
    got = build_bank_from_stem_root(root, 10, device="cpu", **kw)
    ref = j_build_bank(root, 10, **kw)
    assert got.shape == (3, 2, 96, 126)
    _assert_vqt_close(got, ref)
    two = build_bank_from_stem_root(root, 2, device="cpu", **kw)
    np.testing.assert_array_equal(two, got[:2])
