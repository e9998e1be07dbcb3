"""The port's HPSS, separation backends, resampler and WAV I/O against the
JAX package. HPSS tolerance 1e-4: float32 FFTs and overlap-add sums in
another order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.data import audio_io as j_audio_io
from zeronotesamba_tpu.data.separation import separate as j_separate
from zeronotesamba_tpu.data.synthetic import click_track as j_click_track
from zeronotesamba_tpu.ops.hpss import _stft as j_stft
from zeronotesamba_tpu.ops.hpss import hpss as j_hpss
from zeronotesamba_tpu.ops.resample import resample_poly_host as j_resample
from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.separation import separate
from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.ops.hpss import _stft, hpss, hpss_host
from zeronotesamba_torch.ops.resample import resample_poly_host

torch.set_num_threads(2)

ATOL = 1e-4


def test_click_track_equals_jax():
    for kw in (dict(seed=11), dict(seed=3, harmonics=3, offbeat=0.5, jitter_s=0.01, drop_p=0.2)):
        sig, beats = click_track(4.0, 110.0, **kw)
        j_sig, j_beats = j_click_track(4.0, 110.0, **kw)
        np.testing.assert_array_equal(sig, j_sig)
        np.testing.assert_array_equal(beats, j_beats)


def test_hpss_matches_jax():
    sig, _ = j_click_track(2.0, 120.0, seed=7)
    y = np.stack([sig, np.random.default_rng(0).standard_normal(sig.shape).astype(np.float32) * 0.1])
    jh, jp = j_hpss(jnp.asarray(y))
    h, p = hpss(torch.tensor(y))
    assert h.shape == p.shape == y.shape
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=ATOL)
    hh, hp = hpss_host(sig, device="cpu")
    np.testing.assert_allclose(hh, h[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(hp, p[0].numpy(), atol=1e-6)


def test_stft_matches_jax():
    y = np.random.default_rng(1).standard_normal((1, 5000)).astype(np.float32)
    ref = np.asarray(j_stft(jnp.asarray(y), 512, 128))
    out = _stft(torch.tensor(y), 512, 128).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)


def test_separation_backends(tmp_path):
    sig, _ = click_track(1.0, 120.0, seed=2)
    a, p = separate(sig, 16000, backend="mix", device="cpu")
    np.testing.assert_array_equal(a, sig)
    assert p is not a and np.array_equal(p, sig)
    stem_dir = str(tmp_path)
    rng = np.random.default_rng(4)
    for name in ("bass", "drums", "other"):
        j_audio_io.write_wav(os.path.join(stem_dir, f"{name}.wav"), 0.2 * rng.standard_normal(8000), 16000)
    ours = separate(sig, 16000, backend="stems", stem_dir=stem_dir, device="cpu")
    ref = j_separate(sig, 16000, backend="stems", stem_dir=stem_dir)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    with pytest.raises(NotImplementedError):
        separate(sig, 16000, backend="learned", model_path="models/separator", device="cpu")
    with pytest.raises(ValueError):
        separate(sig, 16000, backend="stems", device="cpu")
    with pytest.raises(ValueError):
        separate(sig, 16000, backend="spleeter", device="cpu")


def test_resample_and_wav_io_match_jax(tmp_path):
    x = np.random.default_rng(5).standard_normal(4410).astype(np.float32) * 0.3
    np.testing.assert_array_equal(resample_poly_host(x, 44100, 16000), j_resample(x, 44100, 16000))
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, np.stack([x, -x], axis=1), 44100)
    sig, sr = audio_io.load_audio(path, target_sr=16000)
    j_sig, j_sr = j_audio_io.load_audio(path, target_sr=16000)
    assert sr == j_sr == 16000
    np.testing.assert_array_equal(sig, j_sig)
