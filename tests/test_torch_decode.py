"""The port's decoders against the JAX package's: the native C++ DBN built
from the port's own source, the batched Viterbi's plain version (what the
card's kernel is held against), the device decode, Ellis DP, the online DBN
and the threshold picker.

Tolerances: Viterbi paths, tempo choices, best states and final scores
exact (every value is one float32 or float64 add or a maximum of such
values, and ties go to the lowest index on both sides); beat times from the
same arrays through numpy code copied from the JAX package at 1e-12.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_viterbi_rounds import F64_CASES, f64_case

from zeronotesamba_tpu.decode import decode as j_decode
from zeronotesamba_tpu.decode import dbn_jax as jdev
from zeronotesamba_tpu.decode.dbn import DBNBeatDecoderConfig as JConfig
from zeronotesamba_tpu.decode.dbn import decode_beats as j_decode_beats
from zeronotesamba_tpu.decode.dbn_online import decode_beats_online as j_online
from zeronotesamba_tpu.decode.ellis import beat_track_dp as j_dp
from zeronotesamba_tpu.decode.ellis import beat_track_signal as j_track_signal
from zeronotesamba_tpu.decode.ellis import estimate_tempo as j_tempo
from zeronotesamba_tpu.decode.ellis import onset_strength as j_onset
from zeronotesamba_torch import decode as decode_pkg
from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.decode import (
    DBNBeatDecoderConfig,
    OnlineBeatDecoder,
    beat_track_dp,
    beat_track_signal,
    decode,
    decode_beats,
    decode_beats_batch_device,
    decode_beats_device,
    decode_beats_online,
    estimate_tempo,
    onset_strength,
    threshold_beats,
)
from zeronotesamba_torch.decode import dbn as dbn_mod
from zeronotesamba_torch.decode import dbn_device, dbn_native
from zeronotesamba_torch.metrics.beat import evaluate_beats, f_measure
from zeronotesamba_torch.ops.cuda import dbn_kernel
from zeronotesamba_torch.utils import profiling

torch.set_num_threads(2)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "dbn_golden.npz"))
ACT_KEYS = sorted(k[len("act_"):] for k in GOLD.files if k.startswith("act_"))
FPS = 62.5


def _pulse(bpm, dur=20.0, seed=0, noise=0.05, start=5):
    """A periodic spike train over half-normal noise, as the JAX tests draw it."""
    rng = np.random.default_rng(seed)
    n = int(dur * FPS)
    act = np.abs(noise * rng.standard_normal(n))
    for f in range(start, n - 2, int(round(60.0 / bpm * FPS))):
        act[f] = 0.9
    return np.clip(act, 0, 1)


def _observations(act, cfg=DBNBeatDecoderConfig()):
    eps = np.spacing(1)
    return np.log(act + eps), np.log((1.0 - act) / (cfg.observation_lambda - 1) + eps)


# --------------------------------------------------------------------------
# The native C++ Viterbi
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", ACT_KEYS)
def test_native_path_equals_numpy_on_golden(key):
    act = GOLD[f"act_{key}"].astype(np.float64)
    cfg = DBNBeatDecoderConfig()
    intervals, firsts, lasts, _, _, log_trans, is_beat = dbn_mod._state_space(cfg)
    la, lna = _observations(act, cfg)
    ref = dbn_mod._viterbi_numpy(la, lna, intervals, firsts, lasts, log_trans, is_beat)
    np.testing.assert_array_equal(dbn_native.viterbi_native(la, lna, intervals, log_trans, is_beat, firsts, lasts),
                                  ref)
    for correct, tag in ((True, "c"), (False, "u")):
        c = DBNBeatDecoderConfig(correct=correct)
        native = decode_beats(act, c)
        np.testing.assert_array_equal(native, decode_beats(act, c, use_native=False))
        np.testing.assert_array_equal(native, j_decode_beats(act, JConfig(correct=correct), use_native=False))
        np.testing.assert_allclose(native, GOLD[f"beats_{tag}_{key}"], atol=1e-9)


def test_native_library_is_the_ports_own_build():
    """Built from zeronotesamba_torch/csrc/dbn_viterbi.cpp into the port's
    _build/<hash>/ with portable flags; the repo root's prebuilt library is
    never the one loaded."""
    path = dbn_native.build()
    assert path == dbn_native.library_path() and path.is_file()
    assert path.parent.parent == dbn_native.BUILD_ROOT
    assert dbn_native.SOURCE.parent.parent.name == "zeronotesamba_torch"
    assert "-march=native" not in dbn_native.CXX_FLAGS
    lib = dbn_native._load()
    assert os.path.realpath(lib._name) == os.path.realpath(path)


def test_decode_beats_counts_its_backend():
    act = _pulse(120, 8.0)
    before = profiling.totals("dbn.")
    decode_beats(act)
    decode_beats(act, use_native=False)
    decode(act, "dbn")
    decode(act, "dbn", device="cpu")  # a caller on the CPU decodes on the host
    assert profiling.totals("dbn.") == {"native": before["native"] + 3, "numpy": before["numpy"] + 1,
                                        "device": before["device"]}


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No compiler means an error, never a silent numpy decode."""
    monkeypatch.setattr(dbn_native, "_LIB", None)
    monkeypatch.setattr(dbn_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-zns")
    with pytest.raises(RuntimeError, match="compiler"):
        decode_beats(_pulse(120, 4.0))
    assert decode_beats(_pulse(120, 4.0), use_native=False).size > 0


@pytest.mark.parametrize("name", F64_CASES)
def test_float64_forward_and_native_backtrack_equal_the_host_dbn(name):
    """The offline DBN as a card runs it (decode_beats with a CUDA device),
    with the kernel's plain float64 version in the kernel's place: the
    observations decode_beats computes, the float64 forward pass, the best
    final state and the C++ backtrack give viterbi_native's path, and the
    beats decode_beats's, bit for bit."""
    act = f64_case(name)
    cfg = DBNBeatDecoderConfig()
    intervals, firsts, lasts, _, _, log_trans, is_beat = dbn_mod._state_space(cfg)
    la, lna = _observations(act, cfg)
    path = dbn_device.viterbi_path_f64(la, lna, cfg, device="cpu")
    np.testing.assert_array_equal(path, dbn_native.viterbi_native(la, lna, intervals, log_trans, is_beat, firsts,
                                                                  lasts))
    for correct in (True, False):
        c = DBNBeatDecoderConfig(correct=correct)
        np.testing.assert_array_equal(dbn_device._beats(path, act, c), decode_beats(act, c))


def test_native_backtrack_checks_its_inputs():
    _, firsts, lasts, _, _, _, is_beat = dbn_mod._state_space(DBNBeatDecoderConfig())
    fc = np.zeros((4, firsts.size), np.int16)
    assert dbn_native.backtrack_native(fc, 5, firsts, lasts, is_beat.size).tolist() == [2, 3, 4, 5]
    with pytest.raises(ValueError):
        dbn_native.backtrack_native(fc, is_beat.size, firsts, lasts, is_beat.size)
    with pytest.raises(ValueError):
        dbn_native.backtrack_native(fc[:, 1:], 5, firsts, lasts, is_beat.size)


# --------------------------------------------------------------------------
# The batched Viterbi: plain version (the kernel's reference) and device decode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ragged_batch():
    """B = 3 ragged songs (16, 9.6 and 12.4 s) zero-padded to 1,000 frames."""
    acts, lengths = [], []
    for i, (bpm, dur) in enumerate(((80, 16.0), (150, 9.6), (120, 12.4))):
        a = _pulse(bpm, dur=dur, seed=i)
        acts.append(np.pad(a, (0, 1000 - len(a))))
        lengths.append(len(a))
    return np.stack(acts), lengths


def test_plain_viterbi_equals_jax_scan_exactly(ragged_batch):
    acts, lengths = ragged_batch
    masked = acts.copy()
    for b, nf in enumerate(lengths):
        masked[b, nf:] = 0.0
    la, lna = _observations(masked)
    v, fc, best = dbn_device.viterbi_forward_device(la, lna, device="cpu")
    jv, jfc, jbest = jax.vmap(lambda a, n: jdev._viterbi_scan(a, n, JConfig()))(jnp.asarray(la), jnp.asarray(lna))
    assert fc.dtype == np.int16 and best.dtype == np.int32 and v.dtype == np.float32
    np.testing.assert_array_equal(fc, np.asarray(jfc))
    np.testing.assert_array_equal(best, np.asarray(jbest))
    np.testing.assert_array_equal(v, np.asarray(jv))


def test_batched_decode_equals_jax_and_per_song(ragged_batch):
    acts, lengths = ragged_batch
    cfg = DBNBeatDecoderConfig()
    ours = decode_beats_batch_device(acts, lengths, cfg, device="cpu")
    ref = jdev.decode_beats_batch_device(acts, lengths, JConfig())
    for b, nf in enumerate(lengths):
        np.testing.assert_array_equal(ours[b], ref[b])
        np.testing.assert_allclose(ours[b], decode_beats(acts[b, :nf], cfg, use_native=False))


def test_batched_decode_guards_an_empty_song(ragged_batch):
    acts, lengths = ragged_batch
    out = decode_beats_batch_device(acts, [lengths[0], 0, lengths[2]], device="cpu")
    assert out[1].size == 0 and out[1].dtype == np.float64
    ref = decode_beats_batch_device(acts, lengths, device="cpu")
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[2], ref[2])


@pytest.mark.parametrize("correct,bpm,seed", [(True, 125, 0), (False, 90, 2)])
def test_device_decode_equals_jax_and_numpy(correct, bpm, seed):
    act = _pulse(bpm, seed=seed)
    cfg = DBNBeatDecoderConfig(correct=correct)
    ours = decode_beats_device(act, cfg, device="cpu")
    np.testing.assert_array_equal(ours, jdev.decode_beats_device(act, JConfig(correct=correct)))
    np.testing.assert_allclose(ours, decode_beats(act, cfg, use_native=False))
    np.testing.assert_array_equal(dbn_device.viterbi_path_device(act, cfg, device="cpu"),
                                  jdev.viterbi_path_device(act, JConfig(correct=correct)))
    assert decode_beats_device(np.zeros(0), device="cpu").size == 0


def test_device_decode_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        decode_beats_device(_pulse(120, 4.0))
    with pytest.raises(RuntimeError, match="cuda"):
        decode_beats_batch_device(_pulse(120, 4.0)[None], [250])


def test_viterbi_space_and_wrapper_checks():
    cfg = DBNBeatDecoderConfig()
    _, firsts, lasts, _, _, log_trans, is_beat = dbn_mod._state_space(cfg)
    space = dbn_kernel.viterbi_space(log_trans, firsts, lasts, is_beat, "cpu")
    assert (space.n_int, space.n_states) == (52, 2210) and space.log_trans.dtype == torch.float32
    assert space.v0 == float(np.float32(-np.log(2210.0)))
    with pytest.raises(ValueError, match="chains"):
        dbn_kernel.viterbi_space(log_trans, firsts + 1, lasts, is_beat, "cpu")
    la = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        dbn_kernel.viterbi_forward(la.double(), la.double(), space)
    with pytest.raises(ValueError):
        dbn_kernel.viterbi_forward(la, torch.zeros(2, 9), space)
    before = profiling.totals("dbn_launch.")
    v, fc, best = dbn_kernel.viterbi_forward(torch.zeros(0, 8), torch.zeros(0, 8), space)
    assert v.shape == (0, 2210) and fc.shape == (0, 8, 52) and best.shape == (0, 8)
    dbn_kernel.viterbi_forward(la, la, space)
    assert profiling.totals("dbn_launch.") == before  # the CPU runs the plain version, no launch


# --------------------------------------------------------------------------
# Ellis DP, the online DBN, the threshold picker and the dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["clean_bpm95", "jitter_bpm150", "weak_bpm135", "ramp_70_140", "noise_only"])
def test_ellis_and_online_equal_jax_on_golden(key):
    act = GOLD[f"act_{key}"].astype(np.float64)
    np.testing.assert_allclose(beat_track_dp(act, FPS), j_dp(act, FPS), rtol=0, atol=1e-12)
    np.testing.assert_allclose(estimate_tempo(act, FPS), j_tempo(act, FPS), rtol=0, atol=1e-12)
    np.testing.assert_allclose(decode_beats_online(act), j_online(act), rtol=0, atol=1e-12)
    np.testing.assert_allclose(threshold_beats(act), j_decode(act, "threshold"), rtol=0, atol=1e-12)


def test_ellis_on_raw_audio_equals_jax():
    sig, beats = click_track(12.0, 120.0, accomp=True, seed=5)
    np.testing.assert_allclose(onset_strength(sig), j_onset(sig), rtol=0, atol=1e-12)
    ours = beat_track_signal(sig)
    np.testing.assert_allclose(ours, j_track_signal(sig), rtol=0, atol=1e-12)
    assert evaluate_beats(beats, ours)[0] > 0.8


def test_online_decoder_incremental_reset_and_offline_agreement():
    act = _pulse(120, dur=25.0, noise=0.04, start=8)
    dec = OnlineBeatDecoder()
    for a in act:
        dec.process_frame(float(a))
    inc = np.asarray(dec.beats)
    np.testing.assert_allclose(inc, decode_beats_online(act))
    dec.reset()
    np.testing.assert_allclose(dec.process(act), inc)
    offline = decode_beats(act)
    assert f_measure(offline[offline > 3], inc[inc > 3]) > 0.9


@pytest.mark.parametrize("method", ["dbn", "librosa", "ellis", "threshold"])
def test_decode_dispatch_equals_jax(method):
    act = GOLD["act_clean_bpm143"].astype(np.float64)
    np.testing.assert_allclose(decode(act, method), j_decode(act, method), rtol=0, atol=1e-12)


def test_decode_package_exports_the_jax_names():
    import zeronotesamba_tpu.decode as jpkg

    assert sorted(decode_pkg.__all__) == sorted(jpkg.__all__)
    assert all(hasattr(decode_pkg, n) for n in decode_pkg.__all__)
    with pytest.raises(ValueError):
        decode(np.zeros(10), "viterbi")
