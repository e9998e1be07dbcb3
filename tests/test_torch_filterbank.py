"""The port's filterbank constants equal the JAX package's bit for bit."""

import numpy as np
import pytest
import torch

from zeronotesamba_tpu.ops import filterbank as jfb
from zeronotesamba_tpu.ops import vqt as jvqt
from zeronotesamba_tpu.ops.pallas.vqt_kernel import _banks_f32
from zeronotesamba_torch.ops import filterbank as tfb
from zeronotesamba_torch.ops import vqt as tvqt

torch.set_num_threads(2)

MODES = ["vqt", "cqt"]


@pytest.mark.parametrize("mode", MODES)
def test_params_properties_equal(mode):
    jp, tp = jfb.XQTParams(mode=mode), tfb.XQTParams(mode=mode)
    for name in ("n_bins", "alpha", "q", "gamma", "fps"):
        assert getattr(tp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(tp.bin_frequencies(), jp.bin_frequencies())
    np.testing.assert_array_equal(tp.filter_lengths(), jp.filter_lengths())
    for n in (0, 255, 256, 8000, 160000):
        assert tp.num_frames(n) == jp.num_frames(n)


def test_params_validation_matches():
    with pytest.raises(ValueError):
        tfb.XQTParams(mode="stft")
    with pytest.raises(ValueError):
        tfb.XQTParams(hop=100)


def test_halfband_filter_bitwise():
    np.testing.assert_array_equal(tfb.halfband_decimation_filter(), jfb.halfband_decimation_filter())
    np.testing.assert_array_equal(tfb.halfband_decimation_filter(41, 8.0), jfb.halfband_decimation_filter(41, 8.0))


def test_analytic_kernel_and_decimation_bitwise():
    taps = jfb.halfband_decimation_filter()
    for freq, length in ((16.35, 4000.3), (440.0, 301.7), (3951.1, 33.2)):
        a = tfb.analytic_kernel(freq, length, 16000, np.sqrt(length))
        np.testing.assert_array_equal(a, jfb.analytic_kernel(freq, length, 16000, np.sqrt(length)))
        np.testing.assert_array_equal(tfb._decimate2_complex(a, taps), jfb._decimate2_complex(a, taps))


@pytest.mark.parametrize("mode", MODES)
def test_octave_kernel_bank_bitwise(mode):
    np.testing.assert_array_equal(tfb.octave_kernel_bank(tfb.XQTParams(mode=mode)),
                                  jfb.octave_kernel_bank(jfb.XQTParams(mode=mode)))


@pytest.mark.parametrize("mode", MODES)
def test_f32_banks_bitwise(mode):
    """The port's (n_oct, 256, 24) banks are the live columns of the Pallas banks."""
    ours = tfb.octave_banks_f32(tfb.XQTParams(mode=mode))
    theirs = _banks_f32(jfb.XQTParams(mode=mode))
    assert ours.dtype == np.float32 and ours.shape == (8, 256, 24)
    for j in range(8):
        np.testing.assert_array_equal(ours[j], theirs[j][:, :24])
        assert not theirs[j][:, 24:].any()


@pytest.mark.parametrize("mode", MODES)
def test_conv_constants_bitwise(mode):
    kt, dt = tvqt._conv_constants(tfb.XQTParams(mode=mode))
    kj, dj = jvqt._conv_constants(jfb.XQTParams(mode=mode))
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(dt, dj)
