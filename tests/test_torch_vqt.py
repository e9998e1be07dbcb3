"""The port's log-VQT (plain path, kernel wrapper, both kernels' plain
versions) against the JAX package. The CUDA kernels are held against their
plain versions on a card by tests/test_torch_cuda.py.

JAX runs on the CPU with its Pallas kernels in interpret mode, as the JAX
package's own tests run them. Tolerances: 5e-4 on the log-VQT (as at
tests/test_pallas_vqt.py), 1e-5 on cascade samples, 1e-4 on one octave's log
magnitudes; float32 sums taken in another order are the only difference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeronotesamba_tpu.ops.filterbank import XQTParams as JParams
from zeronotesamba_tpu.ops.pallas.vqt_kernel import (
    _banks_f32,
    decimation_cascade_pallas,
    log_xqt_pallas,
    octave_log_xqt_pallas,
)
from zeronotesamba_tpu.ops.vqt import generate_xqt as j_generate_xqt
from zeronotesamba_tpu.ops.vqt import log_xqt as j_log_xqt
from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
from zeronotesamba_torch.ops.filterbank import XQTParams, octave_banks_f32
from zeronotesamba_torch.ops.vqt import best_log_xqt, generate_xqt, log_xqt

torch.set_num_threads(2)

VQT_ATOL = 5e-4
CASCADE_ATOL = 1e-5
OCTAVE_ATOL = 1e-4
# 3 s clips, and 0.5 s clips: shorter than the full-rate reflect pad (16,512
# samples), so the pad reflects more than once.
LENGTHS = [48000, 8000]


def _signal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["vqt", "cqt"])
@pytest.mark.parametrize("length", LENGTHS)
def test_log_xqt_matches_jax(mode, length):
    y = _signal(length, (2, length))
    ref = np.asarray(j_log_xqt(jnp.asarray(y), JParams(mode=mode)))
    out = log_xqt(torch.tensor(y), XQTParams(mode=mode)).numpy()
    assert out.shape == ref.shape == (2, 96, 1 + length // 256)
    np.testing.assert_allclose(out, ref, atol=VQT_ATOL)


@pytest.mark.parametrize("length", LENGTHS)
def test_log_xqt_fused_cpu_matches_pallas(length):
    y = _signal(length + 1, (2, length))
    ref = np.asarray(log_xqt_pallas(jnp.asarray(y), JParams(), interpret=True, fused_cascade=True))
    out = vk.log_xqt_fused(torch.tensor(y), XQTParams()).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=VQT_ATOL)


@pytest.mark.parametrize("n_levels", [3, 7])
def test_cascade_plain_matches_pallas(n_levels):
    """Both read zero beyond every level's edges, so the levels agree on
    every sample, not only on the interior that tests/test_pallas_vqt.py
    holds against the reflect-padded chain."""
    x = _signal(3, (2, 256 * 40))
    ref = decimation_cascade_pallas(jnp.asarray(x), n_levels, interpret=True)
    got = vk.decimation_cascade(torch.tensor(x), n_levels)
    assert len(got) == n_levels
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=CASCADE_ATOL)


@pytest.mark.parametrize("octave,hop", [(7, 256), (4, 32), (0, 2)])
def test_octave_plain_matches_pallas(octave, hop):
    p = XQTParams()
    n_frames, offset = 150, 37
    level = _signal(octave, (2, offset + (n_frames - 1) * hop + 256 + 5))
    ref = octave_log_xqt_pallas(
        jnp.asarray(level[:, offset:]), jnp.asarray(_banks_f32(JParams())[octave]), hop=hop, w=256,
        n_frames=n_frames, log_eps=p.log_eps, interpret=True,
    )  # (B, T, 12)
    out = torch.full((2, 96, n_frames), float("nan"))
    bank = torch.tensor(octave_banks_f32(p)[octave])
    vk.octave_log_xqt(torch.tensor(level), bank, out, row=12 * octave, offset=offset, hop=hop, log_eps=p.log_eps)
    got = out[:, 12 * octave:12 * octave + 12, :].numpy()
    np.testing.assert_allclose(got, np.swapaxes(np.asarray(ref), 1, 2), atol=OCTAVE_ATOL)
    rest = torch.cat([out[:, :12 * octave], out[:, 12 * octave + 12:]], dim=1)
    assert torch.isnan(rest).all(), "the octave wrote outside its 12 rows"


def test_best_log_xqt_cpu_is_plain_path():
    y = torch.tensor(_signal(5, (2, 16000)))
    torch.testing.assert_close(best_log_xqt(y), log_xqt(y), rtol=0, atol=0)


def test_generate_xqt_matches_jax():
    sig = _signal(6, (24000,))
    ref = j_generate_xqt(sig, 16000, "cqt")
    out = generate_xqt(sig, 16000, "cqt", device="cpu")
    assert out.dtype == np.float32 and out.shape == ref.shape == (96, 94)
    np.testing.assert_allclose(out, ref, atol=VQT_ATOL)
    with pytest.raises(ValueError):
        generate_xqt(sig, 16000, "stft", device="cpu")


def test_kernel_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 256 * 4)
    with pytest.raises(ValueError):
        vk.decimation_cascade(torch.zeros(2, 1000))  # not a multiple of 256
    with pytest.raises(TypeError):
        vk.decimation_cascade(x.double())
    with pytest.raises(ValueError):
        vk.decimation_cascade(x, 8)
    bank = torch.zeros(256, 24)
    out = torch.empty(2, 96, 5)
    with pytest.raises(ValueError):  # frames run past the level
        vk.octave_log_xqt(x, bank, out, row=0, offset=0, hop=256, log_eps=1e-9)
    with pytest.raises(ValueError):  # row out of range
        vk.octave_log_xqt(x, bank, out, row=90, offset=0, hop=2, log_eps=1e-9)
    with pytest.raises(ValueError):
        vk.octave_log_xqt(x, torch.zeros(256, 128), out, row=0, offset=0, hop=2, log_eps=1e-9)


def test_cpu_tensors_launch_no_kernel():
    before = dict(vk.LAUNCHES)
    vk.log_xqt_fused(torch.tensor(_signal(8, (1, 4000))))
    assert vk.LAUNCHES == before
