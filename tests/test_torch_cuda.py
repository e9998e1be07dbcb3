"""The port on a card: each CUDA kernel against its plain PyTorch version,
and the main path on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: cascade samples 1e-5 (float32 FMA in another order), one
octave's log magnitudes 1e-4, the log-VQT against the plain conv path 5e-4,
pulses card vs CPU 1e-3 (cuDNN may pick FFT or Winograd sums).
"""

import numpy as np
import pytest
import torch

from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
from zeronotesamba_torch.ops.filterbank import XQTParams
from zeronotesamba_torch.ops.vqt import log_xqt

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _signal(seed, batch, seconds, device):
    y = np.random.default_rng(seed).standard_normal((batch, int(16000 * seconds))).astype(np.float32)
    return torch.tensor(0.1 * y, device=device)


# The last shape is ragged: neither its cascade input (183,040 samples) is a
# multiple of the cascade's 8,192-sample tile nor its 457 frames a multiple
# of the octave kernel's 128-frame tile.
@pytest.mark.parametrize("batch,seconds", [(2, 10.0), (1, 0.5), (32, 10.0), (3, 7.3)])
def test_kernels_match_plain(cuda, batch, seconds):
    p = XQTParams()
    y = _signal(9, batch, seconds, cuda)
    x0 = vk.cascade_input(y, p)
    before = dict(vk.LAUNCHES)
    packed = vk.decimation_cascade_packed(x0, 7)
    got = vk.unpack_levels(packed, x0.shape[1])
    for g, r in zip(got, vk.decimation_cascade_plain(x0, 7)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
    banks = vk.octave_banks(p, cuda)
    table = vk.octave_table(p, x0.shape[1])
    out_k = torch.full((batch, 96, p.num_frames(y.shape[1])), float("nan"), device=cuda)
    out_p = out_k.clone()
    vk.octaves_log_xqt(x0, packed, table, banks, out_k, log_eps=p.log_eps)
    vk.octaves_log_xqt_plain(x0, packed, table, banks, out_p, log_eps=p.log_eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=1e-4)
    assert vk.LAUNCHES["cascade"] == before["cascade"] + 1
    assert vk.LAUNCHES["octave"] == before["octave"] + 1
    before = dict(vk.LAUNCHES)
    torch.testing.assert_close(vk.log_xqt_fused(y, p), log_xqt(y, p), rtol=0, atol=5e-4)
    assert vk.LAUNCHES == {"cascade": before["cascade"] + 1, "octave": before["octave"] + 1}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 1024, device=cuda)
    with pytest.raises(ValueError):
        vk.decimation_cascade_packed(torch.zeros(1024, 2, device=cuda).t())  # not contiguous
    out = torch.empty(2, 96, 3, device=cuda)
    plan = torch.tensor([[0, 0, 0, 2, 0, 0]], dtype=torch.int64)
    with pytest.raises(ValueError):  # banks on another device
        vk.octaves_log_xqt(x, x, plan, torch.zeros(1, 256, 24), out, log_eps=1e-9)
    with pytest.raises(ValueError):  # plan on the card
        vk.octaves_log_xqt(x, x, plan.to(cuda), torch.zeros(1, 256, 24, device=cuda), out, log_eps=1e-9)


def test_beat_tracker_card_matches_cpu(cuda):
    sig, _ = click_track(6.0, 120.0, seed=3)
    gpu, cpu = BeatTracker(seed=1, device="cuda"), BeatTracker(seed=1, device="cpu")
    before = dict(vk.LAUNCHES)
    res_g = gpu.track_signal(sig, separation="hpss", decoder="dbn")
    assert vk.LAUNCHES["cascade"] > before["cascade"] and vk.LAUNCHES["octave"] > before["octave"]
    res_c = cpu.track_signal(sig, separation="hpss", decoder="dbn")
    for name in ("anchor_pulse", "positive_pulse", "fused_pulse"):
        np.testing.assert_allclose(getattr(res_g, name), getattr(res_c, name), atol=1e-3, err_msg=name)
    assert len(res_g.beat_times) == len(res_c.beat_times) > 0
    assert np.abs(res_g.beat_times - res_c.beat_times).max() <= 1 / 62.5 + 1e-9
