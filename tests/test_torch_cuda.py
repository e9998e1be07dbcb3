"""The port on a card: each CUDA kernel against its plain PyTorch version,
and the main path on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: cascade samples 1e-5 (float32 FMA in another order), one
octave's log magnitudes 1e-4, the log-VQT against the plain conv path 5e-4,
pulses card vs CPU 1e-3 (cuDNN may pick FFT or Winograd sums), one train
step card vs CPU: loss 1e-4 relative, gradients 1e-2 of each tensor's
largest, parameters 2 lr plus their float32 rounding; the staged pretext
step at k = 2 card vs CPU at the same tolerances (its gradients with the
CPU's max-pool and ReLU decisions replayed on the card); the staged step
on a one-rank NCCL mesh against the single-device step within 1e-7; the batched DBN
Viterbi kernel equal to its plain version bit for bit, and the device
decode's beats equal to the float64 DBN's on clean golden activations.
"""

import contextlib
import os

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


def test_train_step_card_matches_cpu(cuda):
    """One train_step at dropout off from the same seeded pretrained model on
    the card and on the CPU: loss 1e-4 relative; gradients per tensor within
    1e-2 of that tensor's largest |g| (a max-pool tie moves them by about
    1e-3 of it, a wrong backward by about 1); every parameter within 2 lr
    (Adam's first step moves a weight by at most lr) plus its float32
    rounding (2 eps |p|)."""
    from zeronotesamba_torch.train.state import downstream_learning_rate
    from zeronotesamba_torch.train.supervised import SupervisedConfig, init_state, train_step

    rng = np.random.default_rng(5)
    vqt = (rng.standard_normal((2, 2, 96, 256)) * 4.0 - 6.0).astype(np.float32)
    pulse = (rng.random((2, 256)) < 0.1).astype(np.float32)
    mask = np.ones((2, 256), np.float32)
    cfg = SupervisedConfig(status="pretrained", lr=1e-5)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        state = init_state(cfg, None, 3, device=dev)
        state, loss, out = train_step(state, *(torch.tensor(x, device=dev) for x in (vqt, pulse, mask)), None,
                                      cfg.status)
        runs[dev.type] = (loss.item(), {k: v.detach().cpu() for k, v in state.model.named_parameters()},
                          {k: v.grad.cpu() for k, v in state.model.named_parameters()})
    (lg, pg, gg), (lc, pc, gc) = runs["cuda"], runs["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    lr = downstream_learning_rate(cfg.status, cfg.pre, cfg.lr)
    for k in pc:
        torch.testing.assert_close(gg[k], gc[k], rtol=0, atol=1e-2 * gc[k].abs().max().item(), msg=k)
        torch.testing.assert_close(pg[k], pc[k], rtol=2 * torch.finfo(torch.float32).eps, atol=2 * lr)


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


def test_pretext_step_card_matches_cpu(cuda):
    """One staged zerons NT-Xent step at k = 2 (batch 4 x 128 a track),
    dropout 0, from the same seeded TwinPretext on the card and the CPU, at
    the train step's tolerances above. Near the NT-Xent plateau one max-pool
    or ReLU decision flipped by rounding moves a gradient by up to about 1e-2
    of its tensor's largest, so the gradients are held with the card's step
    replaying the CPU's decisions (utils/parity.py); the loss and the
    parameters come from the card's own step."""
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
    from zeronotesamba_torch.utils.parity import PiecewiseDecisions

    rng = np.random.default_rng(6)
    bank = (rng.standard_normal((3, 2, 96, 256)) * 4.0 - 6.0).astype(np.float32)
    tracks = np.array([0, 2])
    starts = np.stack([rng.choice(129, size=4, replace=False) for _ in tracks])
    cfg = PretextConfig(batch_size=4, crop_frames=128, dropout_rate=0.0, lr=1e-5)
    decisions = PiecewiseDecisions()
    runs = {}
    for run, dev, ctx in (("cpu", torch.device("cpu"), decisions.record), ("cuda", cuda, contextlib.nullcontext),
                          ("shared", cuda, decisions.replay)):
        state = init_pretext_state(cfg, 3, device=dev)
        with ctx():
            state, loss, _, _ = make_staged_train_step(cfg)(state, torch.tensor(bank, device=dev), tracks, starts,
                                                            None)
        runs[run] = (loss.item(), {k: v.detach().cpu() for k, v in state.model.named_parameters()},
                     {k: v.grad.cpu() for k, v in state.model.named_parameters()})
    (lg, pg, _), (lc, pc, gc), (_, _, gs) = runs["cuda"], runs["cpu"], runs["shared"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in pc:
        torch.testing.assert_close(gs[k], gc[k], rtol=0, atol=1e-2 * gc[k].abs().max().item(), msg=k)
        torch.testing.assert_close(pg[k], pc[k], rtol=2 * torch.finfo(torch.float32).eps, atol=2 * cfg.lr)


def test_one_rank_nccl_mesh_step_equals_single_device(cuda):
    """The track-parallel staged step on a world of one NCCL rank (in this
    process) against the single-device step, k = 2 at batch 4 x 128,
    dropout on (rank 0 draws the single-device masks), cuDNN deterministic:
    loss, cosines and parameters within 1e-7."""
    from zeronotesamba_torch.parallel.launch import single_rank
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
    from zeronotesamba_torch.train.supervised import dropout_generator

    rng = np.random.default_rng(6)
    bank = torch.tensor((rng.standard_normal((3, 2, 96, 256)) * 4.0 - 6.0).astype(np.float32), device=cuda)
    starts = np.stack([rng.choice(129, size=4, replace=False) for _ in range(2)])
    cfg = PretextConfig(batch_size=4, crop_frames=128, lr=1e-5)
    runs = []
    deterministic, benchmark = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with single_rank("nccl", cuda) as mesh:
            for m in (None, mesh):
                state = init_pretext_state(cfg, 3, device=cuda)
                _, loss, pc, nc = make_staged_train_step(cfg, m)(state, bank, np.array([0, 2]), starts,
                                                                 dropout_generator(1, 0, cuda))
                runs.append(([loss.item(), pc.item(), nc.item()],
                             {k: v.detach().cpu() for k, v in state.model.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, benchmark
    (v0, p0), (v1, p1) = runs
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-7)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=1e-7, msg=k)


def test_pretext_banks_launch_each_kernel_once_a_log_vqt(cuda, tmp_path):
    """A stem-bank item is two generate_xqt calls (anchor, positive), a CLMR
    item one: one cascade and one octave launch each."""
    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.fma import gen_clmr_bank
    from zeronotesamba_torch.data.synthetic import percussive_pair
    from zeronotesamba_torch.experiments.pretext_driver import build_bank_from_stem_root

    stems, mixes = tmp_path / "stems", tmp_path / "mixes"
    mixes.mkdir()
    for i in range(3):
        anchor, positive, _ = percussive_pair(3.0, 100.0 + 10 * i, seed=i)
        (stems / f"t{i}").mkdir(parents=True)
        audio_io.write_wav(str(stems / f"t{i}" / "drums.wav"), positive, 16000)
        audio_io.write_wav(str(stems / f"t{i}" / "other.wav"), anchor, 16000)
        audio_io.write_wav(str(mixes / f"m{i}.wav"), anchor + positive, 16000)
    for build, per_item in ((lambda: build_bank_from_stem_root(str(stems), 3, clip_len_s=2.0, device="cuda"), 2),
                            (lambda: gen_clmr_bank(str(mixes), 3, clip_frames=64, clip_len_s=2.0, device="cuda"), 1)):
        before = dict(vk.LAUNCHES)
        bank = build()
        assert len(bank) == 3 and np.isfinite(bank).all()
        assert vk.LAUNCHES == {k: before[k] + per_item * 3 for k in before}


def _golden():
    return np.load(os.path.join(os.path.dirname(__file__), "fixtures", "dbn_golden.npz"))


def test_viterbi_kernel_matches_plain_exactly(cuda):
    """Ragged songs (one of a single frame) zero-padded into one batch: the
    kernel's final scores, tempo choices and best states equal the plain
    frame loop's on the card bit for bit, in one launch."""
    from zeronotesamba_torch.decode import dbn_device
    from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig
    from zeronotesamba_torch.ops.cuda import dbn_kernel

    gold = _golden()
    acts = [gold[k].astype(np.float64) for k in ("act_clean_bpm95", "act_noise_only", "act_short_3s")]
    acts.append(np.full(1, 0.5))
    t_pad = max(len(a) for a in acts)
    masked = np.stack([np.pad(a, (0, t_pad - len(a))) for a in acts])
    cfg = DBNBeatDecoderConfig()
    la, lna = (torch.tensor(x.astype(np.float32), device=cuda) for x in dbn_device._observations(masked, cfg))
    space = dbn_device._space(cfg, cuda)
    before = dict(dbn_kernel.LAUNCHES)
    got = dbn_kernel.viterbi_forward(la, lna, space)
    assert dbn_kernel.LAUNCHES["viterbi"] == before["viterbi"] + 1
    ref = dbn_kernel.viterbi_forward_plain(la, lna, space)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)


def test_decode_beats_device_matches_decode_beats(cuda):
    from zeronotesamba_torch.decode import decode_beats, decode_beats_batch_device, decode_beats_device

    gold = _golden()
    keys = ("act_clean_bpm120", "act_jitter_bpm80", "act_ramp_70_140", "act_weak_bpm90")
    acts = [gold[k].astype(np.float64) for k in keys]
    for act in acts:
        np.testing.assert_array_equal(decode_beats_device(act, device="cuda"), decode_beats(act))
    t_pad = max(len(a) for a in acts)
    batch = np.stack([np.pad(a, (0, t_pad - len(a))) for a in acts])
    lengths = [len(a) for a in acts]
    for act, beats in zip(acts, decode_beats_batch_device(batch, lengths, device="cuda")):
        np.testing.assert_array_equal(beats, decode_beats(act, use_native=False))
    assert decode_beats_batch_device(batch, [lengths[0], 0, 5, 7], device="cuda")[1].size == 0
