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
Viterbi kernel equal to its plain version bit for bit in float32 and in
float64, the float64 path equal to the host C++ DBN's, and the device
decode's beats equal to the float64 DBN's on clean golden activations; a
K-step call as one CUDA graph equal to K eager steps bit for bit (cuDNN
deterministic), also after a resume.
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
from zeronotesamba_torch.utils import profiling

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
    before = profiling.totals("vqt_launch.")
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
    assert profiling.totals("vqt_launch.") == {"cascade": before["cascade"] + 1, "octave": before["octave"] + 1}
    before = profiling.totals("vqt_launch.")
    torch.testing.assert_close(vk.log_xqt_fused(y, p), log_xqt(y, p), rtol=0, atol=5e-4)
    assert profiling.totals("vqt_launch.") == {"cascade": before["cascade"] + 1, "octave": before["octave"] + 1}


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
    before = profiling.totals("vqt_launch.")
    res_g = gpu.track_signal(sig, separation="hpss", decoder="dbn")
    after = profiling.totals("vqt_launch.")
    assert after["cascade"] > before["cascade"] and after["octave"] > before["octave"]
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
        before = profiling.totals("vqt_launch.")
        bank = build()
        assert len(bank) == 3 and np.isfinite(bank).all()
        assert profiling.totals("vqt_launch.") == {k: before[k] + per_item * 3 for k in before}


def _golden():
    return np.load(os.path.join(os.path.dirname(__file__), "fixtures", "dbn_golden.npz"))


def _viterbi_equal_on_card(la, lna, space, threads=0):
    from zeronotesamba_torch.ops.cuda import dbn_kernel

    before = profiling.totals("dbn_launch.")["viterbi"]
    got = dbn_kernel._viterbi_forward_cuda(la, lna, space, threads) if threads else \
        dbn_kernel.viterbi_forward(la, lna, space)
    assert profiling.totals("dbn_launch.")["viterbi"] == before + 1
    ref = dbn_kernel.viterbi_forward_plain(la, lna, space)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)


@pytest.mark.parametrize("threads", [0, 64, 512])
@pytest.mark.parametrize("shape", ["ragged", "1x1876", "ties"])
def test_viterbi_kernel_matches_plain_exactly(cuda, shape, threads):
    """Ragged songs (one of a single frame) zero-padded into one batch, one
    30 s song (1,876 frames), and observations that tie many states (all
    equal, and on a grid of quarters): the kernel's final scores, tempo
    choices and best states equal the plain frame loop's on the card bit for
    bit, in one launch, at the default block and at 64 and 512 threads."""
    from zeronotesamba_torch.decode import dbn_device
    from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig

    cfg = DBNBeatDecoderConfig()
    space = dbn_device._space(cfg, cuda)
    if shape == "ties":
        from test_torch_viterbi_rounds import _grid_obs

        same = torch.full((2, 300), -0.5, device=cuda)
        _viterbi_equal_on_card(same, same, space, threads)
        la, lna = (torch.tensor(x, device=cuda) for x in _grid_obs(np.random.default_rng(7), 3, 400))
        _viterbi_equal_on_card(la, lna, space, threads)
        return
    gold = _golden()
    if shape == "ragged":
        acts = [gold[k].astype(np.float64) for k in ("act_clean_bpm95", "act_noise_only", "act_short_3s")]
        acts.append(np.full(1, 0.5))
    else:
        acts = [np.tile(gold["act_ramp_70_140"].astype(np.float64), 2)[:1876]]
    t_pad = max(len(a) for a in acts)
    masked = np.stack([np.pad(a, (0, t_pad - len(a))) for a in acts])
    la, lna = (torch.tensor(x.astype(np.float32), device=cuda) for x in dbn_device._observations(masked, cfg))
    _viterbi_equal_on_card(la, lna, space, threads)


@pytest.mark.parametrize("n_frames", [0, 1, 2, 7, 41, 300])
@pytest.mark.parametrize("lengths", [(3, 1, 4, 2), (2, 5, 3, 2), (4, 3, 6, 5)])
def test_viterbi_kernel_on_short_chains(cuda, lengths, n_frames):
    """Hand-made spaces whose shortest chain is 1, 2 or 3 states (R = 1, 2,
    3), ties everywhere and -inf tempo columns (tests/test_torch_viterbi_rounds.py),
    T = 0, one frame, T < R and T not a multiple of R: equal bit for bit."""
    from test_torch_viterbi_rounds import _grid_obs, _hand_space

    from zeronotesamba_torch.ops.cuda import dbn_kernel

    space = _hand_space(lengths, seed=sum(lengths) + n_frames)
    space = dbn_kernel.viterbi_space(space.log_trans.numpy(), space.firsts.numpy(), space.lasts.numpy(),
                                     space.is_beat.numpy(), cuda)
    assert space.frames_per_round == min(lengths)
    la, lna = (torch.tensor(x, device=cuda) for x in _grid_obs(np.random.default_rng(n_frames), 3, n_frames))
    _viterbi_equal_on_card(la, lna, space)


def _f64_equal_on_card(act, cuda, threads=0):
    """The float64 kernel on one song's observations: its final scores, tempo
    choices and best states equal its plain version's on the card, and the
    path of the decode as track_signal runs it equals the host C++'s."""
    from zeronotesamba_torch.decode import dbn_device, dbn_native
    from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, _state_space

    cfg = DBNBeatDecoderConfig()
    intervals, firsts, lasts, _, _, log_trans, is_beat = _state_space(cfg)
    la, lna = dbn_device._observations(np.asarray(act, np.float64), cfg)
    space = dbn_device._space(cfg, cuda, torch.float64)
    _viterbi_equal_on_card(*(torch.tensor(x[None], device=cuda) for x in (la, lna)), space, threads)
    np.testing.assert_array_equal(dbn_device.viterbi_path_f64(la, lna, cfg, device=cuda),
                                  dbn_native.viterbi_native(la, lna, intervals, log_trans, is_beat, firsts, lasts))


@pytest.mark.parametrize("name", ["random", "bpm60", "bpm120", "bpm200", "zeros", "constant", "one_frame",
                                  "frames16", "frames35", "frames103", "track_signal"])
def test_viterbi_f64_kernel_matches_plain_and_the_host_dbn(cuda, name):
    """The float64 instance on the CPU tests' cases (tests/test_torch_viterbi_rounds.F64_CASES;
    the 30 s random song also at 64 and 256 threads) and on 20 seeded 30 s
    click tracks' fused pulses from track_signal: bit for bit its plain
    version, and the host C++ DBN's path."""
    from test_torch_viterbi_rounds import f64_case

    if name != "track_signal":
        _f64_equal_on_card(f64_case(name), cuda)
        if name == "random":
            for threads in (64, 256):
                _f64_equal_on_card(f64_case(name), cuda, threads)
        return
    tracker = BeatTracker(seed=0, device="cuda")
    for k in range(20):
        sig, _ = click_track(30.0, 60.0 + 7.0 * k, seed=100 + k)
        _f64_equal_on_card(tracker.track_signal(sig, decoder=None).fused_pulse, cuda)


@pytest.mark.parametrize("n_frames", [1, 2, 7, 41, 300])
@pytest.mark.parametrize("lengths", [(3, 1, 4, 2), (2, 5, 3, 2), (4, 3, 6, 5)])
def test_viterbi_f64_kernel_on_short_chains(cuda, lengths, n_frames):
    """The float64 instance on the hand-made spaces (R = 1, 2, 3; ties and
    -inf tempo columns): equal to its plain version bit for bit."""
    from test_torch_viterbi_rounds import _grid_obs, _hand_space

    from zeronotesamba_torch.ops.cuda import dbn_kernel

    space = _hand_space(lengths, seed=sum(lengths) + n_frames, dtype=torch.float64)
    space = dbn_kernel.viterbi_space(space.log_trans.numpy(), space.firsts.numpy(), space.lasts.numpy(),
                                     space.is_beat.numpy(), cuda, torch.float64)
    la, lna = (torch.tensor(x, device=cuda)
               for x in _grid_obs(np.random.default_rng(n_frames), 3, n_frames, np.float64))
    _viterbi_equal_on_card(la, lna, space)


def test_track_signal_decodes_on_the_card(cuda):
    """track_signal on a card runs the DBN's forward pass there: one float64
    launch and one dbn.device decode a song, no native one, and the beats of
    the host C++ DBN on the same pulse; one upload of the observations and
    one download of the tempo choices more than the song's own copies."""
    from zeronotesamba_torch.decode import decode_beats

    sig, _ = click_track(30.0, 120.0, seed=7)
    tracker = BeatTracker(seed=0, device="cuda")
    tracker.track_signal(sig)  # warm: builds, plans
    before = profiling.totals()
    res = tracker.track_signal(sig, separation="hpss", decoder="dbn")
    after = profiling.totals()
    moved = {k: after[k] - before.get(k, 0) for k in ("dbn.device", "dbn.native", "dbn.numpy", "dbn_launch.viterbi")}
    assert moved == {"dbn.device": 1, "dbn.native": 0, "dbn.numpy": 0, "dbn_launch.viterbi": 1}
    plain = tracker.track_signal(sig, separation="hpss", decoder=None)
    after_plain = profiling.totals()
    assert after["d2h_syncs"] - before["d2h_syncs"] == after_plain["d2h_syncs"] - after["d2h_syncs"] + 1
    assert after["h2d_bytes"] - before["h2d_bytes"] == \
        after_plain["h2d_bytes"] - after["h2d_bytes"] + 2 * 8 * res.fused_pulse.size
    assert res.beat_times.size > 0
    np.testing.assert_array_equal(res.beat_times, decode_beats(res.fused_pulse))


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


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _bucket(cuda, n=6, streams=2, frames=128, seed=7):
    rng = np.random.default_rng(seed)
    vqt = torch.tensor((rng.standard_normal((n, streams, 96, frames)) * 4.0 - 6.0).astype(np.float32), device=cuda)
    pulse = torch.tensor((rng.random((n, frames)) < 0.1).astype(np.float32), device=cuda)
    return vqt, pulse, torch.ones(n, frames, device=cuda)


def _eager_steps(state, bucket, idx, generators, status):
    """train_step on rows idx[k] of the bucket with generators[k], in order."""
    from zeronotesamba_torch.train.supervised import train_step

    losses, outs = [], []
    for rows, gen in zip(torch.as_tensor(idx, device=bucket[0].device), generators):
        state, loss, out = train_step(state, *(t.index_select(0, rows) for t in bucket), gen, status)
        losses.append(loss)
        outs.append(out)
    return torch.stack(losses), torch.stack(outs)


def test_multistep_graph_equals_eager_steps(cuda):
    """K = 3 supervised steps of the twin (batch 2 x 128, dropout on) as one
    CUDA graph against three eager train_step calls from the same state,
    cuDNN deterministic: losses, outputs and parameters bit for bit at the
    capturing call and at a replay; the caller's generators end as the eager
    steps leave theirs; the replay captures nothing."""
    from zeronotesamba_torch.train.supervised import (
        SupervisedConfig, dropout_generator, init_state, make_multistep_train_step,
    )

    bucket = _bucket(cuda)
    cfg = SupervisedConfig(status="pretrained", lr=1e-3)
    step = make_multistep_train_step(cfg.status)
    idx = [np.array([[0, 3], [5, 1], [2, 4]]), np.array([[1, 2], [0, 5], [3, 3]])]
    with _deterministic_cudnn():
        graph, eager = init_state(cfg, None, 3, device=cuda), init_state(cfg, None, 3, device=cuda)
        for call, rows in enumerate(idx):
            before = profiling.totals("multistep.")
            gens = [dropout_generator(2, 3 * call + k, "cuda") for k in range(3)]
            graph, losses, outs = step(graph, *bucket, rows, gens)
            assert profiling.totals("multistep.") == {"captures": before["captures"] + (call == 0),
                                                      "replays": before["replays"] + 1}
            e_gens = [dropout_generator(2, 3 * call + k, "cuda") for k in range(3)]
            e_losses, e_outs = _eager_steps(eager, bucket, rows, e_gens, cfg.status)
            assert torch.equal(losses, e_losses) and torch.equal(outs, e_outs)
            assert all(torch.equal(g.get_state(), e.get_state()) for g, e in zip(gens, e_gens))
            assert all(torch.equal(a, b) for a, b in zip(graph.model.parameters(), eager.model.parameters()))
        assert graph.step == eager.step == 6 and len(graph.graphs) == 1


def test_multistep_pretext_graph_equals_eager_steps(cuda):
    """S = 2 calls of the k = 2 track step (batch 4 x 64 a track, dropout
    on) as one CUDA graph against two eager steps, cuDNN deterministic:
    losses, cosines and parameters bit for bit."""
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
    from zeronotesamba_torch.train.supervised import dropout_generator

    rng = np.random.default_rng(6)
    bank = torch.tensor((rng.standard_normal((4, 2, 96, 128)) * 4.0 - 6.0).astype(np.float32), device=cuda)
    tracks = np.array([[0, 2], [3, 1]])
    starts = rng.integers(0, 65, size=(2, 2, 4))
    cfg = PretextConfig(batch_size=4, crop_frames=64, lr=1e-4)
    with _deterministic_cudnn():
        graph, eager = init_pretext_state(cfg, 3, device=cuda), init_pretext_state(cfg, 3, device=cuda)
        for call in range(2):
            graph, *got = make_staged_train_step(cfg, steps_per_call=2)(
                graph, bank, tracks, starts, [dropout_generator(4, 2 * call + s, "cuda") for s in range(2)])
            for s in range(2):
                eager, *want = make_staged_train_step(cfg)(eager, bank, tracks[s], starts[s],
                                                           dropout_generator(4, 2 * call + s, "cuda"))
                assert [g[s].item() for g in got] == [w.item() for w in want]
            assert all(torch.equal(a, b) for a, b in zip(graph.model.parameters(), eager.model.parameters()))


def test_multistep_recaptures_after_load_state_dict(cuda, tmp_path):
    """A resume replaces the optimizer's state tensors: the next K-step call
    captures anew (it never replays the stale graph) and matches eager steps
    from the same checkpoint, bit for bit."""
    from zeronotesamba_torch.train.checkpoint import CheckpointManager
    from zeronotesamba_torch.train.supervised import SupervisedConfig, init_state, make_multistep_train_step

    bucket = _bucket(cuda, streams=1)
    cfg = SupervisedConfig(status="vanilla", lr=1e-3)
    step = make_multistep_train_step(cfg.status)
    idx = np.array([[0, 3], [5, 1]])
    mgr = CheckpointManager(str(tmp_path))
    with _deterministic_cudnn():
        state = init_state(cfg, None, 3, device=cuda)
        state, *_ = step(state, *bucket, idx, [None, None])
        mgr.save(0, state)
        state, *_ = step(state, *bucket, idx, [None, None])  # moves on from the checkpoint
        captures = profiling.totals("multistep.")["captures"]
        state = mgr.restore(state)
        assert state.optimizer.param_groups[0]["capturable"]
        state, losses, _ = step(state, *bucket, idx, [None, None])
        assert profiling.totals("multistep.")["captures"] == captures + 1
        eager = mgr.restore(init_state(cfg, None, 4, device=cuda))
        e_losses, _ = _eager_steps(eager, bucket, idx, (None, None), cfg.status)
        assert torch.equal(losses, e_losses)
        assert all(torch.equal(a, b) for a, b in zip(state.model.parameters(), eager.model.parameters()))


def test_a_capture_that_syncs_with_the_host_raises(cuda, monkeypatch):
    """A loss that reads a value to the host cannot be captured: the K-step
    call raises, and no eager step runs in its place (the step count and the
    parameters stay where they were). Last in this file: a failed capture
    may leave the process's allocator in its capture state."""
    from zeronotesamba_torch.train import supervised
    from zeronotesamba_torch.train.supervised import SupervisedConfig, init_state, make_multistep_train_step

    bce = supervised.masked_bce_logits

    def syncing(logits, *args):
        loss = bce(logits, *args)
        float(loss)  # a host read
        return loss

    monkeypatch.setattr(supervised, "masked_bce_logits", syncing)
    bucket = _bucket(cuda, streams=1)
    state = init_state(SupervisedConfig(status="vanilla", lr=1e-3), None, 3, device=cuda)
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(RuntimeError):
        make_multistep_train_step("vanilla")(state, *bucket, np.array([[0, 1], [2, 3]]), [None, None])
    assert state.step == 0 and not state.graphs
    assert all(torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
