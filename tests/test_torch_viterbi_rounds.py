"""The batched Viterbi kernel's round schedule, in numpy float32 and float64
(the kernel's two instances), against the plain frame loop bit for bit on
the CPU.

csrc/dbn_viterbi.cuh runs R = frames_per_round frames a round, between block
barriers (ops/cuda/dbn_kernel.py). ``round_schedule`` below writes that
schedule out as the kernel runs it: each chain a ring of slots whose values
never move, the diagonal of (state, frame) at position p living in slot
(L - 1 - p + frames done) mod L; per round, every diagonal walks until the
round ends or it reaches the chain's last state (its value there is the tail
that frame r of the round reads), then the R x n_int tempo maxima over each
column's band of finite rows, then each new diagonal takes its head value
and its predecessor's slot and walks to the round's end; each frame's best
state is the first maximum over all the diagonals. Every value is made by the plain loop's adds in the plain loop's
order, so the schedule must equal ``viterbi_forward_plain`` exactly; a fault
in it shows here before any card time is spent. The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py).
"""

import math
import os

import numpy as np
import pytest
import torch

from zeronotesamba_torch.decode import dbn_device
from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, _state_space
from zeronotesamba_torch.ops.cuda import dbn_kernel

torch.set_num_threads(2)


def round_schedule(la: np.ndarray, lna: np.ndarray, log_trans, firsts, lasts, is_beat, n_rounds: int):
    """The kernel's schedule for (B, T) float32 or float64 observation
    log-probs, rounds of ``n_rounds`` frames -> (v_final, fc, best) as numpy
    arrays, the scores in the observations' dtype."""
    dt = la.dtype
    log_trans = np.asarray(log_trans, dt)
    firsts, lasts = np.asarray(firsts, np.int64), np.asarray(lasts, np.int64)
    beat = np.asarray(is_beat, bool)
    batch, n_frames = la.shape
    n_int, n_states = firsts.size, beat.size
    length = lasts - firsts + 1
    assert 1 <= n_rounds <= length.min()
    lo, hi = dbn_kernel.transition_bands(log_trans)
    chain = np.repeat(np.arange(n_int), length)  # each state's chain
    first, size = firsts[chain], length[chain]
    pos = np.arange(n_states) - first  # each state's position in its chain
    v0 = np.float32(-np.log(float(n_states))) if dt == np.float32 else -math.log(n_states)
    ring = np.full((batch, n_states), v0, dt)
    off = np.zeros(n_int, np.int64)  # frames done so far, mod each chain's length
    fc = np.empty((batch, n_frames, n_int), np.int16)
    best = np.empty((batch, n_frames), np.int32)
    for t0 in range(0, n_frames, n_rounds):
        n_r = min(n_rounds, n_frames - t0)
        obs = [np.where(beat[None], la[:, t0 + m, None], lna[:, t0 + m, None]) for m in range(n_r)]  # (B, S) each
        frame_v = np.full((n_r, batch, n_states), np.nan, dt)  # V at frame t0 + m, by state
        # The diagonal at position p keeps its ring slot; the one born at frame
        # r takes the slot of the one that frame r read as a tail.
        slot = first + (size - 1 - pos + off[chain]) % size
        r_out = size - 1 - pos  # the frame (in the round) that reads it as a tail
        leaving = r_out < n_r
        # A. Walk each diagonal until the round ends or it reaches its chain's last state.
        v = ring[:, slot]
        for m in range(n_r):
            walk = m < r_out
            state = first + pos + m + 1
            v = np.where(walk[None], v + obs[m][:, np.where(walk, state, 0)], v)
            frame_v[m][:, state[walk]] = v[:, walk]
        tail = np.full((batch, n_r, n_int), np.nan, dt)
        tail[:, r_out[leaving], chain[leaving]] = v[:, leaving]
        # B. The tempo maxima: over each column's band of finite rows, from
        # (-inf, row 0) with a strict >: the first maximum, or row 0 if all are -inf.
        head = np.empty((batch, n_r, n_int), dt)
        for r in range(n_r):
            bv = np.full((batch, n_int), -np.inf, dt)
            bi = np.zeros((batch, n_int), np.int64)
            for i in range(n_int):
                c = tail[:, r, i, None] + log_trans[i][None]
                take = ((lo <= i) & (i <= hi))[None] & (c > bv)
                bv, bi = np.where(take, c, bv), np.where(take, i, bi)
            fc[:, t0 + r] = bi
            head[:, r] = bv + obs[r][:, firsts]
        # C. The new diagonals: from the head of frame r to the round's end.
        v = np.where(leaving[None], np.nan, v).astype(dt)
        for m in range(n_r):
            born = leaving & (r_out == m)
            v[:, born] = head[:, m, chain[born]]
            walk = leaving & (r_out < m)
            state = first + m - r_out
            v = np.where(walk[None], v + obs[m][:, np.where(walk, state, 0)], v)
            on = leaving & (r_out <= m)
            frame_v[m][:, state[on]] = v[:, on]
        ring[:, slot] = v
        off = (off + n_r) % length
        assert not np.isnan(frame_v).any()  # every state of every frame is on one diagonal
        for m in range(n_r):
            best[:, t0 + m] = frame_v[m].argmax(axis=1)  # numpy's argmax: the lowest state among ties
    return ring[:, first + (size - 1 - pos + off[chain]) % size], fc, best


def _assert_equals_plain(la: np.ndarray, lna: np.ndarray, space: dbn_kernel.ViterbiSpace, n_rounds: int):
    got = round_schedule(la, lna, space.log_trans.numpy(), space.firsts.numpy(), space.lasts.numpy(),
                         space.is_beat.numpy(), n_rounds)
    ref = [x.numpy() for x in dbn_kernel.viterbi_forward_plain(torch.tensor(la), torch.tensor(lna), space)]
    bits = np.int32 if la.dtype == np.float32 else np.int64
    for what, g, r in zip(("v_final", "fc", "best"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, what
        np.testing.assert_array_equal(g.view(bits) if what == "v_final" else g,
                                      r.view(bits) if what == "v_final" else r, err_msg=what)


def _hand_space(lengths, seed, dtype=torch.float32):
    """A space of chains of the given lengths with random log_trans (about a
    third -inf, values on a coarse grid so that ties happen) and a random
    is_beat, through viterbi_space, with scores of ``dtype``. Column n // 2 is all -inf, so its chain's
    values turn -inf once its start drains; the next column's only finite
    row is that chain, so its band's candidates all turn -inf too."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    lasts = np.cumsum(lengths) - 1
    firsts = lasts - lengths + 1
    n = lengths.size
    log_trans = -rng.integers(0, 4, (n, n)).astype(np.float64) / 4
    log_trans[rng.random((n, n)) < 0.3] = -np.inf
    np.fill_diagonal(log_trans, -0.25)
    log_trans[:, n // 2] = -np.inf
    log_trans[:, n // 2 + 1] = -np.inf
    log_trans[n // 2, n // 2 + 1] = -0.5
    is_beat = rng.random(int(lengths.sum())) < 0.3
    return dbn_kernel.viterbi_space(log_trans, firsts, lasts, is_beat, "cpu", dtype)


def _grid_obs(rng, batch, n_frames, dtype=np.float32):
    """Observation log-probs on a grid of quarters: float32 sums stay exact, so ties are common."""
    return tuple((-rng.integers(1, 8, (batch, n_frames)) / 4).astype(dtype) for _ in range(2))


def _golden(dtype):
    gold = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "dbn_golden.npz"))
    acts = [gold[k].astype(np.float64) for k in ("act_clean_bpm120", "act_ramp_70_140", "act_noise_only",
                                                   "act_short_3s")]
    acts += [np.full(1, 0.5), np.zeros(0)]
    t_pad = max(len(a) for a in acts)
    masked = np.stack([np.pad(a, (0, t_pad - len(a))) for a in acts])
    cfg = DBNBeatDecoderConfig()
    la, lna = (x.astype(dtype) for x in dbn_device._observations(masked, cfg))
    return la, lna, dbn_device._space(cfg, torch.device("cpu"), torch.float32 if dtype == np.float32 else torch.float64)


# The float64 forward pass's cases against the host C++ DBN (here and in
# tests/test_torch_decode.py on the CPU, tests/test_torch_cuda.py on a card).
F64_CASES = ["random", "bpm60", "bpm120", "bpm200", "zeros", "constant", "one_frame", "frames16", "frames35",
             "frames103"]


def _spikes(bpm, seconds, seed=0):
    """A spike train at ``bpm`` over half-normal noise, 62.5 frames a second."""
    rng = np.random.default_rng(seed)
    act = np.abs(0.05 * rng.standard_normal(int(seconds * 62.5)))
    act[5:-2:int(round(60.0 / bpm * 62.5))] = 0.9
    return np.clip(act, 0, 1)


def f64_case(name):
    """Activations of case ``name``: seeded random values over a 30 s song's
    1,876 frames, spike trains at 60, 120 and 200 BPM, tie-heavy all-zero and
    constant rows, one frame, 16 frames and lengths that are not a multiple
    of the kernel's 17-frame round."""
    rng = np.random.default_rng(11)
    return {"random": lambda: rng.random(1876), "bpm60": lambda: _spikes(60, 6.0),
            "bpm120": lambda: _spikes(120, 6.0), "bpm200": lambda: _spikes(200, 6.0, seed=3),
            "zeros": lambda: np.zeros(200), "constant": lambda: np.full(200, 0.3),
            "one_frame": lambda: np.full(1, 0.7), "frames16": lambda: rng.random(16),
            "frames35": lambda: _spikes(150, 0.56), "frames103": lambda: rng.random(103)}[name]()


@pytest.fixture(scope="module")
def golden_batch():
    return _golden(np.float32)


def test_frames_per_round_of_the_default_space():
    intervals, firsts, lasts, _, _, log_trans, is_beat = _state_space(DBNBeatDecoderConfig())
    assert intervals.min() == 17 and dbn_kernel.frames_per_round(firsts, lasts) == 17
    assert dbn_kernel.viterbi_space(log_trans, firsts, lasts, is_beat, "cpu").frames_per_round == 17


@pytest.mark.parametrize("lengths,expected", [
    ((3, 1, 4, 2), 1), ((2, 5, 3), 2), ((4, 3, 6, 5), 3), ((5, 7, 5), 4), ((7, 9, 8), 6), ((11, 30), 8),
    ((16, 20), 16), ((18, 40), 17), ((40, 50), 24),
])
def test_frames_per_round_is_the_shortest_chain_rounded_down(lengths, expected):
    lasts = np.cumsum(lengths) - 1
    firsts = lasts - np.asarray(lengths) + 1
    assert dbn_kernel.frames_per_round(firsts, lasts) == expected
    assert expected in dbn_kernel.ROUND_FRAMES and expected <= min(lengths)


def test_transition_bands():
    lt = np.array([[0.0, -np.inf, -np.inf], [-1.0, -np.inf, -2.0], [-np.inf, -np.inf, -1.0]])
    lo, hi = dbn_kernel.transition_bands(lt)
    assert lo.dtype == hi.dtype == np.int32
    assert lo.tolist() == [0, 0, 1] and hi.tolist() == [1, -1, 2]
    with pytest.raises(ValueError, match="log-probabilities"):
        dbn_kernel.viterbi_space(np.full((1, 1), np.nan), [0], [2], np.zeros(3), "cpu")


@pytest.mark.parametrize("n_rounds,dtype", [(17, np.float32), (16, np.float32), (5, np.float32), (1, np.float32),
                                            (17, np.float64), (5, np.float64)],
                         ids=["17", "16", "5", "1", "17-float64", "5-float64"])
def test_default_space_on_a_ragged_golden_batch(golden_batch, n_rounds, dtype):
    """Four golden songs, a one-frame song and an empty one, zero-padded to
    1,062 frames (not a multiple of 17, 16 or 5), at R = 17 and smaller; in
    float32 and in float64 (the host C++ DBN's scores and start)."""
    la, lna, space = golden_batch if dtype == np.float32 else _golden(dtype)
    _assert_equals_plain(la, lna, space, n_rounds)


HAND_LENGTHS = [(3, 1, 4, 2), (2, 5, 3, 2), (4, 3, 6, 5)]


@pytest.mark.parametrize("n_frames", [0, 1, 2, 3, 4, 7, 17, 41])
@pytest.mark.parametrize("lengths,dtype", [(c, t) for t in (np.float32, np.float64) for c in HAND_LENGTHS],
                         ids=[f"lengths{k}" for k in range(3)] + [f"lengths{k}-float64" for k in range(3)])
def test_hand_made_spaces(lengths, dtype, n_frames):
    """Chains with a shortest length of 1, 2 and 3 (R = 1, 2, 3): T = 0, one
    frame, T < R, T = R, and T not a multiple of R, with ties everywhere; in
    float32 and in float64."""
    space = _hand_space(lengths, seed=sum(lengths) + n_frames,
                        dtype=torch.float32 if dtype == np.float32 else torch.float64)
    n_rounds = dbn_kernel.frames_per_round(space.firsts.numpy(), space.lasts.numpy())
    assert n_rounds == min(lengths)
    la, lna = _grid_obs(np.random.default_rng(n_frames), 3, n_frames, dtype)
    _assert_equals_plain(la, lna, space, n_rounds)


def test_short_song_in_the_default_space(golden_batch):
    """T < R in the default space: one partial round of 5 frames."""
    la, lna, space = golden_batch
    _assert_equals_plain(la[:, :5], lna[:, :5], space, space.frames_per_round)
