"""The batched DBN Viterbi's Hopper kernel, its plain version, and the wrapper.

Counterpart of zeronotesamba_tpu/decode/dbn_jax.py::_viterbi_scan under
``vmap``: the max-product recursion over the beat state space for every song
of a padded batch, in float32, returning the final scores, each frame's
tempo choices into the chain heads and each frame's best state. A float64
space (``viterbi_space(..., dtype=torch.float64)``) runs the same recursion
in float64, the host C++ DBN's own adds (decode/dbn_device.viterbi_path_f64);
the observations' dtype picks the kernel's instance (csrc/dbn_viterbi.cu or
csrc/dbn_viterbi_f64.cu, both of csrc/dbn_viterbi.cuh's kernel).
``viterbi_forward`` launches it (one launch a batch, the frame loop inside
the kernel) for CUDA tensors and runs the plain version, a loop over frames
of (batch, n_states) tensor operations, for CPU tensors;
there is no fallback between the two. ``profiling.totals("dbn_launch.")``
counts kernel launches.

The kernel runs the frames in rounds of R = ``frames_per_round(firsts,
lasts)``: the largest of ``ROUND_FRAMES`` (the round lengths it is compiled
for) that is at most the shortest chain's length, 17 for the default state
space (60 * 62.5 / 215 frames), 1 for a space with a one-state chain. Frame t
reads the last state of each chain, a value that entered the chain's head L
frames before; with R <= every L, the R frames of a round read only values
that exist at the round's start, so three block barriers serve R frames.
``transition_bands`` gives each tempo column's rows of finite log-probability:
a candidate from outside it is -inf and never the first maximum unless every
candidate is, in which case the choice is row 0. Neither changes a value:
the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from zeronotesamba_torch.utils import profiling

profiling.count("dbn_launch.viterbi", 0)
# The round lengths csrc/dbn_viterbi.cuh is instantiated for (the cases of dispatch's switch).
ROUND_FRAMES = (1, 2, 3, 4, 6, 8, 12, 16, 17, 24)
# The float64 instance's block (at most 384 threads: its scores take twice the registers).
F64_THREADS = 384


def frames_per_round(firsts: np.ndarray, lasts: np.ndarray) -> int:
    """R for a state space: the largest of ROUND_FRAMES that is at most the
    shortest chain's length (lasts[i] - firsts[i] + 1)."""
    shortest = int(np.min(np.asarray(lasts, np.int64) - np.asarray(firsts, np.int64))) + 1
    return max(r for r in ROUND_FRAMES if r <= shortest)


def transition_bands(log_trans: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per tempo column j, the first and last row i with log_trans[i, j] >
    -inf, as int32 (lo, hi); (0, -1) for a column with none."""
    finite = np.asarray(log_trans) > -np.inf
    n = finite.shape[0]
    any_row = finite.any(axis=0)
    lo = np.where(any_row, finite.argmax(axis=0), 0)
    hi = np.where(any_row, n - 1 - finite[::-1].argmax(axis=0), -1)
    return lo.astype(np.int32), hi.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ViterbiSpace:
    """A beat state space as tensors on one device: ``n_int`` chains of
    consecutive states, chain i from ``firsts[i]`` to ``lasts[i]``."""

    log_trans: torch.Tensor  # (n_int, n_int) float32 or float64 (the score type), from-major
    firsts: torch.Tensor  # (n_int,) int32
    lasts: torch.Tensor  # (n_int,) int32
    is_beat: torch.Tensor  # (n_states,) uint8
    v0: float  # the initial score of every state (a value of the score type)
    band_lo: torch.Tensor  # (n_int,) int32, transition_bands
    band_hi: torch.Tensor  # (n_int,) int32
    frames_per_round: int  # R, frames_per_round

    @property
    def dtype(self) -> torch.dtype:
        return self.log_trans.dtype

    @property
    def n_int(self) -> int:
        return self.firsts.numel()

    @property
    def n_states(self) -> int:
        return self.is_beat.numel()


def viterbi_space(log_trans: np.ndarray, firsts: np.ndarray, lasts: np.ndarray, is_beat: np.ndarray,
                  device: str | torch.device, dtype: torch.dtype = torch.float32) -> ViterbiSpace:
    """Check the chain layout the kernel relies on and put the state space on
    ``device`` with scores of ``dtype``: float32, ``log_trans`` cast to it
    and the uniform start -log(n_states) rounded to it, as the JAX scan
    starts; or float64, both as the host C++ DBN starts (its
    ``-std::log(n_states)``: ``math.log`` calls the same C library)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the score type must be float32 or float64, got {dtype}")
    firsts, lasts = np.asarray(firsts, np.int64), np.asarray(lasts, np.int64)
    n_int, n_states = firsts.size, np.asarray(is_beat).size
    if (n_int < 1 or lasts.shape != firsts.shape or np.shape(log_trans) != (n_int, n_int) or firsts[0] != 0
            or lasts[-1] != n_states - 1 or not np.array_equal(firsts[1:], lasts[:-1] + 1)
            or np.any(lasts < firsts)):
        raise ValueError("the state space must be n_int chains of consecutive states, in order, covering every state")
    log_trans = np.asarray(log_trans, np.float32 if dtype == torch.float32 else np.float64)
    if np.isnan(log_trans).any() or (log_trans == np.inf).any():
        raise ValueError("log_trans must hold log-probabilities: finite values or -inf")
    lo, hi = transition_bands(log_trans)
    return ViterbiSpace(
        log_trans=torch.tensor(log_trans, device=device),
        firsts=torch.tensor(firsts, dtype=torch.int32, device=device),
        lasts=torch.tensor(lasts, dtype=torch.int32, device=device),
        is_beat=torch.tensor(np.asarray(is_beat, np.uint8), device=device),
        v0=float(np.float32(-np.log(float(n_states)))) if dtype == torch.float32 else -math.log(n_states),
        band_lo=torch.tensor(lo, device=device),
        band_hi=torch.tensor(hi, device=device),
        frames_per_round=frames_per_round(firsts, lasts),
    )


def viterbi_forward_plain(log_act: torch.Tensor, log_nact: torch.Tensor, space: ViterbiSpace):
    """The kernel's plain version: (B, T) observation log-probs of the
    space's dtype -> (v_final (B, n_states) of that dtype, fc (B, T, n_int)
    int16, best (B, T) int32)."""
    batch, n_frames = log_act.shape
    dev = log_act.device
    firsts, lasts = space.firsts.long(), space.lasts.long()
    beat = space.is_beat.bool()
    v = torch.full((batch, space.n_states), space.v0, dtype=space.dtype, device=dev)
    fc = torch.empty((batch, n_frames, space.n_int), dtype=torch.int16, device=dev)
    best = torch.empty((batch, n_frames), dtype=torch.int32, device=dev)
    for t in range(n_frames):
        cand = v[:, lasts, None] + space.log_trans  # (B, from, to)
        fc[:, t] = cand.argmax(dim=1)
        v_new = torch.roll(v, 1, dims=1)
        v_new[:, firsts] = cand.amax(dim=1)
        v = v_new + torch.where(beat, log_act[:, t, None], log_nact[:, t, None])
        best[:, t] = v.argmax(dim=1)
    return v, fc, best


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype) -> ctypes._CFuncPtr:
    """The C entry of the kernel's instance for scores of ``dtype``."""
    from zeronotesamba_torch.ops.cuda.build import load

    fn, v0 = (load("dbn_viterbi").zns_dbn_viterbi, ctypes.c_float) if dtype == torch.float32 else \
        (load("dbn_viterbi_f64").zns_dbn_viterbi_f64, ctypes.c_double)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, i64, i64, p, p, p, p, p, i32, p, i32, v0, i32, i32, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _viterbi_forward_cuda(log_act: torch.Tensor, log_nact: torch.Tensor, space: ViterbiSpace, threads: int = 0):
    """One launch; ``threads`` a block (a multiple of 32 from 64 to 512, to
    384 in float64), or 0: in float32 512 where the batch leaves SMs idle
    (fewer songs than twice the card's SMs), else 256, as chip_smoke.py's
    sweep of the decode shapes found fastest; in float64 F64_THREADS."""
    batch, n_frames = log_act.shape
    dev = log_act.device
    if threads == 0:
        if space.dtype == torch.float64:
            threads = F64_THREADS
        else:
            threads = 512 if batch < 2 * _sm_count(dev) else 256
    v_final = torch.empty((batch, space.n_states), dtype=space.dtype, device=dev)
    fc = torch.empty((batch, n_frames, space.n_int), dtype=torch.int16, device=dev)
    best = torch.empty((batch, n_frames), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(space.dtype)(log_act.data_ptr(), log_nact.data_ptr(), batch, n_frames, space.log_trans.data_ptr(),
                       space.firsts.data_ptr(), space.lasts.data_ptr(), space.band_lo.data_ptr(),
                       space.band_hi.data_ptr(), space.n_int, space.is_beat.data_ptr(), space.n_states, space.v0,
                       space.frames_per_round, threads, v_final.data_ptr(), fc.data_ptr(), best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dbn_viterbi kernel launch failed: CUDA error {err}")
    profiling.count("dbn_launch.viterbi")
    return v_final, fc, best


def viterbi_forward(log_act: torch.Tensor, log_nact: torch.Tensor, space: ViterbiSpace):
    """The Viterbi forward pass of a padded batch: (B, T) log_act and
    log_nact of the space's dtype (float32 or float64) -> (v_final
    (B, n_states) of that dtype, fc (B, T, n_int) int16, best (B, T) int32);
    see viterbi_forward_plain. One kernel launch for CUDA tensors, the plain
    version for CPU tensors."""
    for name, t in (("log_act", log_act), ("log_nact", log_nact)):
        if t.dtype != space.dtype or t.ndim != 2:
            raise TypeError(f"{name} must be a (batch, frames) {space.dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    if log_act.shape != log_nact.shape:
        raise ValueError(f"log_act {tuple(log_act.shape)} and log_nact {tuple(log_nact.shape)} differ")
    if not log_act.device == log_nact.device == space.log_trans.device:
        raise ValueError("log_act, log_nact and the state space must be on one device")
    if not log_act.is_cuda or log_act.shape[0] == 0:  # a batch of no songs launches nothing
        return viterbi_forward_plain(log_act, log_nact, space)
    return _viterbi_forward_cuda(log_act.contiguous(), log_nact.contiguous(), space)
