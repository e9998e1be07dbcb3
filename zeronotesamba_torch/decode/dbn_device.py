"""Batched DBN beat decoding on the card (the Viterbi forward pass in one kernel launch).

Port of zeronotesamba_tpu/decode/dbn_jax.py. The forward max-product
recursion of a whole padded batch runs in float32 on ``device``: one launch
of csrc/dbn_viterbi.cuh's kernel on a card, its plain PyTorch version on the CPU
(ops/cuda/dbn_kernel.py). Only the (T, n_intervals) tempo choices and each
frame's best state return to the host, which backtracks every song from ITS
final valid frame (in C++, the native DBN's own backtrack), so a batched
decode equals a per-song decode of the unpadded activation. The observation log-probs are computed in float64 on
the host, as the JAX code does, and cast to float32. Both decode functions
can report their two stages' seconds in ``stage_s``: ``forward_s`` (the
observations, the forward pass and the copy back) and ``backtrack_s`` (the
host backtrack and the beat picking).

``viterbi_path_f64`` is the offline DBN's Viterbi with its forward pass on a
card (decode_beats with a CUDA ``device``): one song in float64, the host
C++'s own adds, backtracked by the C++'s own backtrack, so its path is the
host C++'s bit for bit.
"""

from __future__ import annotations

import functools
import time
from typing import List, Sequence

import numpy as np
import torch

from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, _beats, _observations, _state_space
from zeronotesamba_torch.decode.dbn_native import backtrack_native
from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.ops.cuda.dbn_kernel import ViterbiSpace, viterbi_forward, viterbi_space
from zeronotesamba_torch.utils import profiling


@functools.lru_cache(maxsize=8)
def _space(cfg: DBNBeatDecoderConfig, device: torch.device, dtype: torch.dtype = torch.float32) -> ViterbiSpace:
    _, firsts, lasts, _, _, log_trans, is_beat = _state_space(cfg)
    return viterbi_space(log_trans, firsts, lasts, is_beat, device, dtype)


def viterbi_path_f64(log_act: np.ndarray, log_nact: np.ndarray, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig(),
                     *, device: str | torch.device) -> np.ndarray:
    """The state path (int64, one per frame) of one song's (T,) float64
    observation log-probs, as decode_beats computes them: they go to
    ``device`` in one copy, the float64 forward pass runs there (one kernel
    launch on a card, its plain version on the CPU), the tempo choices and
    the best final state come back in one copy, and the native library
    backtracks. Equal to viterbi_native's path bit for bit."""
    dev = torch.device(device)
    space = _space(cfg, dev, torch.float64)
    obs = profiling.to_device(np.stack((log_act, log_nact)), dev)
    _, fc, best = viterbi_forward(obs[0:1], obs[1:2], space)
    # fc and the last frame's best state (its int32 as two int16) in one copy.
    out = profiling.to_host(torch.cat((fc.view(-1), best[0, -1:].view(torch.int16))))
    return _backtrack(int(out[fc.numel():].view(np.int32)[0]), out[:fc.numel()].reshape(fc.shape[1:]), cfg)


def viterbi_forward_device(log_act: np.ndarray, log_nact: np.ndarray,
                           cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig(), *, device: str | torch.device = "cuda"):
    """(B, T) float64 observation log-probs -> numpy (v_final (B, S) float32,
    fc (B, T, n_int) int16, best (B, T) int32), computed on ``device``."""
    dev = resolve_device(device)
    la, lna = (torch.tensor(np.asarray(x, np.float64).astype(np.float32), device=dev) for x in (log_act, log_nact))
    v_final, fc, best = viterbi_forward(la, lna, _space(cfg, dev))
    return v_final.cpu().numpy(), fc.cpu().numpy(), best.cpu().numpy()


def _backtrack(start_state: int, fcs: np.ndarray, cfg: DBNBeatDecoderConfig) -> np.ndarray:
    """The state path from ``start_state`` at the last frame through the
    (T, n_int) tempo choices: the C++ backtrack (dbn_native.backtrack_native)."""
    _, firsts, lasts, _, _, _, is_beat = _state_space(cfg)
    return backtrack_native(fcs, start_state, firsts, lasts, is_beat.size)


def viterbi_path_device(activations: np.ndarray, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig(), *,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Device forward pass + host backtrack -> state path (T,)."""
    act = np.asarray(activations, dtype=np.float64).ravel()
    log_act, log_nact = _observations(act, cfg)
    v_final, fcs, _ = viterbi_forward_device(log_act[None], log_nact[None], cfg, device=device)
    return _backtrack(int(np.argmax(v_final[0])), fcs[0], cfg)


def decode_beats_device(activations: np.ndarray, cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig(), *,
                        device: str | torch.device = "cuda", stage_s: dict | None = None) -> np.ndarray:
    """Beat times via the device Viterbi (equivalent to decode_beats)."""
    act = np.asarray(activations, dtype=np.float64).ravel()
    if act.size == 0:
        return np.empty(0)
    t0 = time.perf_counter()
    log_act, log_nact = _observations(act, cfg)
    v_final, fcs, _ = viterbi_forward_device(log_act[None], log_nact[None], cfg, device=device)
    t1 = time.perf_counter()
    beats = _beats(_backtrack(int(np.argmax(v_final[0])), fcs[0], cfg), act, cfg)
    if stage_s is not None:
        stage_s.update(forward_s=t1 - t0, backtrack_s=time.perf_counter() - t1)
    return beats


def decode_beats_batch_device(
    activations: np.ndarray,
    n_frames: Sequence[int],
    cfg: DBNBeatDecoderConfig = DBNBeatDecoderConfig(),
    *,
    device: str | torch.device = "cuda",
    stage_s: dict | None = None,
) -> List[np.ndarray]:
    """Batched decode: (B, T_pad) activations + per-song valid lengths.

    Frames past a song's length are masked to 0, the whole batch runs one
    forward pass, and each song backtracks from the best state at its own
    final valid frame over fc[:nf], which makes the result exactly equal to a
    per-song decode of the unpadded activation."""
    t0 = time.perf_counter()
    acts = np.asarray(activations, dtype=np.float64)
    masked = acts.copy()
    for b, nf in enumerate(n_frames):
        masked[b, nf:] = 0.0
    log_act, log_nact = _observations(masked, cfg)
    _, fcs, bests = viterbi_forward_device(log_act, log_nact, cfg, device=device)
    t1 = time.perf_counter()
    out = []
    for b, nf in enumerate(n_frames):
        if nf <= 0:
            # Guard: bests[b, -1] would backtrack from the last PADDED frame.
            out.append(np.zeros(0, dtype=np.float64))
            continue
        path = _backtrack(int(bests[b, nf - 1]), fcs[b, :nf], cfg)
        out.append(_beats(path, masked[b, :nf], cfg))
    if stage_s is not None:
        stage_s.update(forward_s=t1 - t0, backtrack_s=time.perf_counter() - t1)
    return out
