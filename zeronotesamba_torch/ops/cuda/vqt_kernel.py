"""The log-VQT's two Hopper kernels, their plain versions, and the wrapper.

Counterpart of zeronotesamba_tpu/ops/pallas/vqt_kernel.py:

- ``decimation_cascade``: all half-band decimation levels in one launch
  (csrc/vqt_cascade.cu, replaces ``_cascade_kernel``);
- ``octave_log_xqt``: one octave's framing + filterbank + magnitude + log,
  written into the final (B, 96, T) output (csrc/vqt_octave.cu, replaces
  ``_octave_kernel``);
- ``log_xqt_fused``: the host orchestration of ``log_xqt_pallas``
  (fused_cascade=True): pads, per-octave offsets and hops, octave order.

Each kernel function takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; there is no fallback between the two.
``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from zeronotesamba_torch.ops.filterbank import XQTParams, halfband_decimation_filter, octave_banks_f32

LAUNCHES = {"cascade": 0, "octave": 0}

TAPS = 81
HALF = TAPS // 2
MAX_LEVELS = 7
WINDOW = 256  # frame length the octave kernel is written for
BPO = 12  # bins per octave the octave kernel is written for
CASCADE_ALIGN = 256  # the cascade input is zero-filled to a multiple of this


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=8)
def halfband_taps(device: torch.device) -> torch.Tensor:
    """The 81 half-band taps, float32 on ``device``."""
    return torch.tensor(halfband_decimation_filter(), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def octave_banks(params: XQTParams, device: torch.device) -> torch.Tensor:
    """(n_octaves, window_len, 2*bpo) float32 [cos | sin] banks on ``device``."""
    return torch.tensor(octave_banks_f32(params), device=device)


@functools.lru_cache(maxsize=None)
def _entry(source: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A C entry of the library built from csrc/<source>.cu, with its signature."""
    from zeronotesamba_torch.ops.cuda.build import load

    fn = getattr(load(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_CASCADE_ARGS = (_P, _P, _P, _I64, _I64, _I32, _I64, _P)
_OCTAVE_ARGS = (_P, _I64, _I64, _I32, _I32, _I64, _P, _P, _I64, _I32, ctypes.c_float, _P)


# --------------------------------------------------------------------------
# Kernel 1: decimation cascade
# --------------------------------------------------------------------------


def decimation_cascade_plain(x: torch.Tensor, n_levels: int) -> Tuple[torch.Tensor, ...]:
    """(B, L) -> levels 1..n_levels, (B, L >> s): a loop of zero pad 40 +
    stride-2 conv with the 81 taps, in float32."""
    w = halfband_taps(x.device)[None, None, :]
    levels = []
    h = x[:, None, :]
    for _ in range(n_levels):
        h = F.conv1d(F.pad(h, (HALF, HALF)), w, stride=2)
        levels.append(h[:, 0, :])
    return tuple(levels)


def _decimation_cascade_cuda(x: torch.Tensor, n_levels: int) -> Tuple[torch.Tensor, ...]:
    b, length = x.shape
    lens = [length >> s for s in range(1, n_levels + 1)]
    out = torch.empty((b, sum(lens)), dtype=torch.float32, device=x.device)
    fn = _entry("vqt_cascade", "zns_cascade", _CASCADE_ARGS)
    taps = halfband_taps(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), taps.data_ptr(), b, length, n_levels, out.stride(0), stream)
    _raise_on(err, "cascade kernel")
    LAUNCHES["cascade"] += 1
    return tuple(torch.split(out, lens, dim=1))


def decimation_cascade(x: torch.Tensor, n_levels: int = MAX_LEVELS) -> Tuple[torch.Tensor, ...]:
    """(B, L) float32 -> tuple of (B, L >> s) levels, s = 1..n_levels.

    Level s+1 is the 81-tap half-band filter at stride 2 over level s, with
    samples outside each level read as zero. ``L`` must be a multiple of 256.
    The levels of the CUDA kernel are views of one packed buffer.
    """
    _check(x, "x", 2)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels must be in 1..{MAX_LEVELS}")
    if x.shape[1] % CASCADE_ALIGN != 0:
        raise ValueError(f"cascade input length must be a multiple of {CASCADE_ALIGN}")
    if not x.is_cuda:
        return decimation_cascade_plain(x, n_levels)
    if not x.is_contiguous():
        raise ValueError("cascade input must be contiguous")
    return _decimation_cascade_cuda(x, n_levels)


# --------------------------------------------------------------------------
# Kernel 2: one octave -> log magnitudes
# --------------------------------------------------------------------------


def octave_log_xqt_plain(
    level: torch.Tensor, bank: torch.Tensor, out: torch.Tensor, *, row: int, offset: int, hop: int, log_eps: float
) -> None:
    """Explicit framing (unfold) @ bank, magnitude and log, in float32,
    written into ``out[:, row : row + bpo, :]``."""
    n_frames = out.shape[2]
    w = bank.shape[0]
    bpo = bank.shape[1] // 2
    frames = level[:, offset : offset + (n_frames - 1) * hop + w].unfold(1, w, hop)  # (B, T, w)
    resp = torch.matmul(frames, bank)  # (B, T, 2*bpo)
    mag = torch.sqrt(resp[..., :bpo] ** 2 + resp[..., bpo:] ** 2 + 1e-30)
    out[:, row : row + bpo, :] = torch.log(mag + log_eps).transpose(1, 2)


def _octave_log_xqt_cuda(
    level: torch.Tensor, bank: torch.Tensor, out: torch.Tensor, *, row: int, offset: int, hop: int, log_eps: float
) -> None:
    fn = _entry("vqt_octave", "zns_octave", _OCTAVE_ARGS)
    with torch.cuda.device(level.device):
        stream = torch.cuda.current_stream(level.device).cuda_stream
        err = fn(
            level.data_ptr(), level.stride(0), offset, hop, out.shape[2], out.shape[0],
            bank.data_ptr(), out.data_ptr(), out.stride(0), row, log_eps, stream,
        )
    _raise_on(err, "octave kernel")
    LAUNCHES["octave"] += 1


def octave_log_xqt(
    level: torch.Tensor, bank: torch.Tensor, out: torch.Tensor, *, row: int, offset: int, hop: int, log_eps: float
) -> None:
    """One octave's log magnitudes into ``out[:, row : row + 12, :]``.

    level: (B, L) float32 signal at the octave's rate; frame t covers
    ``level[:, offset + t*hop : offset + t*hop + 256]``.
    bank: (256, 24) float32 [cos | sin]. out: (B, n_bins, T) float32.
    """
    _check(level, "level", 2)
    _check(bank, "bank", 2)
    _check(out, "out", 3)
    n_frames = out.shape[2]
    if tuple(bank.shape) != (WINDOW, 2 * BPO):
        raise ValueError(f"bank must be ({WINDOW}, {2 * BPO}), got {tuple(bank.shape)}")
    if out.shape[0] != level.shape[0] or not 0 <= row <= out.shape[1] - BPO:
        raise ValueError(f"out {tuple(out.shape)} does not fit level {tuple(level.shape)} at row {row}")
    if offset < 0 or offset + (n_frames - 1) * hop + WINDOW > level.shape[1]:
        raise ValueError("frames run past the level signal")
    if not level.device == bank.device == out.device:
        raise ValueError("level, bank and out must be on one device")
    if not level.is_cuda:
        octave_log_xqt_plain(level, bank, out, row=row, offset=offset, hop=hop, log_eps=log_eps)
        return
    if level.stride(1) != 1 or not bank.is_contiguous() or not out.is_contiguous():
        raise ValueError("octave kernel needs unit-stride level rows, a contiguous bank and out")
    if not 1 <= hop <= WINDOW:
        raise ValueError(f"octave kernel hop must be in 1..{WINDOW}")
    _octave_log_xqt_cuda(level, bank, out, row=row, offset=offset, hop=hop, log_eps=log_eps)


# --------------------------------------------------------------------------
# Wrapper: log_xqt_pallas(fused_cascade=True) as host orchestration
# --------------------------------------------------------------------------


def _pad2(params: XQTParams) -> int:
    """Twice the plain path's full-rate reflect pad."""
    return 2 * ((params.window_len // 2 + 1) << (params.n_octaves - 1))


def cascade_input(y: torch.Tensor, params: XQTParams = XQTParams()) -> torch.Tensor:
    """(B, L) -> the cascade's input: reflect-padded by ``_pad2`` at full rate,
    then zero-filled to a multiple of 256, contiguous float32."""
    from zeronotesamba_torch.ops.vqt import _reflect_pad_last

    x0 = _reflect_pad_last(y.float(), _pad2(params))
    total = -(-x0.shape[-1] // CASCADE_ALIGN) * CASCADE_ALIGN
    return F.pad(x0, (0, total - x0.shape[-1])).contiguous()


def octave_plan(params: XQTParams = XQTParams()):
    """Per octave j (low to high): (j, level index, output row, frame offset, hop)."""
    pad2 = _pad2(params)
    dec_max = params.n_octaves - 1
    return [
        (j, dec_max - j, j * params.bins_per_octave, (pad2 >> (dec_max - j)) - params.window_len // 2,
         params.hop >> (dec_max - j))
        for j in range(params.n_octaves)
    ]


def log_xqt_fused(y: torch.Tensor, params: XQTParams = XQTParams()) -> torch.Tensor:
    """Batched log-VQT through the two kernels: (B, L) -> (B, n_bins, 1 + L//hop).

    The full-rate signal is reflect-padded by twice the plain path's pad and
    zero-filled to a multiple of 256; every cascade level then reads zero
    beyond its edges. The corrupted edge margin (at most 80 samples at any
    level) stays inside the extra pad, so every sample an octave frame
    consumes equals the plain path's reflect-padded ``_decimate2`` chain.
    """
    if y.ndim != 2:
        raise ValueError("expects (batch, samples)")
    if params.window_len != WINDOW or params.bins_per_octave != BPO:
        raise ValueError(f"the kernels are written for window_len={WINDOW}, bins_per_octave={BPO}")
    x0 = cascade_input(y, params)
    levels = (x0,) + decimation_cascade(x0, params.n_octaves - 1)
    banks = octave_banks(params, y.device)
    out = torch.empty((y.shape[0], params.n_bins, params.num_frames(y.shape[-1])),
                      dtype=torch.float32, device=y.device)
    for j, dec, row, offset, hop in octave_plan(params):
        octave_log_xqt(levels[dec], banks[j], out, row=row, offset=offset, hop=hop, log_eps=params.log_eps)
    return out
