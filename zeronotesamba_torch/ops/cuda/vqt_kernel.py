"""The log-VQT's two Hopper kernels, their plain versions, and the wrapper.

Counterpart of zeronotesamba_tpu/ops/pallas/vqt_kernel.py:

- ``decimation_cascade_packed``: all half-band decimation levels in one
  launch, in polyphase form, packed into one row per batch row
  (csrc/vqt_cascade.cu, replaces ``_cascade_kernel``); ``unpack_levels``
  splits that row back into its levels;
- ``octaves_log_xqt``: every octave's framing + filterbank + magnitude + log
  in one launch, written into the final (B, 96, T) output
  (csrc/vqt_octave.cu, replaces ``_octave_kernel``);
- ``log_xqt_fused``: the host orchestration of ``log_xqt_pallas``
  (fused_cascade=True): pads, the octave plan table, octave order.

Each kernel function takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; there is no fallback between the two.
``profiling.totals("vqt_launch.")`` counts kernel launches, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zeronotesamba_torch.ops.filterbank import XQTParams, halfband_decimation_filter, octave_banks_f32
from zeronotesamba_torch.utils import profiling

profiling.count("vqt_launch.cascade", 0)
profiling.count("vqt_launch.octave", 0)

TAPS = 81
HALF = TAPS // 2
PAIRS = 20  # non-zero half-band tap pairs, at offsets +-(2q+1)
MAX_LEVELS = 7
WINDOW = 256  # frame length the octave kernel is written for
BPO = 12  # bins per octave the octave kernel is written for
MAX_HOP = 256
MAX_OCTAVES = 8  # plan entries one octave launch takes
CASCADE_ALIGN = 256  # the cascade input is zero-filled to a multiple of this
PACKED_ROW_ALIGN = 4  # floats: packed level rows start 16-byte aligned
DROPPED_TAP_MAX = 1e-12  # largest |tap| the cascade kernel may drop as a sinc zero
# Columns of an octave plan table row.
PLAN_COLUMNS = ("src", "level_off", "frame_off", "hop", "row", "bank")


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


def halfband_polyphase_taps(taps: np.ndarray) -> np.ndarray:
    """81 half-band taps -> (21,) float32 ``[centre, p_0, ..., p_19]``, where
    ``p_q`` is the tap at offsets -(2q+1) and +(2q+1) from the centre.

    The cascade kernel drops the taps at non-zero even offsets and keeps one
    value for both taps of a pair, so this raises if one of the dropped taps
    exceeds ``DROPPED_TAP_MAX`` in magnitude or if a pair is not exactly
    symmetric (in float32)."""
    t = np.asarray(taps, dtype=np.float32)
    if t.shape != (TAPS,):
        raise ValueError(f"expected {TAPS} taps, got shape {t.shape}")
    dropped = np.delete(t[0::2], HALF // 2)
    if np.abs(dropped).max() > DROPPED_TAP_MAX:
        raise ValueError(f"not a half-band filter: a tap at an even offset is {np.abs(dropped).max():.3g}")
    left, right = t[HALF - 1::-2], t[HALF + 1::2]
    if not np.array_equal(left, right):
        raise ValueError("half-band tap pairs are not symmetric")
    return np.concatenate([t[HALF:HALF + 1], right])


@functools.lru_cache(maxsize=1)
def _polyphase_taps_c() -> ctypes.Array:
    """The kernel's 21 taps as a C float array (host memory)."""
    return (ctypes.c_float * (1 + PAIRS))(*halfband_polyphase_taps(halfband_decimation_filter()).tolist())


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
_OCTAVES_ARGS = (_P, _I64, _P, _I64, _P, _I32, _I32, _I64, _P, _I32, _P, _I64, ctypes.c_float, _P)


# --------------------------------------------------------------------------
# Kernel 1: decimation cascade
# --------------------------------------------------------------------------


def level_lengths(len0: int, n_levels: int) -> List[int]:
    """Lengths of levels 1..n_levels of a length-``len0`` cascade input."""
    return [len0 >> s for s in range(1, n_levels + 1)]


def _packed_n_levels(len0: int, packed_len: int) -> int:
    """The number of levels of a length-``len0`` input that pack into
    ``packed_len`` samples; raises if no number does."""
    for n in range(1, MAX_LEVELS + 1):
        if sum(level_lengths(len0, n)) == packed_len:
            return n
    raise ValueError(f"{packed_len} samples are not the packed levels of a length-{len0} cascade input")


def unpack_levels(packed: torch.Tensor, len0: int) -> Tuple[torch.Tensor, ...]:
    """The packed levels of ``decimation_cascade_packed`` of a length-``len0``
    input, as a tuple of (B, len0 >> s) views."""
    return tuple(torch.split(packed, level_lengths(len0, _packed_n_levels(len0, packed.shape[1])), dim=1))


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


def _decimation_cascade_cuda(x: torch.Tensor, out: torch.Tensor, n_levels: int) -> None:
    b, length = x.shape
    fn = _entry("vqt_cascade", "zns_cascade", _CASCADE_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), ctypes.addressof(_polyphase_taps_c()), b, length, n_levels,
                 out.stride(0), stream)
    _raise_on(err, "cascade kernel")
    profiling.count("vqt_launch.cascade")


def decimation_cascade_packed(x: torch.Tensor, n_levels: int = MAX_LEVELS) -> torch.Tensor:
    """(B, L) float32 -> (B, sum_s L >> s): levels s = 1..n_levels back to
    back in each row, level s at offset ``sum(level_lengths(L, s - 1))``.

    Level s+1 is the 81-tap half-band filter at stride 2 over level s, with
    samples outside each level read as zero. ``L`` must be a multiple of 256.
    The result is a view whose row stride is rounded up to a multiple of
    ``PACKED_ROW_ALIGN`` floats, so that every level of every row starts
    16-byte aligned.
    """
    _check(x, "x", 2)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels must be in 1..{MAX_LEVELS}")
    if x.shape[1] % CASCADE_ALIGN != 0:
        raise ValueError(f"cascade input length must be a multiple of {CASCADE_ALIGN}")
    if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16 != 0):
        raise ValueError("cascade input must be contiguous and 16-byte aligned")
    total = sum(level_lengths(x.shape[1], n_levels))
    stride = -(-total // PACKED_ROW_ALIGN) * PACKED_ROW_ALIGN
    out = torch.empty((x.shape[0], stride), dtype=torch.float32, device=x.device)[:, :total]
    if x.is_cuda:
        _decimation_cascade_cuda(x, out, n_levels)
    else:
        out.copy_(torch.cat(decimation_cascade_plain(x, n_levels), dim=1))
    return out


# --------------------------------------------------------------------------
# Kernel 2: every octave -> log magnitudes
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


def octaves_log_xqt_plain(
    x0: torch.Tensor, levels: torch.Tensor, plan: torch.Tensor, banks: torch.Tensor, out: torch.Tensor, *,
    log_eps: float,
) -> None:
    """The octave kernel's plain version, on the kernel's arguments: every
    entry of ``plan`` through ``octave_log_xqt_plain``."""
    for src, level_off, frame_off, hop, row, bank in plan.tolist():
        level = (x0 if src == 0 else levels)[:, level_off:]
        octave_log_xqt_plain(level, banks[bank], out, row=row, offset=frame_off, hop=hop, log_eps=log_eps)


def _octaves_log_xqt_cuda(
    x0: torch.Tensor, levels: torch.Tensor, plan: torch.Tensor, banks: torch.Tensor, out: torch.Tensor,
    log_eps: float,
) -> None:
    fn = _entry("vqt_octave", "zns_octaves", _OCTAVES_ARGS)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            x0.data_ptr(), x0.stride(0), levels.data_ptr(), levels.stride(0), plan.data_ptr(), plan.shape[0],
            out.shape[2], out.shape[0], banks.data_ptr(), banks.shape[0], out.data_ptr(), out.stride(0),
            log_eps, stream,
        )
    _raise_on(err, "octave kernel")
    profiling.count("vqt_launch.octave")


def octaves_log_xqt(
    x0: torch.Tensor, levels: torch.Tensor, plan: torch.Tensor, banks: torch.Tensor, out: torch.Tensor, *,
    log_eps: float,
) -> None:
    """Every octave of ``plan`` into its 12 rows of ``out``, in one launch.

    x0: (B, L0) float32 full-rate signal; levels: (B, L) float32, the
    cascade's packed levels of x0. plan: (n, 6) int64 on the CPU, one row
    per octave with the columns ``PLAN_COLUMNS``: frame t of the octave
    covers ``src[:, level_off + frame_off + t*hop :][:256]``, where src is x0
    (src 0, level_off 0) or levels (src 1, level_off the start of one level),
    and its log magnitudes go to ``out[:, row : row + 12, t]``. Every frame
    must lie inside its level. banks: (n_banks, 256, 24) float32 [cos | sin].
    out: (B, n_bins, T) float32.
    """
    _check(x0, "x0", 2)
    _check(levels, "levels", 2)
    _check(banks, "banks", 3)
    _check(out, "out", 3)
    if plan.dtype != torch.int64 or plan.ndim != 2 or plan.shape[1] != len(PLAN_COLUMNS) or plan.is_cuda:
        raise ValueError(f"plan must be a CPU int64 (n, {len(PLAN_COLUMNS)}) table, got {plan.dtype} "
                         f"{tuple(plan.shape)} on {plan.device}")
    if not 1 <= plan.shape[0] <= MAX_OCTAVES:
        raise ValueError(f"plan must have 1..{MAX_OCTAVES} rows, got {plan.shape[0]}")
    if tuple(banks.shape[1:]) != (WINDOW, 2 * BPO):
        raise ValueError(f"banks must be (n, {WINDOW}, {2 * BPO}), got {tuple(banks.shape)}")
    if not x0.shape[0] == levels.shape[0] == out.shape[0]:
        raise ValueError(f"batch differs: x0 {tuple(x0.shape)}, levels {tuple(levels.shape)}, out {tuple(out.shape)}")
    if not x0.device == levels.device == banks.device == out.device:
        raise ValueError("x0, levels, banks and out must be on one device")
    n_frames = out.shape[2]
    entries = plan.tolist()
    # Level start -> level end in the packed row, for the entries that read levels.
    level_end = {}
    if any(entry[0] == 1 for entry in entries):
        len0 = x0.shape[1]
        starts = np.cumsum([0] + level_lengths(len0, _packed_n_levels(len0, levels.shape[1]))).tolist()
        level_end = dict(zip(starts[:-1], starts[1:]))
    for entry in entries:
        src, level_off, frame_off, hop, row, bank = entry
        if (src not in (0, 1) or not 0 <= bank < banks.shape[0] or not 0 <= row <= out.shape[1] - BPO
                or frame_off < 0 or hop < 1 or (src == 0 and level_off != 0)
                or (src == 1 and level_off not in level_end)):
            raise ValueError(f"bad plan row {entry}")
        end = x0.shape[1] if src == 0 else level_end[level_off]
        if level_off + frame_off + (n_frames - 1) * hop + WINDOW > end:
            raise ValueError(f"frames of plan row {entry} run past their level")
    if not out.is_cuda:
        octaves_log_xqt_plain(x0, levels, plan, banks, out, log_eps=log_eps)
        return
    if x0.stride(1) != 1 or levels.stride(1) != 1 or not banks.is_contiguous() or not out.is_contiguous():
        raise ValueError("octave kernel needs unit-stride x0 and level rows, contiguous banks and out")
    if int(plan[:, 3].max()) > MAX_HOP:
        raise ValueError(f"octave kernel hop must be in 1..{MAX_HOP}")
    _octaves_log_xqt_cuda(x0, levels, plan.contiguous(), banks, out, log_eps)


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


def octave_table(params: XQTParams, len0: int) -> torch.Tensor:
    """``octave_plan`` as the octave kernel's plan table for a cascade input
    of length ``len0``: (n_octaves, 6) int64, columns ``PLAN_COLUMNS``."""
    starts = np.concatenate([[0], np.cumsum(level_lengths(len0, params.n_octaves - 1))]).tolist()
    rows = [(0 if dec == 0 else 1, 0 if dec == 0 else starts[dec - 1], offset, hop, row, j)
            for j, dec, row, offset, hop in octave_plan(params)]
    return torch.tensor(rows, dtype=torch.int64)


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
    levels = decimation_cascade_packed(x0, params.n_octaves - 1)
    out = torch.empty((y.shape[0], params.n_bins, params.num_frames(y.shape[-1])),
                      dtype=torch.float32, device=y.device)
    octaves_log_xqt(x0, levels, octave_table(params, x0.shape[1]), octave_banks(params, y.device), out,
                    log_eps=params.log_eps)
    return out
