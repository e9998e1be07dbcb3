"""The encoders' float32 conv forward on the card, its plain version, and the wrapper.

``conv2d(x, w, b, padding)`` computes ``F.conv2d(x, w, b, padding=padding)``
at stride 1 for a float32 (B, Cin, H, W) input:

- on CPU tensors it is ``F.conv2d`` itself (``conv2d_plain``), so every CPU
  test reads as before;
- on CUDA tensors it goes through ``ConvFprop``, whose forward launches
  csrc/conv_fprop.cu and whose backward is cuDNN's
  (``aten.convolution_backward``, as ``F.conv2d``'s own backward). It raises
  on what the kernel does not take; there is no fallback.

The kernel replaces no TPU kernel (the JAX package leaves these convs to
XLA); see the note at the top of its source. ``pick_tiles`` chooses its block
layout from the shape alone (no timing at run time): output channels a
thread (8, or 2 or 1 where 8 leave too few blocks to fill the card), rows a
block, and the ring's stages and input channels a stage. ``profiling.totals("conv_launch.")`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from zeronotesamba_torch.utils import profiling

profiling.count("conv_launch.fprop", 0)

KERNEL_WIDTHS = (11, 13, 15, 17, 19, 21, 23, 25)  # the kw csrc/conv_fprop.cu is instantiated for
CO_PER_THREAD = (8, 2, 1)
BLOCK_ROWS = (1, 2, 4, 8)
STAGES = (2, 3, 4)
CHANNELS = (1, 2, 4, 8)  # input channels a ring stage holds
WARPS = 8  # a block's warps; warp w owns co_per_thread output channels
POSITIONS = 256  # output positions (rows x frames) a block owns
THREAD_FRAMES = 8  # consecutive frames a thread owns
# Blocks an SM below which a layout takes fewer output channels a thread: 8
# warps on an SM and 64 sums a thread keep its FFMA pipes busy, fewer do not
# (conv 7 of a song, 1 x 1,876: 16 blocks at 8 channels take 0.61 ms, 128 at
# one channel 0.19 ms; NVIDIA H100 80GB HBM3).
FILL = 0.9


class Tiles(NamedTuple):
    co_per_thread: int
    rows: int
    stages: int
    chans: int


def output_size(h: int, w: int, kh: int, kw: int, padding: Tuple[int, int]) -> Tuple[int, int]:
    return h + 2 * padding[0] - kh + 1, w + 2 * padding[1] - kw + 1


def pick_tiles(batch: int, cin: int, cout: int, kh: int, kw: int, h_out: int, w_out: int, n_sm: int,
               occupancy: Callable[[int, int, int, int, int, int], int]) -> Tiles:
    """The block layout for a shape, from the shape alone.

    ``occupancy(kh, kw, co_per_thread, rows, stages, chans)`` gives the
    blocks an SM holds (0: does not fit). Output channels a thread: the most
    of ``CO_PER_THREAD`` that still gives ``FILL`` blocks an SM or more (fewer
    channels a thread make more, lighter threads where a shape has few
    outputs). For those, the rows of a block that take the fewest waves of
    blocks (a wave: every SM holding as many blocks as fit), ties to the
    fewest staged input floats an output; and the ring that keeps the most
    blocks an SM, then holds the most channels in flight (up to 16), then the
    most a stage."""
    fallback = None
    for tco in CO_PER_THREAD:
        layouts = []
        for rows in BLOCK_ROWS:
            if rows > h_out:
                continue
            fits = [(occupancy(kh, kw, tco, rows, st, ch), min(st * ch, 16), ch, st)
                    for st in STAGES for ch in CHANNELS]
            occ, _, chans, stages = max(fits)
            if occ < 1:
                continue
            frames = POSITIONS // rows
            blocks = (math.ceil(cout / (WARPS * tco)) * math.ceil(w_out / frames) * math.ceil(h_out / rows)
                      * batch)
            per_sm = min(occ, math.ceil(blocks / n_sm))
            waves = math.ceil(blocks / (n_sm * per_sm))
            staged = (rows + kh - 1) * tile_len(kw, rows) / POSITIONS
            layouts.append(((waves * per_sm, staged), blocks, Tiles(tco, rows, stages, chans)))
        if layouts:
            _, blocks, fallback = min(layouts)
            if blocks >= FILL * n_sm:
                return fallback
    if fallback is None:
        raise ValueError(f"no block layout of the conv kernel fits kh={kh}, kw={kw}")
    return fallback


def tile_len(kw: int, rows: int) -> int:
    """Floats a staged input row holds (csrc/conv_fprop.cu, make_shape)."""
    return POSITIONS // rows - THREAD_FRAMES + (kw + THREAD_FRAMES - 1 + 3) // 4 * 4


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, padding: Sequence[int]) -> torch.Tensor:
    """The plain version: ``F.conv2d`` at stride 1."""
    return F.conv2d(x, w, b, padding=tuple(padding))


_P, _I = ctypes.c_void_p, ctypes.c_int
_FPROP_ARGS = (_P, _P, _P, _P) + (_I,) * 13 + (_P,)
_OCCUPANCY_ARGS = (_I,) * 6 + (ctypes.POINTER(_I), ctypes.POINTER(_I))


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    from zeronotesamba_torch.ops.cuda.build import load

    fn = getattr(load("conv_fprop"), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, kh: int, kw: int, tco: int, rows: int, stages: int, chans: int) -> int:
    """Blocks an SM of the card holds for this layout; 0 where it does not fit."""
    fn = _entry("zns_conv_occupancy", _OCCUPANCY_ARGS)
    smem, blocks = _I(0), _I(0)
    with torch.cuda.device(device_index):
        err = fn(kh, kw, tco, rows, stages, chans, ctypes.byref(smem), ctypes.byref(blocks))
    if err == 1:  # cudaErrorInvalidValue: the ring does not fit in a block's shared memory
        return 0
    _raise_on(err, "conv kernel occupancy query")
    return blocks.value


@functools.lru_cache(maxsize=256)
def _tiles(device_index: int, batch: int, cin: int, cout: int, kh: int, kw: int, h_out: int, w_out: int) -> Tiles:
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return pick_tiles(batch, cin, cout, kh, kw, h_out, w_out, n_sm, functools.partial(_occupancy, device_index))


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) weights as the kernel reads them: (Cin, kh, kw, Cout), contiguous."""
    return w.detach().permute(1, 2, 3, 0).contiguous()


def launch(x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor | None, padding: Tuple[int, int]) -> torch.Tensor:
    """One kernel launch on CUDA tensors: x (B, Cin, H, W) float32
    contiguous, ``wt`` from ``kernel_weights``, b (Cout,) or None; returns the
    (B, Cout, H_out, W_out) output."""
    batch, cin, h, wd = x.shape
    _, kh, kw, cout = wt.shape
    if kw not in KERNEL_WIDTHS:
        raise ValueError(f"the conv kernel is built for kernel widths {KERNEL_WIDTHS}, got {kw}")
    if cout % 8 != 0:
        raise ValueError(f"the conv kernel needs a multiple of 8 output channels, got {cout}")
    if not 1 <= batch <= 65535:
        raise ValueError(f"the conv kernel takes 1 to 65535 batch rows, got {batch}")
    if wt.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must be on one device")
    if not wt.is_contiguous() or wt.shape[0] != cin or wt.data_ptr() % 16 != 0:
        raise ValueError(f"kernel weights must be contiguous (Cin, kh, kw, Cout), 16-byte aligned; got "
                         f"{tuple(wt.shape)} for x {tuple(x.shape)}")
    h_out, w_out = output_size(h, wd, kh, kw, padding)
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    tiles = _tiles(idx, batch, cin, cout, kh, kw, h_out, w_out)
    bias = None if b is None else b.detach().contiguous()
    y = torch.empty((batch, cout, h_out, w_out), dtype=torch.float32, device=x.device)
    fn = _entry("zns_conv_fprop", _FPROP_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(), batch, cin, h,
                 wd, cout, kh, kw, padding[0], padding[1], *tiles, stream)
    _raise_on(err, "conv kernel launch")
    profiling.count("conv_launch.fprop")
    return y


class ConvFprop(torch.autograd.Function):
    """The conv at stride 1: the kernel's forward (the plain version for CPU
    tensors) and cuDNN's backward, as ``F.conv2d``'s autograd computes it."""

    @staticmethod
    def forward(ctx, x, w, b, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = tuple(padding)
        ctx.has_bias = b is not None
        if x.is_cuda:
            return launch(x, kernel_weights(w), b, ctx.padding)
        return conv2d_plain(x, w, b, ctx.padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.has_bias and ctx.needs_input_grad[2]]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy, x, w, [w.shape[0]] if ctx.has_bias else None, [1, 1], list(ctx.padding), [1, 1], False, [0, 0], 1,
            mask)
        return gx, gw, gb, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, padding: Sequence[int]) -> torch.Tensor:
    """``F.conv2d(x, w, b, padding=padding)`` at stride 1 for a float32
    contiguous (B, Cin, H, W) input: the plain version for CPU tensors, the
    kernel for CUDA tensors. Raises on another dtype, rank or layout."""
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (b is not None and b.dtype != torch.float32):
        raise TypeError(f"conv2d takes float32 tensors, got x {x.dtype}, w {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != x.shape[1] or (b is not None and b.shape != (w.shape[0],)):
        raise ValueError(f"conv2d takes x (B, Cin, H, W), w (Cout, Cin, kh, kw), b (Cout,); got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("conv2d takes a contiguous input")
    padding = tuple(int(p) for p in padding)
    if len(padding) != 2 or min(padding) < 0 or min(output_size(*x.shape[2:], *w.shape[2:], padding)) < 1:
        raise ValueError(f"bad padding {padding} for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if not x.is_cuda:
        return conv2d_plain(x, w, b, padding)
    return ConvFprop.apply(x, w, b, padding)
