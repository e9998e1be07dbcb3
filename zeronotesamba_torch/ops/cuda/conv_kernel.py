"""The encoders' float32 conv on the card, its plain version, and the wrapper.

``conv2d(x, w, b, padding)`` computes ``F.conv2d(x, w, b, padding=padding)``
at stride 1 for a float32 (B, Cin, H, W) input:

- on CPU tensors it is ``F.conv2d`` itself (``conv2d_plain``), so every CPU
  test reads as before;
- on CUDA tensors it goes through ``ConvFprop``, whose forward launches
  csrc/conv_fprop.cu and whose backward launches csrc/conv_wgrad.cu for the
  weight and bias gradients and leaves the input gradient to cuDNN
  (``aten.convolution_backward``, as ``F.conv2d``'s own backward). It raises
  on what the kernels do not take; there is no fallback.

The kernels replace no TPU kernel (the JAX package leaves these convs to
XLA); see the notes at the top of their sources. ``pick_tiles`` chooses the
forward's block layout from the shape alone (no timing at run time): output
channels a thread (8, or 2 or 1 where 8 leave too few blocks to fill the
card), rows a block, and the ring's stages and input channels a stage.
``plan_wgrad`` chooses the weight gradient's split of its long sum, also
from the shape alone, and ``wgrad_reference`` holds its sums to the float64
gradients within the rounding of their order. ``profiling.totals("conv_launch.")`` counts launches:
``fprop`` a forward, ``wgrad`` a weight gradient.
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
profiling.count("conv_launch.wgrad", 0)

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

# The weight gradient (csrc/conv_wgrad.cu, whose zns_wgrad_layout gives
# each shape's blocks, chunks and partial sums).
WGRAD_WORKSPACE_BYTES = 256 << 20  # the most the splits' partial sums may take
# A block's fixed cost in chunks of its work: the ring's first stages and
# the write of its partial sums. Assumed, not fitted; the plans it gives were
# the fastest of 5 to 8 split counts tried at convs 2, 4, 6 and 7 at 8 x 1,920
# (conv 4: 1 split 86.83 ms, 5 61.56, 11 60.82 (the plan's), 22 60.93;
# NVIDIA H100 80GB HBM3).
SPLIT_COST_CHUNKS = 2
# The splits the plan tries: up to this many waves of blocks. It bounds the
# search alone: past a wave, more splits only add their blocks' fixed costs.
WGRAD_MAX_WAVES = 16


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


class WgradLayout(NamedTuple):
    """A shape's layout in csrc/conv_wgrad.cu (zns_wgrad_layout)."""
    chunks: int  # chunks of the sum over (batch row, output row, frame)
    blocks: int  # blocks a split
    floats: int  # weight partial sums a split
    bias_floats: int  # bias partial sums a split
    chunk_frames: int  # frames a chunk
    bias_frames: int  # frames of a chunk each bias partial sums


class WgradPlan(NamedTuple):
    splits: int
    chunks_per_split: int
    chunks: int
    workspace_bytes: int


def plan_wgrad(layout: WgradLayout, slots: int) -> WgradPlan:
    """The weight gradient's split of its sum over (batch row, output row,
    frame), from the shape's layout alone.

    Split s takes chunks [s c, (s + 1) c) for c chunks a split, and a
    layout's blocks each split. Of the splits whose partial sums fit in
    ``WGRAD_WORKSPACE_BYTES``, up to ``WGRAD_MAX_WAVES`` waves of blocks (a
    wave: ``slots`` blocks, as many as the card holds at once), the one
    that takes the fewest waves times each block's chunks and
    ``SPLIT_COST_CHUNKS``; ties to fewer splits."""
    chunks, base = layout.chunks, layout.blocks
    split_bytes = 4 * (layout.floats + layout.bias_floats)
    best = None
    for splits in range(1, min(chunks, 65535, math.ceil(WGRAD_MAX_WAVES * slots / base)) + 1):
        per_split = math.ceil(chunks / splits)
        if math.ceil(chunks / per_split) != splits:  # the same split as fewer splits give
            continue
        if splits * split_bytes > WGRAD_WORKSPACE_BYTES:
            break
        cost = math.ceil(base * splits / slots) * (per_split + SPLIT_COST_CHUNKS)
        if best is None or cost < best[0]:
            best = (cost, WgradPlan(splits, per_split, chunks, splits * split_bytes))
    if best is None:
        raise ValueError(f"the weight gradient's partial sums of {layout.floats} floats a split do not fit in "
                         f"{WGRAD_WORKSPACE_BYTES} bytes")
    return best[1]


def wgrad_chains(layout: WgradLayout, plan: WgradPlan) -> Tuple[int, int]:
    """The terms of the longest chain of float32 roundings in a weight and
    in a bias gradient: a thread's FFMA chain over its split's frames from
    zero, then the splits' partials added in split order (a bias gradient:
    its 4 partials a split)."""
    parts = layout.chunk_frames // layout.bias_frames
    return (plan.chunks_per_split * layout.chunk_frames + plan.splits,
            plan.chunks_per_split * layout.bias_frames + plan.splits * parts)


def wgrad_reference(x: torch.Tensor, gy: torch.Tensor, w_shape: Sequence[int], padding: Sequence[int],
                    chains: Tuple[int, int]) -> Tuple[tuple, tuple, tuple]:
    """The float64 weight and bias gradients of float32 x and gy, and two
    bounds on the error of sums in float32 (u = 2^-24) whose longest chains
    of roundings hold ``chains`` = (n_w, n_b) terms t (gy x for a weight,
    gy for a bias):

    - worst case: gamma(n) = n u / (1 - n u) times the sum of |t|;
    - probable: 7 sqrt(n) u times the root of the sum of t^2. A chain's
      error is the sum of its roundings delta_k S_k, |delta_k| <= u, over
      its partial sums S_k; for independent zero-mean terms (the tests'
      Gaussian inputs) the expected sum of S_k^2 stays within n times the
      sum of t^2, and by Azuma-Hoeffding an error beyond 7 u times its root
      has probability at most 2 exp(-7^2 / 2) = 4.6e-11.

    Returns ((gw, gb), (worst_w, worst_b), (probable_w, probable_b)), each
    a float64 tensor on x's device."""
    u = 2.0 ** -24
    xd, gd = x.double(), gy.double()
    dims = (0, 2, 3)

    def terms(fx, fg):
        return torch.nn.grad.conv2d_weight(fx(xd), w_shape, fg(gd), padding=tuple(padding)), fg(gd).sum(dims)

    ref = terms(lambda t: t, lambda t: t)
    worst = [n * u / (1 - n * u) * a for n, a in zip(chains, terms(torch.abs, torch.abs))]
    probable = [7.0 * math.sqrt(n) * u * a.sqrt() for n, a in zip(chains, terms(torch.square, torch.square))]
    return ref, tuple(worst), tuple(probable)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, padding: Sequence[int]) -> torch.Tensor:
    """The plain version: ``F.conv2d`` at stride 1."""
    return F.conv2d(x, w, b, padding=tuple(padding))


def backward_plain(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, padding: Sequence[int], bias: bool,
                   mask: Sequence[bool]) -> tuple:
    """The input, weight and bias gradients the mask asks for (the others
    None) at stride 1: ``aten.convolution_backward``, as ``F.conv2d``'s
    autograd computes them."""
    return torch.ops.aten.convolution_backward(gy, x, w, [w.shape[0]] if bias else None, [1, 1], list(padding),
                                               [1, 1], False, [0, 0], 1, list(mask))


def wgrad_plain(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor, padding: Sequence[int],
                bias: bool) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """The plain weight and bias gradients (the bias's None unless ``bias``):
    ``backward_plain`` with the mask [False, True, bias]."""
    return backward_plain(gy, x, w, padding, bias, [False, True, bias])[1:]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FPROP_ARGS = (_P, _P, _P, _P) + (_I,) * 13 + (_P,)
_OCCUPANCY_ARGS = (_I,) * 6 + (ctypes.POINTER(_I), ctypes.POINTER(_I))
_WGRAD_ARGS = (_P,) * 6 + (_I,) * 9 + (_L, _L, _P)
_WGRAD_OCCUPANCY_ARGS = (_I, ctypes.POINTER(_I), ctypes.POINTER(_I))
_WGRAD_LAYOUT_ARGS = (_I,) * 9 + (ctypes.POINTER(_L),)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, argtypes: tuple, library: str = "conv_fprop") -> ctypes._CFuncPtr:
    from zeronotesamba_torch.ops.cuda.build import load

    fn = getattr(load(library), symbol)
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


@functools.lru_cache(maxsize=None)
def _wgrad_occupancy(device_index: int, kw: int) -> int:
    """Blocks an SM of the card holds of the weight-gradient kernel for width kw."""
    fn = _entry("zns_wgrad_occupancy", _WGRAD_OCCUPANCY_ARGS, "conv_wgrad")
    smem, blocks = _I(0), _I(0)
    with torch.cuda.device(device_index):
        _raise_on(fn(kw, ctypes.byref(smem), ctypes.byref(blocks)), "weight-gradient kernel occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the weight-gradient kernel for kw={kw} fits no block on an SM")
    return blocks.value


def wgrad_layout(batch: int, cin: int, h: int, w: int, cout: int, kh: int, kw: int, ph: int, pw: int) -> WgradLayout:
    """The weight-gradient kernel's layout of a shape (x (batch, cin, h, w),
    cout x kh x kw, padding (ph, pw)), as csrc/conv_wgrad.cu reports it."""
    fn = _entry("zns_wgrad_layout", _WGRAD_LAYOUT_ARGS, "conv_wgrad")
    out = (_L * 6)()
    if fn(batch, cin, h, w, cout, kh, kw, ph, pw, out) != 0:
        raise ValueError(f"the weight-gradient kernel does not take x ({batch}, {cin}, {h}, {w}), "
                         f"{cout}x{kh}x{kw}, padding ({ph}, {pw})")
    return WgradLayout(*out)


@functools.lru_cache(maxsize=256)
def _wgrad_plan(device_index: int, shape: tuple, cout: int, kh: int, kw: int,
                padding: tuple) -> Tuple[WgradLayout, WgradPlan]:
    layout = wgrad_layout(*shape, cout, kh, kw, *padding)
    slots = torch.cuda.get_device_properties(device_index).multi_processor_count * _wgrad_occupancy(device_index, kw)
    return layout, plan_wgrad(layout, slots)


def wgrad_plan(x: torch.Tensor, cout: int, kh: int, kw: int,
               padding: Sequence[int]) -> Tuple[WgradLayout, WgradPlan]:
    """The layout and the split ``wgrad`` takes for x on its card."""
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return _wgrad_plan(idx, tuple(x.shape), cout, kh, kw, tuple(padding))


def wgrad(x: torch.Tensor, gy: torch.Tensor, kh: int, kw: int, padding: Tuple[int, int],
          bias: bool) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """The weight and bias gradients (the bias's None unless ``bias``) of the
    conv at stride 1 on CUDA tensors: x (B, Cin, H, W) and gy (B, Cout,
    H_out, W_out), float32 contiguous. One launch of csrc/conv_wgrad.cu and
    its reduction over the splits, into partial sums from the caching
    allocator."""
    batch, cin, h, wd = x.shape
    cout = gy.shape[1]
    if kw not in KERNEL_WIDTHS:
        raise ValueError(f"the weight-gradient kernel is built for kernel widths {KERNEL_WIDTHS}, got {kw}")
    if not 1 <= batch <= 65535:
        raise ValueError(f"the weight-gradient kernel takes 1 to 65535 batch rows, got {batch}")
    if not x.is_cuda or gy.device != x.device or x.dtype != torch.float32 or gy.dtype != torch.float32:
        raise ValueError("x and gy must be float32 on one card")
    h_out, w_out = output_size(h, wd, kh, kw, padding)
    if not (x.is_contiguous() and gy.is_contiguous()) or gy.shape != (batch, cout, h_out, w_out):
        raise ValueError(f"the weight-gradient kernel takes contiguous x and gy; got x {tuple(x.shape)}, gy "
                         f"{tuple(gy.shape)} for {kh}x{kw}, padding {padding}")
    layout, plan = wgrad_plan(x, cout, kh, kw, padding)
    part = torch.empty(plan.splits * layout.floats, dtype=torch.float32, device=x.device)
    gw = torch.empty((cout, cin, kh, kw), dtype=torch.float32, device=x.device)
    gb = bias_part = None
    if bias:
        gb = torch.empty(cout, dtype=torch.float32, device=x.device)
        bias_part = torch.empty(plan.splits * layout.bias_floats, dtype=torch.float32, device=x.device)
    fn = _entry("zns_conv_wgrad", _WGRAD_ARGS, "conv_wgrad")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gy.data_ptr(), part.data_ptr(), None if bias_part is None else bias_part.data_ptr(),
                 gw.data_ptr(), None if gb is None else gb.data_ptr(), batch, cin, h, wd, cout, kh, kw, padding[0],
                 padding[1], plan.chunks_per_split, part.numel(), stream)
    _raise_on(err, "weight-gradient kernel launch")
    profiling.count("conv_launch.wgrad")
    return gw, gb


class ConvFprop(torch.autograd.Function):
    """The conv at stride 1, as ``F.conv2d``'s autograd computes it: on CUDA
    tensors the kernels' forward, weight and bias gradients and cuDNN's input
    gradient; on CPU tensors the plain forward and ``convolution_backward``."""

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
        need_x, need_w, need_b = ctx.needs_input_grad[:2] + (ctx.has_bias and ctx.needs_input_grad[2],)
        if not (x.is_cuda and need_w):
            return (*backward_plain(gy, x, w, ctx.padding, ctx.has_bias, [need_x, need_w, need_b]), None)
        gx = backward_plain(gy, x, w, ctx.padding, ctx.has_bias, [True, False, False])[0] if need_x else None
        gw, gb = wgrad(x, gy.contiguous(), w.shape[2], w.shape[3], ctx.padding, need_b)
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
