"""Spleeter's decoder block on the card, its plain version, and the wrapper.

A decoder block of ``models/spleeter.UNet`` is
``bn(relu(up(deconv, cat([skip, u]))))``: a 5x5 stride-2 transposed conv
(``padding=1``, its last row and column cropped), ReLU and an inference
BatchNorm. ``decoder_block(skip, u, deconv, bn)`` computes it for float32
(B, C, h, w) inputs (``skip`` None for the first block, which reads c6
alone):

- on CPU tensors with ``block_plain``, the kernel's four sub-pixel phases
  and folded epilogue written in PyTorch (the tests hold it to the module
  path);
- on CUDA tensors with one launch of csrc/deconv_fprop.cu, which reads the
  two inputs, the weights and the BatchNorm's parameters and running
  statistics as the modules hold them (nothing folded or re-laid outside the
  launch, so nothing goes stale after ``load_state_dict``). It raises on
  what the kernel does not take; there is no fallback. It has no backward:
  ``UNet.forward`` takes it only in eval with grad off.

The kernel replaces no TPU kernel (the JAX package has no Spleeter); see the
note at the top of its source. ``pick_layout`` chooses its block layout from
the shape alone (no timing at run time), by ``layout_cost``. The launches
are counted as ``deconv_launch.fprop``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Iterator, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.utils import profiling

profiling.count("deconv_launch.fprop", 0)

TAPS = 25
WARPS = 8
COLS = 4  # input-grid columns a lane owns
INSTANCES = ((4, 1), (4, 2), (2, 2), (2, 4), (1, 4), (1, 8))  # (channels, rows) a lane owns, as built
CHANS = (16, 8, 4, 2, 1)  # input channels a ring stage holds, the most that fit first
STAGES = (3, 2)
MAX_SMEM_BYTES = 232448

# layout_cost's weights, in a lane's FFMA slots, fitted to the times of
# every layout at the six decoder shapes at S = 3 (NVIDIA H100 80GB HBM3):
# a shared-memory wavefront (one broadcast weight, or a quarter-warp's float4
# of inputs) costs SMEM_COST, as four SM sub-partitions share one pipe; a
# staging copy (its cp.async and address) COPY_COST, over a block's 256
# threads; a k-group's partial sum REDUCE_COST when the groups meet.
SMEM_COST = 7.0
COPY_COST = 120.0
REDUCE_COST = 8.0


class Layout(NamedTuple):
    tco: int  # output channels a lane owns
    pr: int  # input-grid rows a lane owns (and 4 columns)
    lc: int  # lanes across the columns (32 / lc down the rows)
    n_wp: int  # warps down the rows
    n_cg: int  # warps across the output channels
    n_kg: int  # warps across the input channels (their sums added in order after the last stage)
    chans: int  # input channels a ring stage holds
    stages: int


def block_tile(layout: Layout) -> tuple[int, int]:
    """The input-grid rows and columns a block owns."""
    return layout.n_wp * (32 // layout.lc) * layout.pr, layout.lc * COLS


def row_len(lc: int, pr: int) -> int:
    """Floats a staged input row holds (csrc/deconv_fprop.cu, row_len)."""
    n = lc * COLS + 4
    if lc == 4 and pr < 8:
        while (pr * n) % 32 != 16:
            n += 4
    return n


def smem_bytes(layout: Layout) -> int:
    """The layout's dynamic shared memory: its ring, or the k-groups' sums
    where those take more (csrc/deconv_fprop.cu, make_shape)."""
    rows, _ = block_tile(layout)
    chan = (rows + 2) * row_len(layout.lc, layout.pr) + TAPS * (layout.n_cg * layout.tco + 4)
    chan += -chan % 4
    acc = layout.pr * COLS * 4 * layout.tco
    red = (layout.n_kg - 1) * layout.n_cg * layout.n_wp * 32 * acc
    return 4 * max(layout.stages * layout.chans * chan, red)


def blocks(batch: int, h: int, w: int, cout: int, layout: Layout) -> int:
    rows, cols = block_tile(layout)
    return batch * math.ceil(h / rows) * math.ceil(w / cols) * (cout // (layout.n_cg * layout.tco))


def candidates(cout: int, w: int) -> Iterator[Layout]:
    """The layouts the rule weighs for ``cout`` output channels over ``w``
    input columns: each instance and split of the 8 warps over rows, output
    and input channels, with 8 lanes across the columns (4 where w is 16 or
    less) and the deepest ring that fits (the most channels a stage, then
    the most stages)."""
    lc = 4 if w <= 16 else 8
    for tco, pr in INSTANCES:
        for n_kg in (1, 2, 4, 8):
            for n_cg in (1, 2, 4, 8):
                if n_kg * n_cg > WARPS or cout % (n_cg * tco):
                    continue
                fits = (Layout(tco, pr, lc, WARPS // (n_kg * n_cg), n_cg, n_kg, chans, stages)
                        for chans in CHANS if chans % n_kg == 0 for stages in STAGES)
                layout = next((lay for lay in fits if smem_bytes(lay) <= MAX_SMEM_BYTES), None)
                if layout is not None:
                    yield layout


def layout_cost(batch: int, cin: int, h: int, w: int, cout: int, layout: Layout, n_sm: int, occupancy: int) -> float:
    """The layout's time on its busiest SM, in a lane's FFMA slots.

    An SM runs its share of the blocks (ceil(blocks / n_sm)). A block's
    lanes each sum cin / n_kg channels, a channel the larger of its 25 x 4 x pr x
    tco FFMAs and SMEM_COST times its shared-memory wavefronts (25 tco
    broadcast weights, 6 a row of inputs); its threads stage the tile and
    weights of every channel (a copy an input pair or a weight); the
    k-groups' sums cross shared memory once.
    ``occupancy`` (blocks an SM holds) only rules a layout out (0)."""
    if occupancy < 1:
        return math.inf
    rows, _ = block_tile(layout)
    acc = layout.pr * COLS * 4 * layout.tco
    per_channel = max(TAPS * layout.pr * COLS * layout.tco,
                      SMEM_COST * (TAPS * layout.tco + 6 * (layout.pr + 2)))
    staged = (rows + 2) * row_len(layout.lc, layout.pr) / 2 + TAPS * layout.n_cg * layout.tco
    per_block = (cin / layout.n_kg * per_channel + COPY_COST * cin * staged / (32 * WARPS)
                 + REDUCE_COST * acc * (layout.n_kg - 1))
    return math.ceil(blocks(batch, h, w, cout, layout) / n_sm) * per_block


def pick_layout(batch: int, cin: int, h: int, w: int, cout: int, n_sm: int,
                occupancy: Callable[[int, int, int], int]) -> Layout:
    """The block layout for a shape, from the shape alone: of ``candidates``,
    the lowest ``layout_cost``; ties to more blocks an SM, then to the
    earlier candidate. ``occupancy(tco, pr, smem_bytes)`` gives the blocks
    an SM holds (0: does not fit)."""
    best = None
    for layout in candidates(cout, w):
        occ = occupancy(layout.tco, layout.pr, smem_bytes(layout))
        key = (layout_cost(batch, cin, h, w, cout, layout, n_sm, occ), -occ)
        if best is None or key < best[0]:
            best = (key, layout)
    if best is None or math.isinf(best[0][0]):
        raise ValueError(f"no block layout of the decoder kernel fits cin={cin}, h={h}, w={w}, cout={cout}")
    return best[1]


def _bn_scale_shift(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """(cin, cout, 5, 5) transposed-conv weights -> (2, 2, cout, cin, 3, 3):
    phase (py, px)'s taps as a plain conv over the input padded by 1, tap
    (t, s) reading input (m + t - 1, n + s - 1) with kernel tap (py + 3 - 2 t,
    px + 3 - 2 s), zero where that falls outside 0..4."""
    cin, cout = weight.shape[:2]
    out = weight.new_zeros((2, 2, cout, cin, 3, 3))
    wt = weight.transpose(0, 1)
    for py in range(2):
        for px in range(2):
            for t in range(3):
                for s in range(3):
                    ky, kx = py + 3 - 2 * t, px + 3 - 2 * s
                    if 0 <= ky < 5 and 0 <= kx < 5:
                        out[py, px, :, :, t, s] = wt[:, :, ky, kx]
    return out


def block_plain(skip: torch.Tensor | None, u: torch.Tensor, deconv: nn.ConvTranspose2d,
                bn: nn.BatchNorm2d) -> torch.Tensor:
    """The kernel's function in PyTorch: each phase a conv of the padded
    [skip, u] with its taps, interleaved into (B, cout, 2 h, 2 w), then bias,
    ReLU and the folded BatchNorm."""
    x = u if skip is None else torch.cat([skip, u], dim=1)
    pw = phase_weights(deconv.weight)
    xp = F.pad(x, (1, 1, 1, 1))
    z = torch.stack([torch.stack([F.conv2d(xp, pw[py, px]) for px in range(2)], -1) for py in range(2)], -3)
    batch, cout, h, _, w, _ = z.shape
    z = z.reshape(batch, cout, 2 * h, 2 * w) + deconv.bias.view(1, -1, 1, 1)
    scale, shift = _bn_scale_shift(bn)
    return F.relu(z) * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FPROP_ARGS = (_P,) * 8 + (ctypes.c_float, _P) + (_I,) * 14 + (_P,)
_OCCUPANCY_ARGS = (_I, _I, _I, ctypes.POINTER(_I))
_SMEM_ARGS = (_I,) * 13 + (ctypes.POINTER(_I),)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    from zeronotesamba_torch.ops.cuda.build import load

    fn = getattr(load("deconv_fprop"), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, tco: int, pr: int, smem: int) -> int:
    """Blocks an SM of the card holds of instance (tco, pr) at ``smem`` bytes."""
    blocks_ = _I(0)
    with torch.cuda.device(device_index):
        _raise_on(_entry("zns_deconv_occupancy", _OCCUPANCY_ARGS)(tco, pr, smem, ctypes.byref(blocks_)),
                  "decoder kernel occupancy query")
    return blocks_.value


def library_smem_bytes(c_skip: int, c_u: int, h: int, w: int, cout: int, layout: Layout) -> int:
    """The library's own count of ``smem_bytes`` (csrc/deconv_fprop.cu, zns_deconv_smem)."""
    out = _I(0)
    err = _entry("zns_deconv_smem", _SMEM_ARGS)(c_skip, c_u, h, w, cout, *layout, ctypes.byref(out))
    if err != 0:
        raise ValueError(f"the decoder kernel does not take {layout} for ({c_skip} + {c_u}) x {h} x {w} -> {cout}")
    return out.value


@functools.lru_cache(maxsize=256)
def _layout(device_index: int, batch: int, cin: int, h: int, w: int, cout: int) -> Layout:
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return pick_layout(batch, cin, h, w, cout, n_sm, functools.partial(_occupancy, device_index))


def layout_for(skip: torch.Tensor | None, u: torch.Tensor, cout: int) -> Layout:
    """The layout ``launch`` takes for these inputs on their card."""
    idx = u.device.index if u.device.index is not None else torch.cuda.current_device()
    batch, c_u, h, w = u.shape
    return _layout(idx, batch, c_u + (0 if skip is None else skip.shape[1]), h, w, cout)


def launch(skip: torch.Tensor | None, u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           bn: nn.BatchNorm2d) -> torch.Tensor:
    """One kernel launch on CUDA tensors: skip (B, c_skip, h, w) or None and
    u (B, c_u, h, w) float32 contiguous, weight (c_skip + c_u, cout, 5, 5),
    bias (cout,), the BatchNorm's gamma, beta and running statistics (cout,);
    returns the block's (B, cout, 2 h, 2 w) output, in ``layout_for``'s layout."""
    batch, c_u, h, w = u.shape
    c_skip = 0 if skip is None else skip.shape[1]
    cout = weight.shape[1]
    params = (weight, bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    inputs = (u,) if skip is None else (skip, u)
    if not all(t.is_cuda and t.device == u.device and t.dtype == torch.float32 for t in inputs + params):
        raise ValueError("the decoder kernel takes float32 tensors on one card")
    if not all(t.is_contiguous() for t in inputs + params) or any(t.data_ptr() % 16 for t in inputs):
        raise ValueError("the decoder kernel takes contiguous tensors, its inputs 16-byte aligned")
    if skip is not None and (skip.shape[0] != batch or skip.shape[2:] != u.shape[2:]):
        raise ValueError(f"skip {tuple(skip.shape)} and u {tuple(u.shape)} differ in batch or size")
    if weight.shape != (c_skip + c_u, cout, 5, 5) or any(p.shape != (cout,) for p in params[1:]):
        raise ValueError(f"weights {tuple(weight.shape)} do not fit {c_skip} + {c_u} channels in, {cout} out")
    if not 1 <= batch <= 65535:
        raise ValueError(f"the decoder kernel takes 1 to 65535 batch rows, got {batch}")
    layout = layout_for(skip, u, cout)
    y = torch.empty((batch, cout, 2 * h, 2 * w), dtype=torch.float32, device=u.device)
    fn = _entry("zns_deconv_fprop", _FPROP_ARGS)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn((u if skip is None else skip).data_ptr(), u.data_ptr(), *(p.data_ptr() for p in params),
                 float(bn.eps), y.data_ptr(), batch, c_skip, c_u, h, w, cout, *layout, stream)
    _raise_on(err, "decoder kernel launch")
    profiling.count("deconv_launch.fprop")
    return y


def decoder_block(skip: torch.Tensor | None, u: torch.Tensor, deconv: nn.ConvTranspose2d,
                  bn: nn.BatchNorm2d) -> torch.Tensor:
    """``bn(relu(up(deconv, cat([skip, u]))))`` in eval, without grad: the
    plain version on CPU tensors, one kernel launch on CUDA tensors."""
    if (deconv.kernel_size, deconv.stride, deconv.padding, deconv.output_padding, deconv.dilation,
            deconv.groups) != ((5, 5), (2, 2), (1, 1), (0, 0), (1, 1), 1) or deconv.bias is None:
        raise ValueError(f"the decoder block takes a 5x5 stride-2 transposed conv with padding 1 and a bias, "
                         f"got {deconv}")
    if bn.running_mean is None or bn.weight is None:
        raise ValueError("the decoder block takes a BatchNorm with running statistics and an affine map")
    if not u.is_cuda:
        return block_plain(skip, u, deconv, bn)
    return launch(skip, u, deconv.weight, deconv.bias, bn)
