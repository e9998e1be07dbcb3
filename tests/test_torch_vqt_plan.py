"""The host-side forms the two log-VQT kernels compute from, on the CPU.

- ``halfband_polyphase_taps``: the 21 taps the cascade kernel keeps rebuild
  the 81 taps to 1e-12, and a filter that is not half-band is refused.
- The polyphase cascade on the even and odd phases, written here in torch
  both as the kernel sums it (the 41 non-zero taps in tap order) and folded
  (each symmetric pair added before its multiply), matches the 81-tap
  ``decimation_cascade_plain`` to 1e-5 over 7 levels (float32 sums in
  another order).
- The packed levels keep every octave's frames 16-byte aligned, and the
  octave wrapper refuses a plan entry whose frames leave their level.
- The all-octave plain version, fed the packed levels and plan table the
  octave kernel gets, equals the per-octave loop exactly and the JAX package's
  ``log_xqt_pallas(..., interpret=True, fused_cascade=True)`` to 5e-4 (as at
  tests/test_pallas_vqt.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from zeronotesamba_tpu.ops.filterbank import XQTParams as JParams
from zeronotesamba_tpu.ops.pallas.vqt_kernel import log_xqt_pallas
from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
from zeronotesamba_torch.ops.filterbank import XQTParams, halfband_decimation_filter

torch.set_num_threads(2)

VQT_ATOL = 5e-4
CASCADE_ATOL = 1e-5
# 3 s clips, and 0.5 s clips: shorter than the full-rate reflect pad.
LENGTHS = [48000, 8000]


def _signal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _unfold_taps(poly):
    """[centre, p_0..p_19] -> the 81 taps they stand for."""
    full = np.zeros(vk.TAPS, dtype=np.float64)
    full[vk.HALF] = poly[0]
    q = np.arange(vk.PAIRS)
    full[vk.HALF - 1 - 2 * q] = poly[1:]
    full[vk.HALF + 1 + 2 * q] = poly[1:]
    return full


def test_polyphase_taps_rebuild_the_81_taps():
    taps = halfband_decimation_filter().astype(np.float32)
    poly = vk.halfband_polyphase_taps(taps)
    assert poly.shape == (1 + vk.PAIRS,) and poly.dtype == np.float32
    np.testing.assert_allclose(_unfold_taps(poly), taps.astype(np.float64), rtol=0, atol=1e-12)
    assert poly[0] == pytest.approx(0.5, abs=1e-5)


@pytest.mark.parametrize("fault", ["not_halfband", "asymmetric", "short"])
def test_polyphase_taps_refuse_other_filters(fault):
    taps = halfband_decimation_filter().astype(np.float32)
    if fault == "not_halfband":
        taps = np.hanning(vk.TAPS).astype(np.float32) / 40.0
    elif fault == "asymmetric":
        taps = taps.copy()
        taps[vk.HALF + 3] *= 1.0001
    else:
        taps = taps[:79]
    with pytest.raises(ValueError):
        vk.halfband_polyphase_taps(taps)


def _polyphase_cascade(x, n_levels, folded):
    """The cascade on the even and odd phases of each level, with zero beyond
    each level's edges: y[m] = sum_{q=19..0} p_q O[m-1-q] + c E[m] +
    sum_{q=0..19} p_q O[m+q] in that order (as the kernel sums it), or with
    each pair folded, sum_q p_q (O[m-1-q] + O[m+q]) + c E[m]."""
    poly = torch.tensor(vk.halfband_polyphase_taps(halfband_decimation_filter()))
    levels = []
    for _ in range(n_levels):
        e, o = x[:, 0::2], x[:, 1::2]
        m = e.shape[1]
        o_pad = F.pad(o, (vk.PAIRS, vk.PAIRS))  # o_pad[j] = O[j - 20]

        def left(q):  # O[m-1-q]
            return o_pad[:, vk.PAIRS - 1 - q : vk.PAIRS - 1 - q + m]

        def right(q):  # O[m+q]
            return o_pad[:, vk.PAIRS + q : vk.PAIRS + q + m]

        acc = torch.zeros_like(e)
        if folded:
            for q in range(vk.PAIRS - 1, -1, -1):
                acc = acc + poly[1 + q] * (left(q) + right(q))
            acc = acc + poly[0] * e
        else:
            for q in range(vk.PAIRS - 1, -1, -1):
                acc = acc + poly[1 + q] * left(q)
            acc = acc + poly[0] * e
            for q in range(vk.PAIRS):
                acc = acc + poly[1 + q] * right(q)
        x = acc
        levels.append(x)
    return levels


@pytest.mark.parametrize("folded", [False, True], ids=["tap_order", "folded"])
@pytest.mark.parametrize("length", [256 * 40, 256 * 257])
def test_polyphase_cascade_matches_plain(length, folded):
    x = torch.tensor(_signal(length, (2, length)))
    got = _polyphase_cascade(x, 7, folded)
    ref = vk.decimation_cascade_plain(x, 7)
    for s, (g, r) in enumerate(zip(got, ref), start=1):
        assert g.shape == r.shape == (2, length >> s)
        torch.testing.assert_close(g, r, rtol=CASCADE_ATOL, atol=CASCADE_ATOL, msg=lambda m: f"level {s}: {m}")


@pytest.mark.parametrize("length", [256 * 40, 256 * 257])
def test_packed_levels_split_back_into_the_plain_levels(length):
    x = torch.tensor(_signal(length + 2, (2, length)))
    packed = vk.decimation_cascade_packed(x, 7)
    ref = vk.decimation_cascade_plain(x, 7)
    assert packed.shape == (2, sum(vk.level_lengths(length, 7)))
    assert packed.stride() == (-(-packed.shape[1] // 4) * 4, 1)  # rows padded to 16 bytes
    got = vk.unpack_levels(packed, length)
    assert len(got) == 7
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("length", LENGTHS)
def test_octave_table_points_at_each_octaves_level(length):
    p = XQTParams()
    x0 = vk.cascade_input(torch.tensor(_signal(length + 3, (1, length))), p)
    packed = vk.decimation_cascade_packed(x0, p.n_octaves - 1)
    levels = (x0,) + vk.decimation_cascade_plain(x0, p.n_octaves - 1)
    table = vk.octave_table(p, x0.shape[1])
    assert table.dtype == torch.int64 and tuple(table.shape) == (p.n_octaves, len(vk.PLAN_COLUMNS))
    for (j, dec, row, offset, hop), entry in zip(vk.octave_plan(p), table.tolist()):
        src, level_off, frame_off, t_hop, t_row, bank = entry
        assert (frame_off, t_hop, t_row, bank) == (offset, hop, row, j)
        n = levels[dec].shape[1]
        source = x0 if src == 0 else packed
        torch.testing.assert_close(source[:, level_off:level_off + n], levels[dec], rtol=0, atol=0)


# 8,256 samples give a cascade input of 291 x 256 samples: with an odd
# multiple of 256, the packed levels fill 2 mod 4 floats of a row.
@pytest.mark.parametrize("length", LENGTHS + [8256])
def test_octave_frames_start_16_byte_aligned(length):
    """The octave kernel copies a block's frames 16 bytes at a time where its
    source row, level and frames all start 16-byte aligned: every octave but
    the hop-2 one, on every batch row."""
    p = XQTParams()
    x0 = vk.cascade_input(torch.tensor(_signal(length + 5, (3, length))), p)
    packed = vk.decimation_cascade_packed(x0, p.n_octaves - 1)
    assert x0.stride(0) % 4 == 0 and packed.stride(0) % 4 == 0
    for _, level_off, frame_off, hop, _, _ in vk.octave_table(p, x0.shape[1]).tolist():
        assert (level_off + frame_off) % 4 == 0 or hop % 4 != 0
        assert hop % 4 == 0 or hop == 2


@pytest.mark.parametrize("fault", ["overrun", "mid_level", "not_packed"])
def test_octaves_refuse_frames_outside_their_level(fault):
    p = XQTParams()
    x0 = vk.cascade_input(torch.tensor(_signal(11, (1, 8000))), p)
    len0 = x0.shape[1]
    packed = vk.decimation_cascade_packed(x0, p.n_octaves - 1)
    table = vk.octave_table(p, len0)
    banks = vk.octave_banks(p, torch.device("cpu"))
    out = torch.empty(1, p.n_bins, p.num_frames(8000))
    j = 1  # octave 1 frames level 6, which level 7 follows in the packed row
    hop = int(table[j, 3])
    fits = (len0 >> 6) - (out.shape[2] - 1) * hop - vk.WINDOW  # the last frame ends at the level's end
    table[j, 2] = fits
    vk.octaves_log_xqt(x0, packed, table, banks, out, log_eps=p.log_eps)
    if fault == "overrun":  # one sample into level 7
        table[j, 2] = fits + 1
        match = "run past their level"
    elif fault == "mid_level":
        table[j, 1] += 4
        match = "bad plan row"
    else:
        packed = packed[:, :-1]
        match = "not the packed levels"
    with pytest.raises(ValueError, match=match):
        vk.octaves_log_xqt(x0, packed, table, banks, out, log_eps=p.log_eps)


@pytest.mark.parametrize("length", LENGTHS)
def test_octaves_plain_matches_loop_and_pallas(length):
    p = XQTParams()
    y = _signal(length + 7, (2, length))
    x0 = vk.cascade_input(torch.tensor(y), p)
    packed = vk.decimation_cascade_packed(x0, p.n_octaves - 1)
    levels = (x0,) + vk.decimation_cascade_plain(x0, p.n_octaves - 1)
    banks = vk.octave_banks(p, torch.device("cpu"))
    n_frames = p.num_frames(length)
    got = torch.full((2, p.n_bins, n_frames), float("nan"))
    vk.octaves_log_xqt(x0, packed, vk.octave_table(p, x0.shape[1]), banks, got, log_eps=p.log_eps)
    loop = torch.full_like(got, float("nan"))
    for j, dec, row, offset, hop in vk.octave_plan(p):
        vk.octave_log_xqt_plain(levels[dec], banks[j], loop, row=row, offset=offset, hop=hop, log_eps=p.log_eps)
    torch.testing.assert_close(got, loop, rtol=0, atol=0)
    ref = np.asarray(log_xqt_pallas(jnp.asarray(y), JParams(), interpret=True, fused_cascade=True))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=VQT_ATOL)
