"""Spleeter's decoder kernel (csrc/deconv_fprop.cu, ops/cuda/deconv_kernel.py).

On the CPU: the kernel's four sub-pixel phases and folded epilogue in
PyTorch (``block_plain``) against the module path ``bn(relu(up(deconv,
cat([skip, u]))))`` at each decoder block of the small config that
tests/test_torch_spleeter.py uses and at published widths; the layout rule
at the six published decoder shapes; the dispatch in ``UNet.forward``; the
``spleeter.deconv_launch`` counter; the benchmark's reader of it.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one. The file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_deconv_kernel.py -q

On the card: each published decoder block at S = 3 against float64
``F.conv_transpose2d`` with ReLU and BatchNorm, within the rounding bound of
the kernel's float32 sums; two runs bit for bit; a CUDA-graph replay equal to
the eager call; a replay after ``load_state_dict`` reading the new weights;
``Spleeter.separate`` at published widths within the ETL cell's limits; and
the kernel's name as the profiler reports it in the reader of
``unet_roofline.etl``.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from zeronotesamba_torch.models import spleeter
from zeronotesamba_torch.ops.cuda import deconv_kernel as dk
from zeronotesamba_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
ROUNDING = 2.0 ** -24  # float32's unit roundoff
# (c_skip, c_u, h, w, cout) of a U-Net's six decoder blocks at the published
# widths (512 x 1,024 segments) and in the small config (64 x 128, filters 2 to 64).
PUBLISHED = [(0, 512, 8, 16, 256), (256, 256, 16, 32, 128), (128, 128, 32, 64, 64), (64, 64, 64, 128, 32),
             (32, 32, 128, 256, 16), (16, 16, 256, 512, 1)]
SMALL = [(0, 64, 1, 2, 32), (32, 32, 2, 4, 16), (16, 16, 4, 8, 8), (8, 8, 8, 16, 4), (4, 4, 16, 32, 2),
         (2, 2, 32, 64, 1)]
H100_SMS = 132


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _block(c_skip, c_u, h, w, cout, batch, seed, device="cpu", dtype=torch.float32):
    """Seeded inputs and modules of one decoder block, as Spleeter.reset_parameters draws them."""
    g = torch.Generator().manual_seed(seed)
    cin = c_skip + c_u
    deconv = nn.ConvTranspose2d(cin, cout, 5, stride=2, padding=1)
    bn = nn.BatchNorm2d(cout, eps=1e-3)
    with torch.no_grad():
        bound = 1.0 / math.sqrt(cin * 25)
        for p in (deconv.weight, deconv.bias):
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
        bn.weight.copy_(0.8 + 0.4 * torch.rand(cout, generator=g))
        bn.bias.copy_(0.1 * torch.randn(cout, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(cout, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(cout, generator=g))
    skip = torch.randn(batch, c_skip, h, w, generator=g) if c_skip else None
    u = torch.randn(batch, c_u, h, w, generator=g)
    deconv, bn = deconv.to(device, dtype).eval(), bn.to(device, dtype).eval()
    return (None if skip is None else skip.to(device, dtype)), u.to(device, dtype), deconv, bn


def _module_path(skip, u, deconv, bn):
    x = u if skip is None else torch.cat([skip, u], dim=1)
    return bn(F.relu(spleeter.up(deconv, x)))


@pytest.mark.parametrize("shape", SMALL + [PUBLISHED[0]],
                         ids=[f"small{k + 1}" for k in range(len(SMALL))] + ["published1"])
def test_four_phases_and_folded_epilogue_are_the_module_path(shape):
    skip, u, deconv, bn = _block(*shape, batch=2 if shape in SMALL else 1, seed=sum(shape), dtype=torch.float64)
    with torch.no_grad():
        want = _module_path(skip, u, deconv, bn)
        got = dk.block_plain(skip, u, deconv, bn)
        assert got.shape == want.shape == (u.shape[0], shape[4], 2 * shape[2], 2 * shape[3])
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        # In float32, the dtype the kernel runs in, they differ by the order of the sums only.
        args = [None if t is None else t.float() for t in (skip, u)] + [deconv.float(), bn.float()]
        torch.testing.assert_close(dk.decoder_block(*args), _module_path(*args), rtol=1e-5, atol=1e-5)


def test_phase_weights_use_each_tap_once():
    w = torch.arange(2 * 3 * 25, dtype=torch.float64).view(2, 3, 5, 5) + 1
    pw = dk.phase_weights(w)
    assert pw.shape == (2, 2, 3, 2, 3, 3)
    # Phases (even, even) 2 x 2 taps, (even, odd) 2 x 3, (odd, even) 3 x 2, (odd, odd) 3 x 3: 25 in all.
    assert [int((pw[py, px, 0, 0] != 0).sum()) for py in range(2) for px in range(2)] == [4, 6, 6, 9]
    assert sorted(pw[:, :, 0, 0][pw[:, :, 0, 0] != 0].tolist()) == sorted(w[0, 0].flatten().tolist())


def _occupancy_model(tco, pr, smem):
    """An H100-like SM: 227 KB of shared memory a block, 228 KB an SM, and
    the kernel's register limit (1 block at 128 sums a lane, 2 below)."""
    if smem > dk.MAX_SMEM_BYTES:
        return 0
    return min(1 if tco * pr >= 8 else 2, 233472 // (smem + 1024))


@pytest.mark.parametrize("segments", [1, 2, 3, 4])
@pytest.mark.parametrize("block", range(6), ids=[f"block{k + 1}" for k in range(6)])
def test_layout_rule_fits_each_published_block(block, segments):
    c_skip, c_u, h, w, cout = PUBLISHED[block]
    layout = dk.pick_layout(segments, c_skip + c_u, h, w, cout, H100_SMS, _occupancy_model)
    assert layout in set(dk.candidates(cout, w))
    assert layout.n_wp * layout.n_cg * layout.n_kg == dk.WARPS and layout.chans % layout.n_kg == 0
    assert cout % (layout.n_cg * layout.tco) == 0 and (layout.tco, layout.pr) in dk.INSTANCES
    assert dk.smem_bytes(layout) <= dk.MAX_SMEM_BYTES
    assert _occupancy_model(layout.tco, layout.pr, dk.smem_bytes(layout)) >= 1
    rows, cols = dk.block_tile(layout)
    assert cols <= max(w, 16) and dk.blocks(segments, h, w, cout, layout) >= 1
    # The same shape gives the same layout: nothing but the shape decides.
    assert dk.pick_layout(segments, c_skip + c_u, h, w, cout, H100_SMS, _occupancy_model) == layout


def test_layout_rule_raises_where_nothing_fits():
    with pytest.raises(ValueError):
        dk.pick_layout(1, 64, 8, 16, 32, H100_SMS, lambda *a: 0)


@pytest.mark.parametrize("case", ["cuda_eval_no_grad", "cpu", "training", "grad_on", "float64"])
def test_dispatch_takes_the_kernel_only_on_a_card_in_eval_without_grad(case):
    x = SimpleNamespace(is_cuda=case != "cpu", dtype=torch.float64 if case == "float64" else torch.float32)
    with torch.set_grad_enabled(case == "grad_on"):
        assert spleeter.takes_kernel(x, case == "training") == (case == "cuda_eval_no_grad")


@pytest.mark.parametrize("case", ["eval_no_grad", "training", "grad_on"])
def test_unet_on_the_cpu_runs_the_modules(case, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(dk, "decoder_block", refuse)
    cfg = spleeter.SpleeterConfig(filters=(2, 4, 8, 16, 32, 64), T=64, F=128)
    net = spleeter.UNet(cfg).train(case == "training")
    x = torch.rand(1, 2, 64, 128, generator=torch.Generator().manual_seed(3))
    with torch.set_grad_enabled(case == "grad_on"):
        out = net(x)
    assert out.shape == x.shape and out.requires_grad == (case == "grad_on")


def test_counter_reads_zero_on_the_cpu():
    cfg = spleeter.SpleeterConfig(filters=(2, 4, 8, 16, 32, 64), T=64, F=128)
    model = spleeter.Spleeter(cfg)
    model.reset_parameters(torch.Generator().manual_seed(5))
    model.eval()
    sig = np.random.default_rng(7).standard_normal(3 * 44100).astype(np.float32) * 0.1
    before = profiling.totals()
    model.separate(sig, 44100)
    after = profiling.totals()
    assert "spleeter.deconv_launch" in after
    assert after["spleeter.deconv_launch"] == before.get("spleeter.deconv_launch", 0)
    assert after["deconv_launch.fprop"] == before["deconv_launch.fprop"]
    assert after["spleeter.unet_launch"] == before.get("spleeter.unet_launch", 0) + 4


def _reader():
    path = ROOT / "benchmark" / "metrics" / "deconv_launches_per_song.etl.py"
    spec = importlib.util.spec_from_file_location("deconv_launches_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reader_reads_the_counter_per_record(monkeypatch):
    from benchmark import program_trace

    # Two records with 24 launches each (one counted under a nested span), a record's count outside
    # every span, and another counter.
    Span, Count = profiling.Span, profiling.Count
    spans = [Span("record", 1.0, 2.0, -1, 1), Span("record.separate", 1.1, 1.9, 0, 1), Span("record", 2.0, 3.0, -1, 2),
             Span("harness", 3.0, 3.5, -1, 2)]
    counts = [Count("spleeter.deconv_launch", 24, 1), Count("spleeter.deconv_launch", 24, 2),
              Count("spleeter.deconv_launch", 24, 3), Count("spleeter.deconv_launch", 24, -1),
              Count("spleeter.segments", 3, 1)]
    window = program_trace.Window({}, spans, counts, 0.0)
    monkeypatch.setattr(program_trace, "load", lambda ctx: window)
    monkeypatch.setitem(profiling._totals, "spleeter.deconv_launch", 96)
    assert _reader().read({}) == 24.0


def test_reader_reads_nothing_without_the_counter(monkeypatch):
    from benchmark import program_trace

    monkeypatch.setattr(program_trace, "load", lambda ctx: program_trace.Window({}, [], [], 0.0))
    monkeypatch.setattr(profiling, "_totals", {k: v for k, v in profiling._totals.items()
                                               if k != "spleeter.deconv_launch"})
    assert _reader().read({}) is None
    monkeypatch.setitem(profiling._totals, "spleeter.deconv_launch", 0)
    monkeypatch.setattr(program_trace, "load", lambda ctx: None)
    assert _reader().read({}) is None


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from zeronotesamba_torch.device import disable_tf32

    disable_tf32()
    return torch.device("cuda")


def _float64_and_bound(skip, u, deconv, bn):
    """The block in float64 from the same float32 inputs, and a bound on the
    kernel's error: each output's sum holds at most 9 cin products and the
    bias in float32 FFMA chains and their in-order adds, each rounding at
    most u times the float64 sum of |terms| so far; then the folded
    BatchNorm's few roundings, relative to its output."""
    x = (u if skip is None else torch.cat([skip, u], 1)).double()
    w, b = deconv.weight.double(), deconv.bias.double()
    z = F.conv_transpose2d(x, w, b, stride=2, padding=1)[..., :-1, :-1]
    za = F.conv_transpose2d(x.abs(), w.abs(), b.abs(), stride=2, padding=1)[..., :-1, :-1]
    scale = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    shift = bn.bias.double() - bn.running_mean.double() * scale
    v = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
    ref = F.relu(z) * v(scale) + v(shift)
    bound = (9 * x.shape[1] + 10) * ROUNDING * za * v(scale.abs()) + 8 * ROUNDING * (
        F.relu(z) * v(scale.abs()) + v(shift.abs()))
    return ref, bound


@pytest.mark.cuda
@pytest.mark.parametrize("block", range(6), ids=[f"block{k + 1}" for k in range(6)])
def test_card_block_against_float64_and_repeats(cuda, block):
    skip, u, deconv, bn = _block(*PUBLISHED[block], batch=3, seed=40 + block, device=cuda)
    before = profiling.totals("deconv_launch.")["fprop"]
    with torch.inference_mode():
        y = dk.decoder_block(skip, u, deconv, bn)
        y2 = dk.decoder_block(skip, u, deconv, bn)
        ref, bound = _float64_and_bound(skip, u, deconv, bn)
    torch.cuda.synchronize()
    assert profiling.totals("deconv_launch.")["fprop"] == before + 2
    assert y.shape == ref.shape and torch.equal(y, y2)
    ratio = ((y.double() - ref).abs() / bound).max().item()
    assert ratio <= 1.0, ratio
    layout = dk.layout_for(skip, u, PUBLISHED[block][4])
    assert dk.library_smem_bytes(*PUBLISHED[block], layout) == dk.smem_bytes(layout)


@pytest.mark.cuda
def test_card_graph_replay_equals_the_eager_call_and_reads_new_weights(cuda):
    skip, u, deconv, bn = _block(*PUBLISHED[2], batch=3, seed=50, device=cuda)
    with torch.inference_mode():
        eager = dk.decoder_block(skip, u, deconv, bn)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = dk.decoder_block(skip, u, deconv, bn)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        _, _, deconv2, bn2 = _block(*PUBLISHED[2], batch=3, seed=51, device=cuda)
    deconv.load_state_dict(deconv2.state_dict())
    bn.load_state_dict(bn2.state_dict())
    with torch.inference_mode():
        graph.replay()
        fresh = dk.decoder_block(skip, u, deconv, bn)
    torch.cuda.synchronize()
    assert not torch.equal(fresh, eager) and torch.equal(out, fresh)


@pytest.mark.cuda
def test_card_separate_replays_new_weights_after_load_state_dict(cuda):
    from benchmark.reference import spleeter as ref

    cfg = spleeter.SpleeterConfig(filters=(2, 4, 8, 16, 32, 64), T=64, F=128)
    small = dict(json.loads((ROOT / "benchmark" / "configs" / "spleeter_4stems.json").read_text()),
                 conv_n_filters=list(cfg.filters), T=cfg.T, F=cfg.F)
    limits = json.loads((ROOT / "benchmark" / "limits" / "spleeter-etl-30s.json").read_text())
    with torch.device("cuda"):
        m = spleeter.Spleeter(cfg)
    m.reset_parameters(torch.Generator().manual_seed(1))
    m.eval()
    sig = np.random.default_rng(2).standard_normal(3 * 44100).astype(np.float32) * 0.1
    before = profiling.totals()
    m.separate(sig, 44100)  # runs the stages, then captures them
    assert profiling.totals()["spleeter.deconv_launch"] - before.get("spleeter.deconv_launch", 0) == 24
    other = spleeter.Spleeter(cfg)
    other.reset_parameters(torch.Generator().manual_seed(9))
    m.load_state_dict(other.state_dict())
    mid = profiling.totals()
    m.separate(sig, 44100)  # replays the graphs
    assert profiling.totals()["spleeter.deconv_launch"] - mid["spleeter.deconv_launch"] == 24
    assert profiling.totals("deconv_launch.")["fprop"] == mid["deconv_launch.fprop"]
    from zeronotesamba_torch.models.weights import spleeter_source_from_state_dict

    w = {k: torch.as_tensor(v, device="cuda")
         for k, v in spleeter_source_from_state_dict(other.state_dict(), cfg.instruments).items()}
    gap = float((m.last["masks"] - ref.masks(w, m.last["magnitude"], small)).abs().max())
    assert gap <= limits["mask_gap"], gap


@pytest.mark.cuda
def test_card_separate_at_published_widths_within_the_cell_limits(cuda):
    from benchmark.reference import spleeter as ref
    from benchmark.reference.songs import click_track
    from zeronotesamba_torch.models.weights import spleeter_source_from_state_dict

    cfg = json.loads((ROOT / "benchmark" / "configs" / "spleeter_4stems.json").read_text())
    limits = json.loads((ROOT / "benchmark" / "limits" / "spleeter-etl-30s.json").read_text())
    with torch.device("cuda"):
        m = spleeter.Spleeter()
    m.reset_parameters(torch.Generator().manual_seed(3))
    m.eval()
    sig, _ = click_track(30.0, 120.0, 44100, harmonics=3, burst=0.2, offbeat=0.3, seed=8)
    for call in range(2):  # the eager run, then the graphs' replay
        anchor, positive = m.separate(sig, 44100)
        last = m.last
        w = {k: torch.as_tensor(v, device="cuda")
             for k, v in spleeter_source_from_state_dict(m.state_dict(), m.cfg.instruments).items()}
        spec = ref.stft(sig, cfg, "cuda")
        mag = ref.magnitude(spec, cfg, torch.float64)
        streams = ref.streams(spec, last["masks"], len(sig), cfg)
        got = torch.tensor(np.stack([anchor, positive]), dtype=torch.float64, device="cuda")
        gaps = {"spec_gap": float((last["magnitude"].double() - mag).abs().max() / mag.max()),
                "mask_gap": float((last["masks"] - ref.masks(w, last["magnitude"], cfg)).abs().max()),
                "stream_gap": float(((got - streams).abs().amax(-1) / streams.abs().amax(-1)).max())}
        assert all(gaps[k] <= limits[k] for k in gaps), (call, gaps)


@pytest.mark.cuda
def test_card_profiler_name_is_counted_by_the_unet_roofline_reader(cuda):
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "benchmark" / "metrics" / "unet_roofline.etl.py"
    spec = importlib.util.spec_from_file_location("unet_roofline_reader", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    skip, u, deconv, bn = _block(*PUBLISHED[4], batch=1, seed=60, device=cuda)
    with torch.inference_mode():
        dk.decoder_block(skip, u, deconv, bn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dk.decoder_block(skip, u, deconv, bn)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "deconv_fprop_kernel" in n]
    assert ours and all(reader.unet_kernel(n) for n in ours), names
