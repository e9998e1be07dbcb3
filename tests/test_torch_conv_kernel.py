"""The encoders' conv wrapper (ops/cuda/conv_kernel.py) on the CPU.

On CPU tensors ``conv2d`` is ``F.conv2d`` itself; these tests hold it to
that at every encoder conv, under both paddings the encoder uses (SAME on
one card, frequency only on a mesh's time axis), check ``ConvFprop``'s
gradients (the card's autograd route, plain forward here) by gradcheck in
float64 and against ``F.conv2d``'s, what the wrapper refuses, the launch
counters, the encoder's dispatch by dtype, the forward's block-layout rule,
the weight gradient's split of its sum, and the benchmark's readers of the
launch counters. The kernels themselves run only on a card
(tests/test_torch_conv_cuda.py).
"""

import importlib.util
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from zeronotesamba_torch.models import encoder as enc
from zeronotesamba_torch.models.encoder import CONV_SPECS, POOL_AFTER
from zeronotesamba_torch.ops.cuda import conv_kernel as ck
from zeronotesamba_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _conv_shape(i):
    """(cin, h) at conv i of the encoder."""
    h, cin = 96, 1
    for j in range(i):
        cin = CONV_SPECS[j][0]
        h //= POOL_AFTER.get(j, 1)
    return cin, h


def _inputs(i, batch, frames, same, seed=0):
    cin, h = _conv_shape(i)
    cout, (kh, kw) = CONV_SPECS[i]
    g = torch.Generator().manual_seed(seed)
    t = frames if same else frames + 2 * (kw // 2)
    x = torch.randn(batch, cin, h, t, generator=g)
    w = torch.randn(cout, cin, kh, kw, generator=g) * (2.0 / (cin * kh * kw)) ** 0.5
    b = 0.1 * torch.randn(cout, generator=g)
    return x, w, b, ((kh // 2, kw // 2) if same else (kh // 2, 0))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("same", [True, False], ids=["same", "mesh"])
@pytest.mark.parametrize("i", range(len(CONV_SPECS)), ids=[f"cv{i + 1}" for i in range(len(CONV_SPECS))])
def test_wrapper_equals_conv2d_on_cpu(i, same, batch):
    x, w, b, padding = _inputs(i, batch, 24, same, seed=i)
    got = ck.conv2d(x, w, b, padding)
    want = F.conv2d(x, w, b, padding=padding)
    assert got.shape == want.shape == (batch, w.shape[0], x.shape[2], 24)
    assert torch.equal(got, want)


@pytest.mark.parametrize("padding", [(1, 5), (1, 0), (0, 2)])
def test_function_gradcheck_float64(padding):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2, 4, 14, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(8, 2, 3, 11, dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn(8, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, w, b: ck.ConvFprop.apply(x, w, b, padding), (x, w, b))
    assert torch.autograd.gradcheck(lambda x, w: ck.ConvFprop.apply(x, w, None, padding), (x, w))


@pytest.mark.parametrize("i", [0, 3, 7], ids=["cv1", "cv4", "cv8"])
def test_function_gradients_equal_conv2d(i):
    x, w, b, padding = _inputs(i, 2, 20, True, seed=5)
    gy = torch.randn(2, w.shape[0], x.shape[2], 20, generator=torch.Generator().manual_seed(6))
    grads = []
    for fn in (lambda x, w, b: ck.ConvFprop.apply(x, w, b, padding), lambda x, w, b: F.conv2d(x, w, b, padding=padding)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        fn(*leaves).backward(gy)
        grads.append([t.grad for t in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_function_leaves_out_the_input_gradient_it_does_not_need():
    x, w, b, padding = _inputs(0, 1, 20, True)
    w.requires_grad_(True)
    ck.ConvFprop.apply(x, w, b, padding).sum().backward()
    assert x.grad is None and w.grad is not None and b.grad is None


@pytest.mark.parametrize("case", ["bfloat16", "non_contiguous", "3d", "weight_dtype", "channels", "padding"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    x, w, b, padding = _inputs(1, 2, 20, True)
    if case == "bfloat16":
        args, err = (x.bfloat16(), w, b, padding), TypeError
    elif case == "non_contiguous":
        args, err = (x.transpose(2, 3).contiguous().transpose(2, 3), w, b, padding), ValueError
    elif case == "3d":
        args, err = (x[0], w, b, padding), ValueError
    elif case == "weight_dtype":
        args, err = (x, w.double(), b, padding), TypeError
    elif case == "channels":
        args, err = (x[:, :3].contiguous(), w, b, padding), ValueError
    else:
        args, err = (x, w, b, (-1, 0)), ValueError
    with pytest.raises(err):
        ck.conv2d(*args)


def test_launch_counter_registered_at_zero_on_import():
    code = ("from zeronotesamba_torch.ops.cuda import conv_kernel\n"
            "from zeronotesamba_torch.utils import profiling\n"
            "print(profiling.totals('conv_launch.'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'fprop': 0, 'wgrad': 0}"


def test_cpu_calls_launch_nothing():
    before = profiling.totals("conv_launch.")
    x, w, b, padding = _inputs(2, 1, 16, True)
    ck.conv2d(x, w, b, padding)
    assert "fprop" in before and profiling.totals("conv_launch.") == before


def test_cpu_backward_launches_nothing():
    before = profiling.totals("conv_launch.")
    x, w, b, padding = _inputs(2, 1, 16, True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    ck.conv2d(x, w, b, padding).sum().backward()
    assert w.grad is not None and b.grad is not None
    assert "wgrad" in before and profiling.totals("conv_launch.") == before


@pytest.mark.parametrize("same", [True, False], ids=["same", "mesh"])
@pytest.mark.parametrize("i", [1, 6], ids=["cv2", "cv7"])
def test_wgrad_plain_equals_conv2d_gradients(i, same):
    x, w, b, padding = _inputs(i, 2, 20, same, seed=7)
    gy = torch.randn(2, w.shape[0], x.shape[2], 20, generator=torch.Generator().manual_seed(8))
    gw, gb = ck.wgrad_plain(x, gy, w, padding, True)
    leaves = [t.clone().requires_grad_(True) for t in (w, b)]
    F.conv2d(x, *leaves, padding=padding).backward(gy)
    assert torch.equal(gw, leaves[0].grad) and torch.equal(gb, leaves[1].grad)
    assert ck.wgrad_plain(x, gy, w, padding, False)[1] is None


def test_wgrad_refuses_cpu_tensors():
    x, w, _, padding = _inputs(1, 1, 20, True)
    gy = torch.zeros(1, w.shape[0], x.shape[2], 20)
    with pytest.raises(ValueError, match="card"):
        ck.wgrad(x, gy, w.shape[2], w.shape[3], padding, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_dispatch_by_dtype(monkeypatch, dtype):
    """float32 convs go to the port's wrapper, bfloat16 ones to F.conv2d."""
    wrapped, plain = [], []
    real_wrapper, real_conv2d = ck.conv2d, F.conv2d

    def spy_wrapper(h, *a):
        wrapped.append(h.dtype)
        return real_wrapper(h, *a)

    def spy_conv2d(h, *a, **kw):
        plain.append(h.dtype)
        return real_conv2d(h, *a, **kw)

    monkeypatch.setattr(ck, "conv2d", spy_wrapper)
    monkeypatch.setattr(enc.F, "conv2d", spy_conv2d)
    model = enc.Encoder(dropout_rate=0.0, compute_dtype=dtype).eval()
    x = torch.randn(1, 1, 96, 16) * 4 - 6
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 128, 16) and out.dtype == torch.float32
    if dtype == torch.float32:
        # The wrapper's plain version on the CPU is F.conv2d: eight calls each.
        assert wrapped == [torch.float32] * 8 and plain == [torch.float32] * 8
    else:
        assert wrapped == [] and plain == [torch.bfloat16] * 8


def _occupancy_model(kh, kw, tco, rows, stages, chans):
    """An H100-like SM: 227 KB of shared memory a block, 228 KB an SM, and
    the kernel's register limit (2 blocks at 8 channels a thread, 4 below)."""
    stage = chans * ((rows + kh - 1) * ck.tile_len(kw, rows) + kh * kw * ck.WARPS * tco)
    if 4 * stages * stage > 232448:
        return 0
    return min(2 if tco == 8 else 4, 233472 // (4 * stages * stage + 1024))


@pytest.mark.parametrize("shape,batch,frames", [("song", 1, 1876), ("finetune", 8, 1920), ("pretext", 16, 313)])
def test_pick_tiles_fits_every_encoder_conv(shape, batch, frames):
    for i, (cout, (kh, kw)) in enumerate(CONV_SPECS):
        cin, h = _conv_shape(i)
        tiles = ck.pick_tiles(batch, cin, cout, kh, kw, h, frames, 132, _occupancy_model)
        assert tiles.co_per_thread in ck.CO_PER_THREAD and tiles.rows <= h
        assert tiles.stages in ck.STAGES and tiles.chans in ck.CHANNELS
        assert _occupancy_model(kh, kw, *tiles) >= 1
        # Every conv over more than one frequency row fills the card at 8 channels a thread.
        if h > 1:
            assert tiles.co_per_thread == 8, (shape, i, tiles)


@pytest.mark.parametrize("batch,frames,tco", [(1, 1876, 1), (16, 313, 2), (8, 1920, 8)],
                         ids=["song", "pretext", "finetune"])
def test_pick_tiles_takes_fewer_channels_a_thread_where_eight_leave_sms_idle(batch, frames, tco):
    # Conv 7 (256 -> 128 channels over one row): 16, 64 and 128 blocks at 8 channels a thread.
    assert ck.pick_tiles(batch, 256, 128, 1, 23, 1, frames, 132, _occupancy_model).co_per_thread == tco


# csrc/conv_wgrad.cu's layout of each encoder conv (zns_wgrad_layout): blocks
# a split, weight and bias partial sums a split (floats). Its chunks hold 64
# frames of one (batch row, output row), each bias partial 16 of them.
# test_wgrad_layout_is_the_tables holds the card's library to these.
WGRAD_LAYOUTS = [(1, 2112, 256), (28, 372736, 256), (40, 614400, 512), (288, 2654208, 512), (192, 1966080, 1024),
                 (640, 7208960, 1024), (64, 786432, 512), (32, 425984, 512)]
WGRAD_SHAPES = [("song", 1, 1876, True), ("finetune", 8, 1920, True), ("pretext", 16, 313, True),
                ("mesh_t4", 8, 480, False)]
H100_SLOTS = 132 * 2  # SMs x the kernel's blocks an SM (2 at every width on an H100)


def _wgrad_layout(i, batch, frames):
    return ck.WgradLayout(batch * _conv_shape(i)[1] * math.ceil(frames / 64), *WGRAD_LAYOUTS[i], 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch,frames,same", WGRAD_SHAPES, ids=[s[0] for s in WGRAD_SHAPES])
def test_wgrad_layout_is_the_tables(shape, batch, frames, same):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the layout comes from the CUDA library)")
    for i, (cout, (kh, kw)) in enumerate(CONV_SPECS):
        cin, h = _conv_shape(i)
        padding = (kh // 2, kw // 2) if same else (kh // 2, 0)
        x = torch.empty(batch, cin, h, frames if same else frames + 2 * (kw // 2), device="cuda")
        assert ck.wgrad_plan(x, cout, kh, kw, padding)[0] == _wgrad_layout(i, batch, frames), (shape, i)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert n_sm != 132 or n_sm * ck._wgrad_occupancy(0, kw) == H100_SLOTS, kw


@pytest.mark.parametrize("shape,batch,frames,same", WGRAD_SHAPES, ids=[s[0] for s in WGRAD_SHAPES])
def test_plan_wgrad_fits_every_encoder_conv(shape, batch, frames, same):
    for i in range(len(CONV_SPECS)):
        layout = _wgrad_layout(i, batch, frames)
        plan = ck.plan_wgrad(layout, H100_SLOTS)
        assert plan.chunks == layout.chunks
        # The splits cover the sum's chunks once each, every split some.
        ranges = [(k * plan.chunks_per_split, min((k + 1) * plan.chunks_per_split, plan.chunks))
                  for k in range(plan.splits)]  # as csrc/conv_wgrad.cu takes them
        assert len(ranges) == plan.splits <= 65535 and all(a < b for a, b in ranges)
        assert [k for a, b in ranges for k in range(a, b)] == list(range(plan.chunks))
        assert plan.workspace_bytes == 4 * plan.splits * (layout.floats + layout.bias_floats)
        assert plan.workspace_bytes <= ck.WGRAD_WORKSPACE_BYTES
        # Every plan fills the card: nine tenths of a wave of blocks or more.
        assert layout.blocks * plan.splits >= 0.9 * H100_SLOTS, (shape, i, plan)


def test_plan_wgrad_keeps_the_partial_sums_within_the_workspace():
    # 256 -> 256 channels at 9 x 25 (2 groups of 13 taps a row): 61 MB of partial sums a split, so at most 4 splits.
    layout = ck.WgradLayout(8 * 32 * 30, 288 * 4, 256 * 256 * 9 * 2 * 13, 256 * 4, 64, 16)
    plan = ck.plan_wgrad(layout, H100_SLOTS)
    assert plan.splits <= 4 and plan.workspace_bytes <= ck.WGRAD_WORKSPACE_BYTES
    with pytest.raises(ValueError, match="do not fit"):
        ck.plan_wgrad(layout._replace(floats=16 * layout.floats), H100_SLOTS)


def test_wgrad_chains_count_a_split_and_the_partials():
    layout = _wgrad_layout(3, 8, 1920)
    plan = ck.plan_wgrad(layout, H100_SLOTS)
    assert ck.wgrad_chains(layout, plan) == (64 * plan.chunks_per_split + plan.splits,
                                             16 * plan.chunks_per_split + 4 * plan.splits)


def _chained(terms, parts=1):
    """float32 sums of float64 ``terms`` (..., K) in the kernel's order:
    ``parts`` chains, chain q over the q-th of ``parts`` runs of each chunk
    of 64 terms, from zero, each step one rounding of the exact sum (as an
    FFMA rounds); then the chains added in order."""
    k = terms.shape[-1]
    runs = terms.reshape(*terms.shape[:-1], k // 64, parts, 64 // parts)
    acc = torch.zeros(*terms.shape[:-1], parts)
    for c in range(runs.shape[-3]):
        for f in range(runs.shape[-1]):
            acc = (acc.double() + runs[..., c, :, f]).float()
    total = torch.zeros(terms.shape[:-1])
    for q in range(parts):
        total = total + acc[..., q]
    return total


@pytest.mark.parametrize("frames", [1024, 2048])
@pytest.mark.parametrize("same", [True, False], ids=["same", "mesh"])
def test_wgrad_reference_bounds_the_kernels_order_and_not_a_short_sum(same, frames):
    """float32 sums in the kernel's order for one split lie within both of
    ``wgrad_reference``'s bounds; the same sums short of 5% of their frames
    lie far outside the probable one."""
    g = torch.Generator().manual_seed(frames + same)
    kw, cin, cout = 11, 2, 3
    padding = (0, 5) if same else (0, 0)
    x = torch.randn(1, cin, 1, frames + (0 if same else 10), generator=g)
    gy = torch.randn(1, cout, 1, frames, generator=g)
    xp = F.pad(x, (padding[1], padding[1]))[0, :, 0]
    windows = torch.stack([xp[:, d:d + frames] for d in range(kw)], 1)  # (cin, kw, frames)
    terms = gy.double()[0, :, 0, None, None, :] * windows.double()  # (cout, cin, kw, frames), exact
    layout = ck.WgradLayout(frames // 64, 1, 0, 0, 64, 16)
    chains = ck.wgrad_chains(layout, ck.WgradPlan(1, frames // 64, frames // 64, 0))
    (ref_w, ref_b), worst, probable = ck.wgrad_reference(x, gy, (cout, cin, 1, kw), padding, chains)
    got = (_chained(terms).reshape(cout, cin, 1, kw), _chained(gy.double()[0, :, 0], parts=4))
    for a, ref, lo, hi in zip(got, (ref_w, ref_b), probable, worst):
        err = (a.double() - ref).abs()
        assert (err <= lo).all() and (lo <= hi).all()
    short = frames - frames // 20
    err = (_chained(terms[..., :short // 64 * 64]).reshape(cout, cin, 1, kw).double() - ref_w).abs()
    assert (err / probable[0]).max() > 100


def test_pick_tiles_raises_where_nothing_fits():
    with pytest.raises(ValueError):
        ck.pick_tiles(1, 8, 64, 3, 11, 8, 100, 132, lambda *a: 0)


def _reader():
    path = ROOT / "benchmark" / "metrics" / "conv_launches_per_song.serve.py"
    spec = importlib.util.spec_from_file_location("conv_launches_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Window:
    def __init__(self, per_span):
        self.asked, self.value = [], per_span

    def per_span(self, counter, per):
        self.asked.append((counter, per))
        return self.value


def test_launch_reader_reads_the_counter_per_song(monkeypatch):
    from benchmark import program_trace

    window = _Window(16.0)
    monkeypatch.setattr(program_trace, "load", lambda ctx: window)
    assert _reader().read({}) == 16.0 and window.asked == [("conv_launch.fprop", "track")]


def test_launch_reader_reads_nothing_without_the_counter(monkeypatch):
    from benchmark import program_trace

    monkeypatch.setattr(program_trace, "load", lambda ctx: _Window(0.0))
    monkeypatch.setattr(profiling, "_totals", {k: v for k, v in profiling._totals.items()
                                               if not k.startswith("conv_launch.")})
    assert _reader().read({}) is None
    monkeypatch.setattr(program_trace, "load", lambda ctx: None)
    assert _reader().read({}) is None


def _wgrad_reader():
    path = ROOT / "benchmark" / "metrics" / "wgrad_launches_per_step.finetune.py"
    spec = importlib.util.spec_from_file_location("wgrad_launches_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finetune_window():
    """Two train steps (8 + 8 launches under one's nested span, 16 in the
    other), one validation step with 5 launches, a count outside every span."""
    Span, Count = profiling.Span, profiling.Count
    spans = [Span("epoch.batch", 1.0, 1.1, -1, 1), Span("epoch.step", 1.1, 2.0, -1, 1),
             Span("inner", 1.2, 1.9, 1, 1), Span("epoch.step", 2.0, 3.0, -1, 2), Span("epoch.step", 3.1, 3.2, -1, 3)]
    counts = [Count("conv_launch.wgrad", 8, 1), Count("conv_launch.wgrad", 8, 2), Count("conv_launch.wgrad", 16, 3),
              Count("conv_launch.wgrad", 5, 4), Count("conv_launch.wgrad", 1, -1), Count("conv_launch.fprop", 16, 1)]
    ctx = {"spans": SimpleNamespace(spans=[("train_epoch", 1.0, 3.05), ("val_pass", 3.05, 3.5)])}
    return SimpleNamespace(spans=spans, counts=counts), ctx


def test_wgrad_reader_reads_the_counter_per_train_step(monkeypatch):
    from benchmark import program_trace

    window, ctx = _finetune_window()
    monkeypatch.setattr(program_trace, "load", lambda ctx: window)
    assert _wgrad_reader().read(ctx) == 16.0


def test_wgrad_reader_reads_nothing_without_the_counter(monkeypatch):
    from benchmark import program_trace

    window, ctx = _finetune_window()
    monkeypatch.setattr(program_trace, "load", lambda ctx: window)
    monkeypatch.setattr(profiling, "_totals", {k: v for k, v in profiling._totals.items()
                                               if not k.startswith("conv_launch.")})
    assert _wgrad_reader().read(ctx) is None
    monkeypatch.undo()
    monkeypatch.setattr(program_trace, "load", lambda ctx: None)
    assert _wgrad_reader().read(ctx) is None
    # A window whose steps all lie in validation passes has no train step to divide by.
    window.spans[:] = [s._replace(start=3.1, end=3.2) for s in window.spans]
    monkeypatch.setattr(program_trace, "load", lambda ctx: window)
    assert _wgrad_reader().read(ctx) is None
