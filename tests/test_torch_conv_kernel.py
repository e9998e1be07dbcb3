"""The encoders' conv wrapper (ops/cuda/conv_kernel.py) on the CPU.

On CPU tensors ``conv2d`` is ``F.conv2d`` itself; these tests hold it to
that at every encoder conv, under both paddings the encoder uses (SAME on
one card, frequency only on a mesh's time axis), check ``ConvFprop``'s
gradients (the card's autograd route, plain forward here) by gradcheck in
float64 and against ``F.conv2d``'s, what the wrapper refuses, the launch
counter, the encoder's dispatch by dtype, the block-layout rule and the
benchmark's reader of the launch counter. The kernel itself runs only on a
card (tests/test_torch_conv_cuda.py).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

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
    assert out.stdout.strip() == "{'fprop': 0}"


def test_cpu_calls_launch_nothing():
    before = profiling.totals("conv_launch.")
    x, w, b, padding = _inputs(2, 1, 16, True)
    ck.conv2d(x, w, b, padding)
    assert "fprop" in before and profiling.totals("conv_launch.") == before


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
