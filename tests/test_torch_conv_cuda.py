"""The encoders' conv kernels (csrc/conv_fprop.cu, csrc/conv_wgrad.cu) on a card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_conv_cuda.py -q

At each of the 8 encoder convs and the song (1 x 1,876) and fine-tune
(8 x 1,920) shapes: the forward kernel against a float64 conv of the same
float32 inputs, each output within the rounding bound of a float32 FMA chain
of its taps and the bias, (taps + 1) u times the float64 conv of |x| and |w|
plus |b| (u = 2^-24): the kernel sums each output in one thread, in float32,
with no other rounding; two runs bit for bit. At each conv and the song,
fine-tune, pretext (16 x 313) and mesh time rank (8 x 480 with its halo)
shapes: the weight and bias gradients against float64 within the bounds of
their split sums (``_assert_wgrad_bounded``), and bit for bit twice. The
gradients through ``ConvFprop``: the input gradient equal to ``F.conv2d``'s
(both cuDNN's, cuDNN deterministic), the weight and bias gradients within
those bounds. Then K supervised steps as one CUDA graph equal to K eager
steps bit for bit, with both kernels in the graph, and one
``track_signal`` with 16 launches.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zeronotesamba_torch.models.encoder import CONV_SPECS, POOL_AFTER
from zeronotesamba_torch.ops.cuda import conv_kernel as ck
from zeronotesamba_torch.utils import profiling

pytestmark = pytest.mark.cuda

ROUNDING = 2.0 ** -24  # float32's unit roundoff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from zeronotesamba_torch.device import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _inputs(i, batch, frames, device, seed=0, same=True):
    """Conv i's input, weights, bias and padding; ``same=False``: a mesh
    time rank's, its input holding the halo frames, padded in frequency only."""
    h, cin = 96, 1
    for j in range(i):
        cin = CONV_SPECS[j][0]
        h //= POOL_AFTER.get(j, 1)
    cout, (kh, kw) = CONV_SPECS[i]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, cin, h, frames if same else frames + 2 * (kw // 2), device=device, generator=g)
    w = torch.randn(cout, cin, kh, kw, device=device, generator=g) * (2.0 / (cin * kh * kw)) ** 0.5
    b = 0.1 * torch.randn(cout, device=device, generator=g)
    return x, w, b, ((kh // 2, kw // 2) if same else (kh // 2, 0))


def _assert_wgrad_bounded(x, gy, w_shape, padding, gw, gb):
    """The weight and bias gradients within both of ``ck.wgrad_reference``'s
    bounds of the kernel's sums: gamma(n) times the float64 sum of |t| (the
    worst case) and 7 sqrt(n) u times the root of the sum of t^2 (for these
    independent zero-mean inputs), t = gy x or gy, n the terms of the
    longest rounding chain of the plan (``ck.wgrad_chains``)."""
    chains = ck.wgrad_chains(*ck.wgrad_plan(x, w_shape[0], w_shape[2], w_shape[3], padding))
    ref, worst, probable = ck.wgrad_reference(x, gy, w_shape, padding, chains)
    for got, r, hi, lo in zip((gw, gb), ref, worst, probable):
        err = (got.double() - r).abs()
        assert (err / hi).max().item() <= 1.0 and (err / lo).max().item() <= 1.0, (err / lo).max().item()


@pytest.mark.parametrize("batch,frames", [(1, 1876), (8, 1920)], ids=["song", "finetune"])
@pytest.mark.parametrize("i", range(len(CONV_SPECS)), ids=[f"cv{i + 1}" for i in range(len(CONV_SPECS))])
def test_kernel_against_float64(cuda, i, batch, frames):
    x, w, b, padding = _inputs(i, batch, frames, cuda, seed=i)
    before = profiling.totals("conv_launch.")["fprop"]
    y = ck.conv2d(x, w, b, padding)
    y2 = ck.conv2d(x, w, b, padding)
    assert profiling.totals("conv_launch.")["fprop"] == before + 2
    ref = F.conv2d(x.double(), w.double(), b.double(), padding=padding)
    scale = F.conv2d(x.double().abs(), w.double().abs(), b.double().abs(), padding=padding)
    torch.cuda.synchronize()
    assert y.shape == ref.shape
    assert torch.equal(y, y2)
    taps = w[0].numel()
    ratio = ((y.double() - ref).abs() / (scale * (taps + 1) * ROUNDING)).max().item()
    assert ratio <= 1.0, ratio


WGRAD_SHAPES = [("song", 1, 1876, True), ("finetune", 8, 1920, True), ("pretext", 16, 313, True),
                ("mesh_t4", 8, 480, False)]


@pytest.mark.parametrize("shape,batch,frames,same", WGRAD_SHAPES, ids=[s[0] for s in WGRAD_SHAPES])
@pytest.mark.parametrize("i", range(len(CONV_SPECS)), ids=[f"cv{i + 1}" for i in range(len(CONV_SPECS))])
def test_wgrad_against_float64(cuda, i, shape, batch, frames, same):
    x, w, _, padding = _inputs(i, batch, frames, cuda, seed=20 + i, same=same)
    gy = torch.randn(batch, w.shape[0], x.shape[2], frames, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(30 + i))
    before = profiling.totals("conv_launch.")["wgrad"]
    gw, gb = ck.wgrad(x, gy, w.shape[2], w.shape[3], padding, True)
    gw2, gb2 = ck.wgrad(x, gy, w.shape[2], w.shape[3], padding, True)
    assert profiling.totals("conv_launch.")["wgrad"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)
    _assert_wgrad_bounded(x, gy, w.shape, padding, gw, gb)
    assert ck.wgrad(x, gy, w.shape[2], w.shape[3], padding, False)[1] is None


@pytest.mark.parametrize("batch,frames", [(1, 1876), (8, 1920)], ids=["song", "finetune"])
@pytest.mark.parametrize("i", range(len(CONV_SPECS)), ids=[f"cv{i + 1}" for i in range(len(CONV_SPECS))])
def test_gradients_equal_cudnn(cuda, i, batch, frames):
    """The input gradient through ``ConvFprop`` is cuDNN's, bit for bit; the
    weight and bias gradients are the kernel's, within the bounds of its
    split sums of the float64 gradients (cuDNN's sums in another order)."""
    x, w, b, padding = _inputs(i, batch, frames, cuda, seed=10 + i)
    gy = torch.randn(batch, w.shape[0], x.shape[2], frames, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(i))
    grads = []
    with _deterministic_cudnn():
        for fn in (ck.conv2d, lambda x, w, b, p: F.conv2d(x, w, b, padding=p)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            fn(*leaves, padding).backward(gy)
            grads.append([t.grad for t in leaves])
    (gx, gw, gb), (cudnn_gx, _, _) = grads
    assert torch.equal(gx, cudnn_gx)
    _assert_wgrad_bounded(x, gy, w.shape, padding, gw, gb)


def test_mesh_padding_equals_same_padding_bit_for_bit(cuda):
    """A time rank's conv (halo frames in the input, padding (kh // 2, 0))
    sums each output in the order the single-card conv does."""
    x, w, b, (ph, pw) = _inputs(3, 2, 96, cuda, seed=3)
    whole = ck.conv2d(x, w, b, (ph, pw))
    shard = ck.conv2d(F.pad(x, (pw, pw)), w, b, (ph, 0))
    assert torch.equal(whole, shard)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 8, 8, 40, device=cuda)
    with pytest.raises(ValueError, match="widths"):
        ck.conv2d(x, torch.randn(8, 8, 3, 3, device=cuda), None, (1, 1))
    with pytest.raises(ValueError, match="multiple of 8"):
        ck.conv2d(x, torch.randn(12, 8, 3, 11, device=cuda), None, (1, 5))
    with pytest.raises(TypeError):
        ck.conv2d(x.bfloat16(), torch.randn(8, 8, 3, 11, device=cuda), None, (1, 5))


def _bucket(cuda, n=6, streams=2, frames=128, seed=7):
    rng = np.random.default_rng(seed)
    vqt = torch.tensor((rng.standard_normal((n, streams, 96, frames)) * 4.0 - 6.0).astype(np.float32), device=cuda)
    pulse = torch.tensor((rng.random((n, frames)) < 0.1).astype(np.float32), device=cuda)
    return vqt, pulse, torch.ones(n, frames, device=cuda)


def test_multistep_graph_with_the_kernel_equals_eager_steps(cuda):
    """K = 2 supervised steps of the twin (batch 2 x 128, dropout on) as one
    CUDA graph: the capture launches each kernel (forward and weight
    gradient) 16 times a step and the replay launches nothing from the host;
    losses, outputs and parameters equal two eager train_step calls bit for
    bit."""
    from zeronotesamba_torch.train.supervised import (
        SupervisedConfig, dropout_generator, init_state, make_multistep_train_step, train_step,
    )

    bucket = _bucket(cuda)
    cfg = SupervisedConfig(status="pretrained", lr=1e-3)
    step = make_multistep_train_step(cfg.status)
    idx = [np.array([[0, 3], [5, 1]]), np.array([[1, 2], [0, 5]])]
    with _deterministic_cudnn():
        graph, eager = init_state(cfg, None, 3, device=cuda), init_state(cfg, None, 3, device=cuda)
        for call, rows in enumerate(idx):
            before = profiling.totals("conv_launch.")
            gens = [dropout_generator(2, 2 * call + k, "cuda") for k in range(2)]
            graph, losses, outs = step(graph, *bucket, rows, gens)
            launched = {k: v - before[k] for k, v in profiling.totals("conv_launch.").items()}
            # The capture's warm-up step and its two captured steps; a replay launches nothing from the host.
            assert launched == {k: 3 * 16 if call == 0 else 0 for k in ("fprop", "wgrad")}, launched
            e_losses, e_outs = [], []
            for k, r in enumerate(torch.as_tensor(rows, device=cuda)):
                gen = dropout_generator(2, 2 * call + k, "cuda")
                eager, loss, out = train_step(eager, *(t.index_select(0, r) for t in bucket), gen, cfg.status)
                e_losses.append(loss)
                e_outs.append(out)
            assert torch.equal(losses, torch.stack(e_losses)) and torch.equal(outs, torch.stack(e_outs))
            assert all(torch.equal(a, b) for a, b in zip(graph.model.parameters(), eager.model.parameters()))


def test_track_signal_launches_sixteen_convs(cuda):
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker

    sig, _ = click_track(30.0, 120.0, seed=4)
    tracker = BeatTracker(seed=2, device="cuda")
    before = profiling.totals("conv_launch.")["fprop"]
    res = tracker.track_signal(sig, separation="hpss", decoder="dbn")
    assert profiling.totals("conv_launch.")["fprop"] - before == 16
    assert len(res.beat_times) > 0
