"""The encoders' conv kernel (csrc/conv_fprop.cu) on a card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_conv_cuda.py -q

At each of the 8 encoder convs and the song (1 x 1,876) and fine-tune
(8 x 1,920) shapes: the kernel against a float64 conv of the same float32
inputs, each output within the rounding bound of a float32 FMA chain of its
taps and the bias, (taps + 1) u times the float64 conv of |x| and |w| plus
|b| (u = 2^-24): the kernel sums each output in one thread, in float32, with
no other rounding; two runs bit for bit; the gradients through ``ConvFprop``
equal to ``F.conv2d``'s (both cuDNN's backward, cuDNN deterministic). Then K
supervised steps as one CUDA graph equal to K eager steps bit for bit, with
the kernel in the graph, and one ``track_signal`` with 16 launches.
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


def _inputs(i, batch, frames, device, seed=0):
    h, cin = 96, 1
    for j in range(i):
        cin = CONV_SPECS[j][0]
        h //= POOL_AFTER.get(j, 1)
    cout, (kh, kw) = CONV_SPECS[i]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, cin, h, frames, device=device, generator=g)
    w = torch.randn(cout, cin, kh, kw, device=device, generator=g) * (2.0 / (cin * kh * kw)) ** 0.5
    b = 0.1 * torch.randn(cout, device=device, generator=g)
    return x, w, b, (kh // 2, kw // 2)


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


@pytest.mark.parametrize("batch,frames", [(1, 1876), (8, 1920)], ids=["song", "finetune"])
@pytest.mark.parametrize("i", range(len(CONV_SPECS)), ids=[f"cv{i + 1}" for i in range(len(CONV_SPECS))])
def test_gradients_equal_cudnn(cuda, i, batch, frames):
    x, w, b, padding = _inputs(i, batch, frames, cuda, seed=10 + i)
    gy = torch.randn(batch, w.shape[0], x.shape[2], frames, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(i))
    grads = []
    with _deterministic_cudnn():
        for fn in (ck.conv2d, lambda x, w, b, p: F.conv2d(x, w, b, padding=p)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            fn(*leaves, padding).backward(gy)
            grads.append([t.grad for t in leaves])
    for name, a, c in zip(("x", "w", "b"), *grads):
        assert torch.equal(a, c), name


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
    CUDA graph: the capture launches the kernel 16 times a step and the replay
    launches nothing from the host; losses, outputs and parameters equal two
    eager train_step calls bit for bit."""
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
            before = profiling.totals("conv_launch.")["fprop"]
            gens = [dropout_generator(2, 2 * call + k, "cuda") for k in range(2)]
            graph, losses, outs = step(graph, *bucket, rows, gens)
            launched = profiling.totals("conv_launch.")["fprop"] - before
            # The capture's warm-up step and its two captured steps; a replay launches nothing from the host.
            assert launched == (3 * 16 if call == 0 else 0), launched
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
