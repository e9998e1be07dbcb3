"""Spleeter 4stems (Hennequin, Khlif, Voituret, Moussallam, JOSS 2020), plainly,
from a weight dict.

The plain reference of the spleeter_4stems configuration: torch and numpy
only, the nets in float32 with TF32 off unless asked, the transforms in
float64. It imports nothing of the program it judges. Weights carry the
source's TensorFlow variable names and layouts (github.com/deezer/spleeter,
``model/functions/unet.py``, Keras numbering every layer in order of
creation: instrument ``i``'s convs ``conv2d_{7i}`` .. ``_{7i+6}``, the last
its head, its transposed convs ``conv2d_transpose_{6i}`` .. ``_{6i+5}``, its
BatchNorms ``batch_normalization_{12i}`` .. ``_{12i+11}``; index 0 has no
suffix). Kernels are (kh, kw, in, out), a transposed conv's (kh, kw, out,
in).

- STFT (``model/__init__.py``, ``_build_stft_feature``): the mono song
  duplicated to two channels (``to_stereo``); 4,096 zeros prepended; frames
  of 4,096 every 1,024 samples, not centred, the end zero-padded
  (``pad_end=True``): ceil((L + 4,096) / 1,024) frames; periodic Hann; rfft.
  |X| over the first ``F`` bins, zero frames appended to a multiple of
  ``T`` and cut into (S, 2, T, F) segments (``pad_and_partition``).
- U-Net (``apply_unet``): six Conv2d 5x5 stride 2 with TensorFlow's
  ``"same"`` padding written out (``F.pad`` 1 before, 2 after), each
  BatchNorm (eps 1e-3, running statistics) and LeakyReLU(0.2), the
  pre-BatchNorm outputs c1..c6 kept (the sixth BatchNorm and activation
  feed nothing); six ConvTranspose2d 5x5 stride 2, the full output cropped
  by 1 before and 2 after, each ReLU then BatchNorm: u1 from c6, then from
  [c5, u1], [c4, u2], [c3, u3], [c2, u4], [c1, u5]; dropout is inactive at
  inference; out = sigmoid(Conv2d 4x4 dilation 2, padding 3, on u6) * |X|.
- Masks (``_build_masks``): M_i = (out_i^2 + 1e-10 / 4) / (sum_j out_j^2 +
  1e-10), un-partitioned, cut to the STFT's frames, zeros from bin ``F`` to
  2,049.
- Stems (``_inverse_stft``): for each instrument and channel, irfft of
  M_i X, periodic Hann, overlap-add at 1,024, times 2/3, samples [4,096,
  4,096 + L). Anchor: vocals + bass + other, positive: drums, each the mean
  of its two channels.
- Resample to 16 kHz: the port's Kaiser-windowed sinc (half-width 32 x
  max(p, q) taps a side, beta 9, gain p; ``kaiser_lowpass``) summed at each
  kept output directly, float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import tf32

SAME = (1, 2, 1, 2)


# ---------------------------------------------------------------- the weights


def _keras(base: str, index: int) -> str:
    return base if index == 0 else f"{base}_{index}"


def layer_names(i: int) -> dict:
    """Instrument ``i``'s layers in the source's names: six encoder convs,
    six transposed convs, twelve BatchNorms (encoder, then decoder), the head."""
    return {"enc": [_keras("conv2d", 7 * i + j) for j in range(6)],
            "dec": [_keras("conv2d_transpose", 6 * i + j) for j in range(6)],
            "bn": [_keras("batch_normalization", 12 * i + j) for j in range(12)],
            "head": _keras("conv2d", 7 * i + 6)}


def shapes(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """(key, shape, init, fan-in) of every variable, instrument by instrument:
    fan-in is the layer's input channels times its taps."""
    f, k = cfg["conv_n_filters"], cfg["kernel_size"]
    outs = f[-2::-1] + [1]
    ins = [f[-1]] + [2 * c for c in f[-2::-1]]
    out = []
    for i in range(len(cfg["instrument_list"])):
        names = layer_names(i)

        def bn(name, c):
            return [(f"{name}/gamma", (c,), "bn_gamma", 0), (f"{name}/beta", (c,), "bn_beta", 0),
                    (f"{name}/moving_mean", (c,), "bn_mean", 0), (f"{name}/moving_variance", (c,), "bn_var", 0)]

        for j, (cin, cout) in enumerate(zip([cfg["n_channels"]] + f[:-1], f)):
            out += [(f"{names['enc'][j]}/kernel", (k, k, cin, cout), "uniform", k * k * cin),
                    (f"{names['enc'][j]}/bias", (cout,), "uniform", k * k * cin)] + bn(names["bn"][j], cout)
        for j, (cin, cout) in enumerate(zip(ins, outs)):
            out += [(f"{names['dec'][j]}/kernel", (k, k, cout, cin), "uniform", k * k * cin),
                    (f"{names['dec'][j]}/bias", (cout,), "uniform", k * k * cin)] + bn(names["bn"][6 + j], cout)
        hk = cfg["head_kernel"]
        out += [(f"{names['head']}/kernel", (hk, hk, 1, cfg["n_channels"]), "uniform", hk * hk),
                (f"{names['head']}/bias", (cfg["n_channels"],), "uniform", hk * hk)]
    return out


def param_count(cfg: dict) -> int:
    """Every variable, the BatchNorm running statistics included."""
    return sum(math.prod(s) for _, s, _, _ in shapes(cfg))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed``, float32 on ``device``, in two
    draws: conv and transposed-conv kernels and biases U(+-1/sqrt(fan-in)),
    BatchNorm gains U(0.8, 1.2), shifts N(0, 0.1^2), running means N(0,
    0.1^2), running variances U(0.5, 1.5)."""
    leaves = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = [math.prod(s) for _, s, _, _ in leaves]
    normal_kinds = ("bn_beta", "bn_mean")
    normal = torch.randn(sum(n for n, leaf in zip(sizes, leaves) if leaf[2] in normal_kinds), generator=gen,
                         device=device)
    uniform = torch.rand(sum(n for n, leaf in zip(sizes, leaves) if leaf[2] not in normal_kinds), generator=gen,
                         device=device)
    out, at = {}, {"n": 0, "u": 0}
    for (key, shape, kind, fan_in), n in zip(leaves, sizes):
        src = "n" if kind in normal_kinds else "u"
        t = (normal if src == "n" else uniform)[at[src]: at[src] + n].view(shape)
        at[src] += n
        if kind == "uniform":
            out[key] = (t * 2.0 - 1.0) / math.sqrt(fan_in)
        elif kind == "bn_gamma":
            out[key] = 0.8 + 0.4 * t
        elif kind == "bn_var":
            out[key] = 0.5 + t
        else:
            out[key] = 0.1 * t
    return out


# ---------------------------------------------------------------- the transforms


def _hann(n: int, device) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, dtype=torch.float64, device=device) / n)


def stft(signal: np.ndarray, cfg: dict, device, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A mono song -> its two channels' STFT, (2, frames, frame // 2 + 1),
    complex. In ``torch.bfloat16`` (the control) the STFT runs in float32
    and its real and imaginary parts are rounded to bfloat16."""
    n, hop = cfg["frame_length"], cfg["frame_step"]
    real = torch.float64 if dtype == torch.float64 else torch.float32
    y = torch.as_tensor(np.asarray(signal), device=device).to(real)
    frames = -(-(len(y) + n) // hop)
    y = F.pad(y, (n, (frames - 1) * hop - len(y)))
    spec = torch.fft.rfft(y.unfold(0, n, hop) * _hann(n, device).to(real), dim=-1)
    if dtype == torch.bfloat16:
        spec = torch.complex(spec.real.bfloat16().float(), spec.imag.bfloat16().float())
    return torch.stack([spec, spec])


def magnitude(spec: torch.Tensor, cfg: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(2, frames, bins) STFT -> (S, 2, T, F) float32 segments of |X|
    rounded to ``dtype``."""
    t = cfg["T"]
    mag = spec[..., : cfg["F"]].abs().to(dtype).float()
    mag = F.pad(mag, (0, 0, 0, -mag.shape[1] % t))
    return mag.view(2, -1, t, cfg["F"]).transpose(0, 1).contiguous()


def _unpartition(seg: torch.Tensor, frames: int, bins: int) -> torch.Tensor:
    """(S, 2, T, F) -> (2, frames, bins): joined, cut to the frames, zeros above F."""
    x = seg.transpose(0, 1).flatten(1, 2)[:, :frames]
    return F.pad(x, (0, bins - x.shape[-1]))


def istft(spec: torch.Tensor, length: int, cfg: dict) -> torch.Tensor:
    """(C, frames, bins) complex -> (C, length) real: the source's inverse."""
    n, hop = cfg["frame_length"], cfg["frame_step"]
    c, frames = spec.shape[:2]
    x = torch.fft.irfft(spec, n=n, dim=-1) * _hann(n, spec.device).to(spec.real.dtype)
    total = (frames - 1) * hop + n
    y = F.fold(x.transpose(1, 2), (1, total), (1, n), stride=(1, hop))[:, 0, 0]
    return y[:, n: n + length] * cfg["window_compensation"]


def kaiser_lowpass(p: int, q: int, half_width: int = 32, beta: float = 9.0) -> np.ndarray:
    """The windowed sinc for rational p/q resampling, gain p in the passband."""
    m = max(p, q)
    taps = 2 * half_width * m + 1
    n = np.arange(taps) - (taps - 1) / 2.0
    h = np.sinc(n / m) / m * np.kaiser(taps, beta)
    return h * p / np.sum(h)


def resample(x: torch.Tensor, sr_in: int, sr_out: int, chunk: int = 16384) -> torch.Tensor:
    """(B, L) -> (B, ceil(L p / q)): y[j] = sum_i x[i] h[j q - i p + half]
    over the taps in range, summed directly in ``x``'s dtype."""
    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    h = torch.as_tensor(kaiser_lowpass(p, q), dtype=x.dtype, device=x.device)
    half, n = (len(h) - 1) // 2, x.shape[-1]
    width = -(-len(h) // p) + 1
    out = []
    for j0 in range(0, -(-n * p // q), chunk):
        j = torch.arange(j0, min(j0 + chunk, -(-n * p // q)), device=x.device)
        i = torch.div(j * q - half + p - 1, p, rounding_mode="floor")[:, None] + torch.arange(width, device=x.device)
        k = j[:, None] * q - i * p + half
        ok = (k >= 0) & (k < len(h)) & (i >= 0) & (i < n)
        taps = torch.where(ok, h[k.clamp(0, len(h) - 1)], torch.zeros((), dtype=x.dtype, device=x.device))
        out.append((x[:, i.clamp(0, n - 1)] * taps).sum(-1))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------- the nets and masks


def _kernel(w: dict, name: str) -> torch.Tensor:
    return w[f"{name}/kernel"].permute(3, 2, 0, 1)


def _batch_norm(x: torch.Tensor, w: dict, name: str, eps: float) -> torch.Tensor:
    v = lambda leaf: w[f"{name}/{leaf}"].view(1, -1, 1, 1)  # noqa: E731
    return (x - v("moving_mean")) / torch.sqrt(v("moving_variance") + eps) * v("gamma") + v("beta")


def unet(w: dict, x: torch.Tensor, i: int, cfg: dict) -> torch.Tensor:
    """Instrument ``i``'s net on (N, 2, T, F) float32 magnitudes."""
    names, eps, slope = layer_names(i), cfg["bn_eps"], cfg["leaky_relu_alpha"]
    skips, h = [], x
    for j, name in enumerate(names["enc"]):
        skips.append(F.conv2d(F.pad(h, SAME), _kernel(w, name), w[f"{name}/bias"], stride=cfg["strides"]))
        h = F.leaky_relu(_batch_norm(skips[-1], w, names["bn"][j], eps), slope)
    u = skips[-1]
    for j, name in enumerate(names["dec"]):
        if j:
            u = torch.cat([skips[-1 - j], u], dim=1)
        full = F.conv_transpose2d(u, _kernel(w, name), w[f"{name}/bias"], stride=cfg["strides"])
        u = _batch_norm(F.relu(full[..., 1:-2, 1:-2]), w, names["bn"][6 + j], eps)
    pad = cfg["head_dilation"] * (cfg["head_kernel"] - 1) // 2
    head = F.conv2d(F.pad(u, (pad,) * 4), _kernel(w, names["head"]), w[f"{names['head']}/bias"],
                    dilation=cfg["head_dilation"])
    return torch.sigmoid(head) * x


def masks(w: dict, mag: torch.Tensor, cfg: dict, tf32_on: bool = False) -> torch.Tensor:
    """(S, 2, T, F) magnitudes -> (instruments, S, 2, T, F) float32 ratio masks."""
    x = mag.float()
    eps = cfg["epsilon"]
    with tf32(tf32_on), torch.no_grad():
        outs = [unet(w, x, i, cfg) ** cfg["separation_exponent"] for i in range(len(cfg["instrument_list"]))]
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return torch.stack([(o + eps / len(outs)) / (total + eps) for o in outs])


def streams(spec: torch.Tensor, seg_masks: torch.Tensor, length: int, cfg: dict) -> torch.Tensor:
    """(anchor, positive) at the downstream rate, (2, L16), in ``spec``'s
    precision: each instrument's stem by its own inverse STFT on both
    channels, then the fold and the channels' mean, then the resample."""
    frames, bins = spec.shape[1:]
    real = spec.real.dtype
    stems = {name: istft(_unpartition(seg_masks[i].to(real), frames, bins) * spec, length, cfg)
             for i, name in enumerate(cfg["instrument_list"])}
    anchor = sum(stems[name] for name in cfg["instrument_list"] if name != "drums")
    pair = torch.stack([anchor.mean(0), stems["drums"].mean(0)])
    return resample(pair, cfg["sample_rate"], cfg["downstream_sample_rate"])


# ---------------------------------------------------------------- counts


def n_segments(samples: int, cfg: dict) -> int:
    """The segments of ``T`` frames a song of ``samples`` is cut into."""
    frames = -(-(samples + cfg["frame_length"]) // cfg["frame_step"])
    return -(-frames // cfg["T"])


def unet_flops(cfg: dict) -> float:
    """FLOPs of one net on one (2, T, F) segment (a multiply and an add count
    two): every conv and transposed conv (over its full output) and the
    head; biases, BatchNorm, activations and masks not counted
    (12,197,036,032 at the published widths)."""
    f, k2 = cfg["conv_n_filters"], cfg["kernel_size"] ** 2
    h, w, cin, macs = cfg["T"], cfg["F"], cfg["n_channels"], 0
    sizes = []
    for cout in f:
        h, w = h // 2, w // 2
        macs += h * w * cin * cout * k2
        sizes.append((h, w, cout))
        cin = cout
    outs = f[-2::-1] + [1]
    for j, cout in enumerate(outs):
        h, w, skip = sizes[-1 - j]
        cin = skip if j == 0 else 2 * skip
        macs += h * w * cin * cout * k2
    macs += cfg["T"] * cfg["F"] * cfg["n_channels"] * cfg["head_kernel"] ** 2
    return 2.0 * macs


def spleeter_flops(cfg: dict, segments: int) -> float:
    """FLOPs of the four nets on ``segments`` segments (146,364,432,384 for
    a 30 s song's 3)."""
    return len(cfg["instrument_list"]) * segments * unet_flops(cfg)
