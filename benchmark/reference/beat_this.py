"""Beat This! (Foscarin, Schlueter, Widmer, ISMIR 2024), plainly, from a weight dict.

The plain reference of the beat_this configuration: torch and numpy only,
float32 (the log-mel in float64), explicit softmax attention, one chunk at a
time, TF32 off unless asked. It imports nothing of the program it judges.
Key names are the source's (github.com/CPJKU/beat_this, model/beat_tracker.py
and model/roformer.py), so a published state dict is such a weight dict.

- Log-mel: STFT (n_fft 1,024, hop 441, periodic Hann, centred, reflect
  padding; 1 + L // 441 frames) of mono 22,050 Hz audio, magnitude over
  sqrt(sum(window^2)), a 128-band Slaney-scale triangular filterbank from 30
  to 11,000 Hz without area normalisation, log1p(1000 x): (T, 128).
- Model, on (B, T, 128): BatchNorm1d over the bins; Conv2d(1 -> 32, (4, 3),
  stride (4, 1), padding (0, 1)), BatchNorm2d, GELU; three blocks at 32, 64,
  128 channels (32, 16, 8 bins), each a partial transformer (attention and
  feed-forward over frequency, then over time) and Conv2d(c -> 2c, (2, 3),
  stride (2, 1), padding (0, 1)), BatchNorm2d, GELU; (B, 256, 4, T) ->
  (B, T, 1,024) -> Linear -> 512; six pre-norm layers of attention and
  feed-forward at 512 (16 heads of 32, FF 2,048); RMSNorm; Linear(512 -> 2);
  beat = beat + downbeat.
- Attention(x): h = RMSNorm(x) (x / |x| * sqrt(dim) * gamma); q, k, v from
  h W_qkv; rotary positions (theta 10,000, interleaved pairs, every dim) on q
  and k; softmax(q k^T / sqrt(32)) v; times sigmoid(h W_g + b_g), one gate a
  head and position; W_o. FeedForward(x) = W2 GELU(W1 RMSNorm(x) + b1) + b2.
- Chunks (the source's ``split_piece`` / ``aggregate_prediction``): starts
  range(-6, T - 6, 1,488), the last moved to T - 1,494 when T > 1,488; each
  chunk zero-padded at its borders (a piece of at most 1,488 frames is one
  chunk of T + 12 frames, every other chunk 1,500); 6 border frames dropped;
  where chunks overlap the earlier one is kept.
- Minimal post-processing: a peak is a logit equal to the max over a window
  of 7 frames and above 0; peaks within one frame merge to their mean; times
  are frames / 50; each downbeat moves to the nearest beat, duplicates dropped.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for the convs and matmuls inside (off is the
    configuration's precision; the control turns it on), restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# ---------------------------------------------------------------- the log-mel


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """The Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (math.log(6.4) / 27.0),
                    f / (200.0 / 3.0))


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * (math.log(6.4) / 27.0)), m * (200.0 / 3.0))


def mel_filterbank(cfg: dict) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular filters, float64, peak 1."""
    freqs = np.linspace(0.0, cfg["sample_rate"] // 2, cfg["n_fft"] // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(cfg["f_min"]), _hz_to_mel(cfg["f_max"]), cfg["n_mels"] + 2))
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def log_mel(signal: np.ndarray, cfg: dict, device="cpu", dtype: torch.dtype = torch.float64) -> np.ndarray:
    """A mono signal -> its (1 + L // hop, n_mels) log-mel, float64. In
    ``torch.bfloat16`` (the control) the STFT runs in float32 and the
    magnitude, the filterbank and the log in bfloat16."""
    stft_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    y = torch.as_tensor(np.asarray(signal), device=device).to(stft_dtype)
    n = cfg["n_fft"]
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, dtype=torch.float64, device=device) / n)
    spec = torch.stft(y, n, hop_length=cfg["hop"], window=window.to(stft_dtype), center=True,
                      pad_mode="reflect", return_complex=True).abs()  # (n // 2 + 1, T)
    spec = spec.to(dtype) / torch.sqrt((window ** 2).sum()).to(dtype)
    fb = torch.as_tensor(mel_filterbank(cfg), device=device).to(dtype)
    with tf32(False):
        mel = spec.T @ fb
    return torch.log1p(cfg["log_multiplier"] * mel).double().cpu().numpy()


# ---------------------------------------------------------------- the weights


def frontend_dims(cfg: dict) -> List[Tuple[int, int]]:
    """(channels, bins) at the input of each frontend block."""
    dim, bins = cfg["stem_dim"], cfg["n_mels"] // 4
    out = []
    for _ in range(cfg["frontend_blocks"]):
        out.append((dim, bins))
        dim, bins = dim * 2, bins // 2
    return out


def _attention_shapes(prefix: str, dim: int, head_dim: int) -> list:
    heads = dim // head_dim
    return [(f"{prefix}.norm.gamma", (dim,), "ones"), (f"{prefix}.to_qkv.weight", (3 * dim, dim), "uniform"),
            (f"{prefix}.to_gates.weight", (heads, dim), "uniform"), (f"{prefix}.to_gates.bias", (heads,), "uniform"),
            (f"{prefix}.to_out.0.weight", (dim, dim), "uniform")]


def _ff_shapes(prefix: str, dim: int, mult: int) -> list:
    return [(f"{prefix}.net.0.gamma", (dim,), "ones"), (f"{prefix}.net.1.weight", (mult * dim, dim), "uniform"),
            (f"{prefix}.net.1.bias", (mult * dim,), "uniform"),
            (f"{prefix}.net.4.weight", (dim, mult * dim), "uniform"),
            (f"{prefix}.net.4.bias", (dim,), "uniform")]


def _bn_shapes(prefix: str, dim: int) -> list:
    return [(f"{prefix}.weight", (dim,), "bn_gamma"), (f"{prefix}.bias", (dim,), "bn_beta"),
            (f"{prefix}.running_mean", (dim,), "bn_mean"), (f"{prefix}.running_var", (dim,), "bn_var")]


def shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init) of every tensor of the state dict, in the source's
    key names; the BatchNorm running statistics are leaves too."""
    hd, stem = cfg["head_dim"], cfg["stem_dim"]
    out = _bn_shapes("frontend.stem.bn1d", cfg["n_mels"])
    out += [("frontend.stem.conv2d.weight", (stem, 1, 4, 3), "uniform")] + _bn_shapes("frontend.stem.bn2d", stem)
    dims = frontend_dims(cfg)
    for i, (dim, _) in enumerate(dims):
        p = f"frontend.blocks.{i}"
        for axis in ("F", "T"):
            out += _attention_shapes(f"{p}.partial.attn{axis}", dim, hd) + _ff_shapes(f"{p}.partial.ff{axis}", dim, 4)
        out += [(f"{p}.conv2d.weight", (2 * dim, dim, 2, 3), "uniform")] + _bn_shapes(f"{p}.norm", 2 * dim)
    width = 2 * dims[-1][0] * (dims[-1][1] // 2)
    d = cfg["transformer_dim"]
    out += [("frontend.linear.weight", (d, width), "uniform"), ("frontend.linear.bias", (d,), "uniform")]
    for i in range(cfg["n_layers"]):
        out += (_attention_shapes(f"transformer_blocks.layers.{i}.0", d, hd)
                + _ff_shapes(f"transformer_blocks.layers.{i}.1", d, cfg["ff_mult"]))
    out += [("transformer_blocks.norm.gamma", (d,), "ones"),
            ("task_heads.beat_downbeat_lin.weight", (2, d), "uniform"),
            ("task_heads.beat_downbeat_lin.bias", (2,), "uniform")]
    return out


def param_count(cfg: dict) -> int:
    """Learned parameters (the BatchNorm running statistics are not)."""
    return sum(math.prod(s) for k, s, _ in shapes(cfg) if not k.endswith(("running_mean", "running_var")))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed``, float32 on ``device``, in two
    draws: Linear and Conv weights and biases U(+-1/sqrt(fan_in)) (PyTorch's
    default), RMSNorm gains 1, BatchNorm gains U(0.8, 1.2), shifts N(0, 0.1^2),
    running means N(0, 0.1^2), running variances U(0.5, 1.5)."""
    leaves = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = [math.prod(s) for _, s, _ in leaves]
    normal_kinds, uniform_kinds = ("bn_beta", "bn_mean"), ("uniform", "bn_gamma", "bn_var")
    normal = torch.randn(sum(n for n, (_, _, k) in zip(sizes, leaves) if k in normal_kinds), generator=gen,
                         device=device)
    uniform = torch.rand(sum(n for n, (_, _, k) in zip(sizes, leaves) if k in uniform_kinds), generator=gen,
                         device=device)
    out, at, fan_in = {}, {"n": 0, "u": 0}, {}
    for (key, shape, kind), n in zip(leaves, sizes):
        if kind == "ones":
            out[key] = torch.ones(shape, device=device)
            continue
        src = "n" if kind in normal_kinds else "u"
        t = (normal if src == "n" else uniform)[at[src]: at[src] + n].view(shape)
        at[src] += n
        if kind == "uniform":
            module = key.rsplit(".", 1)[0]
            if key.endswith("weight"):
                fan_in[module] = math.prod(shape[1:])
            bound = 1.0 / math.sqrt(fan_in[module])
            out[key] = (t * 2.0 - 1.0) * bound
        elif kind == "bn_gamma":
            out[key] = 0.8 + 0.4 * t
        elif kind == "bn_var":
            out[key] = 0.5 + t
        else:
            out[key] = 0.1 * t
    return out


# ---------------------------------------------------------------- the model


def _batch_norm(x: torch.Tensor, w: dict, prefix: str, eps: float) -> torch.Tensor:
    """Eval-mode BatchNorm over dim 1 with the running statistics."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean, var = w[f"{prefix}.running_mean"].view(shape), w[f"{prefix}.running_var"].view(shape)
    return (x - mean) / torch.sqrt(var + eps) * w[f"{prefix}.weight"].view(shape) + w[f"{prefix}.bias"].view(shape)


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12) * math.sqrt(x.shape[-1]) * gamma


def rotary_table(n: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n, head_dim) float32: position p, pair i at angle
    p / theta^(2i / head_dim), each angle twice (interleaved pairs); the
    angles in float64."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    ang = ang.repeat_interleave(2, dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t * cos + rotate_half(t) * sin, rotate_half taking (x0, x1) to (-x1, x0) in each pair."""
    pairs = t.unflatten(-1, (-1, 2))
    half = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return t * cos + half * sin


def attention(x: torch.Tensor, w: dict, prefix: str, cfg: dict) -> torch.Tensor:
    """Attention(x) for x (N, n, dim), softmax written out."""
    n, dim = x.shape[1], x.shape[2]
    hd = cfg["head_dim"]
    heads = dim // hd
    h = _rms_norm(x, w[f"{prefix}.norm.gamma"])
    qkv = h @ w[f"{prefix}.to_qkv.weight"].T  # (N, n, 3 * heads * hd), laid out (qkv, head, d)
    q, k, v = qkv.unflatten(-1, (3, heads, hd)).permute(2, 0, 3, 1, 4)  # each (N, heads, n, hd)
    cos, sin = rotary_table(n, hd, cfg["rope_theta"], x.device)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    p = scores.exp()
    o = (p / p.sum(dim=-1, keepdim=True)) @ v
    gates = torch.sigmoid(h @ w[f"{prefix}.to_gates.weight"].T + w[f"{prefix}.to_gates.bias"])  # (N, n, heads)
    o = o * gates.transpose(1, 2)[..., None]
    o = o.transpose(1, 2).flatten(-2)  # (N, n, heads * hd)
    return o @ w[f"{prefix}.to_out.0.weight"].T


def feed_forward(x: torch.Tensor, w: dict, prefix: str) -> torch.Tensor:
    h = _rms_norm(x, w[f"{prefix}.net.0.gamma"])
    h = F.gelu(h @ w[f"{prefix}.net.1.weight"].T + w[f"{prefix}.net.1.bias"])
    return h @ w[f"{prefix}.net.4.weight"].T + w[f"{prefix}.net.4.bias"]


def forward(w: dict, x: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, n_mels) float32 log-mels -> (beat, downbeat) logits, each (B, T)."""
    eps = cfg["bn_eps"]
    b, t = x.shape[0], x.shape[1]
    h = _batch_norm(x.transpose(1, 2), w, "frontend.stem.bn1d", eps)[:, None]  # (B, 1, bins, T)
    h = F.conv2d(h, w["frontend.stem.conv2d.weight"], stride=(4, 1), padding=(0, 1))
    h = F.gelu(_batch_norm(h, w, "frontend.stem.bn2d", eps))
    for i in range(cfg["frontend_blocks"]):
        p = f"frontend.blocks.{i}"
        c, f = h.shape[1], h.shape[2]
        y = h.permute(0, 3, 2, 1).reshape(b * t, f, c)  # b c f t -> (b t) f c
        y = y + attention(y, w, f"{p}.partial.attnF", cfg)
        y = y + feed_forward(y, w, f"{p}.partial.ffF")
        y = y.reshape(b, t, f, c).permute(0, 2, 1, 3).reshape(b * f, t, c)  # -> (b f) t c
        y = y + attention(y, w, f"{p}.partial.attnT", cfg)
        y = y + feed_forward(y, w, f"{p}.partial.ffT")
        h = y.reshape(b, f, t, c).permute(0, 3, 1, 2)  # -> b c f t
        h = F.conv2d(h, w[f"{p}.conv2d.weight"], stride=(2, 1), padding=(0, 1))
        h = F.gelu(_batch_norm(h, w, f"{p}.norm", eps))
    y = h.permute(0, 3, 1, 2).reshape(b, t, -1)  # b c f t -> b t (c f)
    y = y @ w["frontend.linear.weight"].T + w["frontend.linear.bias"]
    for i in range(cfg["n_layers"]):
        y = y + attention(y, w, f"transformer_blocks.layers.{i}.0", cfg)
        y = y + feed_forward(y, w, f"transformer_blocks.layers.{i}.1")
    y = _rms_norm(y, w["transformer_blocks.norm.gamma"])
    out = y @ w["task_heads.beat_downbeat_lin.weight"].T + w["task_heads.beat_downbeat_lin.bias"]
    beat, downbeat = out[..., 0], out[..., 1]
    return beat + downbeat, downbeat


# ---------------------------------------------------------------- chunks


def chunk_starts(frames: int, cfg: dict) -> List[int]:
    size, border = cfg["chunk_size"], cfg["border_size"]
    starts = list(range(-border, frames - border, size - 2 * border))
    if frames > size - 2 * border:
        starts[-1] = frames - (size - border)
    return starts


def split_piece(mel: torch.Tensor, cfg: dict) -> Tuple[List[torch.Tensor], List[int]]:
    """(T, bins) -> chunks, each zero-padded at the piece's borders, and their starts."""
    size, border = cfg["chunk_size"], cfg["border_size"]
    frames = mel.shape[0]
    starts = chunk_starts(frames, cfg)
    chunks = [F.pad(mel[max(s, 0): min(s + size, frames)],
                    (0, 0, max(0, -s), max(0, min(border, s + size - frames)))) for s in starts]
    return chunks, starts


def aggregate(preds: List[np.ndarray], starts: List[int], frames: int, cfg: dict) -> np.ndarray:
    """Chunk predictions (each (L, k)) -> (frames, k): borders dropped, the
    earlier chunk kept where they overlap, -1000 where none reaches."""
    size, border = cfg["chunk_size"], cfg["border_size"]
    out = np.full((frames,) + preds[0].shape[1:], -1000.0, np.float32)
    for s, p in reversed(list(zip(starts, preds))):
        kept = p[border: len(p) - border]
        lo, hi = s + border, min(s + size - border, frames)
        out[lo:hi] = kept[: hi - lo]
    return out


def predict(w: dict, mel: np.ndarray, cfg: dict, device, tf32_on: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """A (T, bins) log-mel -> (beat, downbeat) logits, (T,) each, float32,
    the model run one chunk at a time."""
    x = torch.as_tensor(np.asarray(mel), dtype=torch.float32, device=device)
    chunks, starts = split_piece(x, cfg)
    preds = []
    with tf32(tf32_on), torch.no_grad():
        for c in chunks:
            beat, down = forward(w, c[None], cfg)
            preds.append(torch.stack([beat[0], down[0]], dim=-1).cpu().numpy())
    out = aggregate(preds, starts, x.shape[0], cfg)
    return out[:, 0], out[:, 1]


# ---------------------------------------------------------------- post-processing


def local_maxima(logits: np.ndarray) -> np.ndarray:
    """Frames whose logit is the max of the 7 around it (padding 3)."""
    x = np.asarray(logits, np.float32)
    padded = np.pad(x, 3, constant_values=-np.inf)
    window_max = np.lib.stride_tricks.sliding_window_view(padded, 7).max(axis=-1)
    return np.nonzero(x == window_max)[0]


def peak_frames(logits: np.ndarray) -> np.ndarray:
    """Frames whose logit is the max of the 7 around it (padding 3) and above 0."""
    frames = local_maxima(logits)
    return frames[np.asarray(logits, np.float32)[frames] > 0]


def deduplicate_peaks(peaks: np.ndarray, width: int = 1) -> np.ndarray:
    """Each run of peaks not more than ``width`` apart -> the runs' running mean."""
    out = []
    p, c = None, 0
    for p2 in (int(v) for v in peaks):
        if p is not None and p2 - p <= width:
            c += 1
            p += (p2 - p) / c
        else:
            if p is not None:
                out.append(p)
            p, c = p2, 1
    if p is not None:
        out.append(p)
    return np.asarray(out, np.float64)


def postprocess(beat: np.ndarray, downbeat: np.ndarray, fps: float) -> Tuple[np.ndarray, np.ndarray]:
    """(beat times, downbeat times) in seconds from the two logit tracks."""
    beats = deduplicate_peaks(peak_frames(beat)) / fps
    downs = deduplicate_peaks(peak_frames(downbeat)) / fps
    if len(beats):
        downs = beats[np.abs(beats[None, :] - downs[:, None]).argmin(axis=1)] if len(downs) else downs
    return beats, np.unique(downs)


# ---------------------------------------------------------------- counts


def attention_flops(cfg: dict, frames: int) -> float:
    """FLOPs of q k^T and p v in every attention call of one chunk of ``frames``."""
    hd, total = cfg["head_dim"], 0.0
    for dim, bins in frontend_dims(cfg):
        heads = dim // hd
        total += 4.0 * frames * bins * bins * hd * heads  # over frequency: frames sequences of bins
        total += 4.0 * bins * frames * frames * hd * heads  # over time: bins sequences of frames
    return total + cfg["n_layers"] * 4.0 * frames * frames * cfg["transformer_dim"]


def forward_flops(cfg: dict, frames: int) -> float:
    """Forward FLOPs of one chunk of ``frames`` (a multiply and an add count
    two): every conv, linear layer and attention product; norms, activations
    and softmax not counted."""
    macs, hd = cfg["stem_dim"] * (cfg["n_mels"] // 4) * frames * 4 * 3, cfg["head_dim"]
    dims = frontend_dims(cfg)
    for dim, bins in dims:
        tokens, heads = bins * frames, dim // hd
        macs += 2 * tokens * (3 * dim * dim + dim * heads + dim * dim) + 2 * tokens * 8 * dim * dim
        macs += (bins // 2) * frames * 2 * dim * dim * 6
    d = cfg["transformer_dim"]
    macs += frames * 2 * dims[-1][0] * (dims[-1][1] // 2) * d
    macs += cfg["n_layers"] * frames * (4 * d * d + d * (d // hd) + 2 * d * cfg["ff_mult"] * d)
    macs += frames * d * 2
    return 2.0 * macs + attention_flops(cfg, frames)


def bias_head(w: dict, mels: List[np.ndarray], cfg: dict, device, beats_per_s: float = 2.0,
              downbeats_per_s: float = 0.5) -> None:
    """Sets the head's two biases in ``w`` (in place) so that over ``mels``
    ((T, bins) each, chunked as ``predict`` runs a piece), pooled, about
    ``beats_per_s`` beat and ``downbeats_per_s`` downbeat peaks a second rise
    above 0: the rates of music at 120 BPM in 4/4. With random weights a
    constant offset, which differs by seed by many times the logits' spread
    over time, would otherwise leave a song no peak above 0, or make every
    local maximum one. A bias moves its logit's local maxima across 0 and
    leaves their frames: 0 falls halfway between the pooled maxima ranked at
    the wanted count and one past it. The beat logit is the sum of both
    outputs, so its bias is the sum of both biases."""
    bias = w["task_heads.beat_downbeat_lin.bias"]
    bias.zero_()
    beat_max, down_max, seconds = [], [], 0.0
    for mel in mels:
        beat, down = predict(w, mel, cfg, device)
        beat_max.append(beat[local_maxima(beat)])
        down_max.append(down[local_maxima(down)])
        seconds += len(beat) / cfg["fps"]

    def level(maxima: list, per_s: float) -> float:
        v = np.sort(np.concatenate(maxima).astype(np.float64))[::-1]
        k = min(max(round(per_s * seconds), 1), len(v) - 1)
        return 0.5 * (v[k - 1] + v[k])

    bias[1] = -level(down_max, downbeats_per_s)
    bias[0] = -level(beat_max, beats_per_s) - bias[1]
