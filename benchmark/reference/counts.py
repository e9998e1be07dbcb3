"""Frozen operation and byte counts, and the published peaks they are held to.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores (the configurations
run float32 with TF32 off) and 3.35 TB/s of HBM3. FLOPs count a multiply
and an add as two; a conv's work is counted over the frames it is given.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# Non-zero tap pairs of the 81-tap half-band filter (every odd offset is 0).
HALFBAND_PAIRS = 20
WINDOW, N_BINS, BPO, N_OCTAVES, HOP = 256, 96, 12, 8, 256


def bound_s(nbytes: float, flops: float) -> float:
    """The least time one card can take: the larger of bytes over peak
    bandwidth and operations over peak float32 rate, in seconds."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS)


def downcnn_flops_per_frame(cfg: dict) -> float:
    """Forward FLOPs of one Down_CNN stream and its head a frame
    (414,036,224 at the published widths)."""
    pools = {int(k): v for k, v in cfg["pool_after"].items()}
    macs, h, cin = 0, cfg["bins"], 1
    for i, (cout, (kh, kw)) in enumerate(cfg["convs"]):
        macs += kh * kw * cin * cout * h
        h //= pools.get(i, 1)
        cin = cout
    return 2.0 * (macs + cfg["embed_dim"])


def tcn_flops_per_frame(cfg: dict) -> float:
    """Forward FLOPs of BockTCN a frame."""
    c, k, h, cin, macs = cfg["channels"], cfg["front_kernel"], cfg["bins"], 1, 0
    for pool in cfg["pools"]:
        macs += k * k * cin * c * h
        h //= pool
        cin = c
    macs += len(cfg["dilations"]) * (cfg["tcn_kernel"] * c * c + c * c) + c
    return 2.0 * macs


def forward_flops(cfg: dict, batch: int, frames: int) -> float:
    """Forward FLOPs of the configuration on ``batch`` songs of ``frames``
    (both streams of a twin)."""
    if cfg["model"] == "down_cnn":
        return 2.0 * batch * frames * downcnn_flops_per_frame(cfg)
    return batch * frames * tcn_flops_per_frame(cfg)


def train_flops(cfg: dict, batch: int, frames: int) -> float:
    """A train step: forward and backward, counted as three forwards."""
    return 3.0 * forward_flops(cfg, batch, frames)


def vqt_kernel_bounds_s(batch: int, samples: int) -> dict:
    """Least times of the two log-VQT kernels on ``batch`` signals of
    ``samples``: the half-band cascade reads its padded input once and
    writes 7 levels (41 taps an output); the octave kernel reads 256 samples
    a frame from each octave's level, the 8 x 256 x 24 float32 banks, and
    writes 96 bins a frame (24 x 256 MACs a frame an octave, plus the
    magnitude and log)."""
    pad2 = 2 * ((WINDOW // 2 + 1) << (N_OCTAVES - 1))
    len0 = -(-(samples + 2 * pad2) // 256) * 256
    n_out = sum(len0 >> s for s in range(1, N_OCTAVES))
    frames = 1 + samples // HOP
    cascade = bound_s(4.0 * batch * (len0 + n_out), 2.0 * (1 + 2 * HALFBAND_PAIRS) * batch * n_out)
    o_in = sum((frames - 1) * (HOP >> (N_OCTAVES - 1 - j)) + WINDOW for j in range(N_OCTAVES))
    octave = bound_s(4.0 * batch * (o_in + N_BINS * frames) + 4.0 * N_OCTAVES * WINDOW * 2 * BPO,
                     N_OCTAVES * batch * frames * (2.0 * 2 * BPO * WINDOW + 5 * BPO))
    return {"cascade_kernel": cascade, "octaves_kernel": octave}
