#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zeronotesamba_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace]

It checks the port on the card and times its kernels alone. The system's
end-to-end numbers are the benchmark's (benchmark/run.py), not this
script's.

Phases, each printing one JSON line:

1. device     -- refuse to run without CUDA; card name and power limit; TF32 off.
2. build      -- compile the kernels from csrc/ with nvcc (parallel, one per source),
                 and the native DBN's C++ source with g++ beside them.
3. kernels    -- each kernel against its plain PyTorch version on the card at the
                 main path's shapes (and batch 2 x 10 s, 32 x 10 s, 1 x 0.5 s, and
                 a ragged 3 x 7.3 s), with times: kernel, plain version, one
                 library call, and the card's bound.
   conv       -- the encoders' conv kernel at each of the 8 convs and at the song
                 (1 x 1,876), fine-tune (8 x 1,920), pretext (16 x 313) and one
                 mesh time rank's (8 x 480 and its halo) shapes: against a
                 float64 conv within float32's rounding bound, the same bits
                 twice, and its times beside the bound, the plain F.conv2d
                 and cuDNN's per-shape pick (cudnn.benchmark, set only here);
                 then the weight-gradient kernel at each conv and the three
                 training shapes, the same way against the float64 weight
                 and bias gradients, the plain convolution_backward and
                 cuDNN's pick.
   deconv     -- Spleeter's decoder kernel at each of a U-Net's six decoder
                 blocks at the published widths, four nets at S = 3 (a 30 s
                 song): against float64 within its rounding bound, the same
                 bits twice, and the device time of the four nets' launches
                 beside the card's bound, the plain version (the four phases
                 as cuDNN convs) and the chain it replaces (cat, cuDNN's
                 ConvTranspose2d, crop, ReLU, BatchNorm).
4. main_path  -- BeatTracker.track_signal on a 30 s click track on the card and on
                 the CPU with the same seeded weights; launch counters; the DBN
                 backend (its forward pass on the card), against the native
                 C++ and numpy decodes of the same pulse; one bfloat16
                 track_signal (shape, finite); the librosa decoder; Ellis DP
                 on the raw clicks; the CLI.
5. decode     -- the batched DBN Viterbi kernel on its path at three shapes,
                 each decoded once through a device entry point with its one
                 launch counted: 20 ragged songs padded to 3,750 frames and
                 1,000 ragged 30 s songs (decode_beats_batch_device), and the
                 main path's pulse alone (decode_beats_device); at each, the
                 kernel against its plain version exactly, its time at 64 to
                 512 threads a block, the gated songs' beats against the
                 float64 DBN, and the host backtrack's share; native against
                 numpy and the online DBN on the 20-song batch.
6. train      -- the supervised training path, one JSON line per part: the ETL
                 (build_synthetic, 16 songs x 12 s, on the card, with its kernel
                 launches counted and two songs held against the CPU), one
                 train_step card vs CPU, the 4-fold experiment (mean held-out
                 F1 >= 0.9, class-balanced BCE), and the build-data / beat CLI.
7. pretext    -- self-supervised pretext training, one JSON line per part: the
                 banks (mine_stems with HPSS on 12 synthetic 12 s mixes and a
                 tone, the stem bank and the CLMR bank on the card, launches
                 counted, two items held against the CPU), one staged k = 2
                 NT-Xent step card vs CPU, a 3-epoch train_pretext with
                 proxy-F1 selection and one resumed epoch, and the pretext /
                 infer CLI.
8. evaluate   -- the evaluation path: one BockTCN train step card vs CPU, its step
                 time at batch 8 x 768, 20 steps that must lower the loss, and
                 the beat --status bock / cross / few-shot / measures /
                 old-school / track-dir / resave CLI (track-dir --decoder dbn
                 as a subprocess, the rest through cli.main in this process).
9. separator  -- the learned separator, one JSON line per part: one MaskNet
                 train_step card vs CPU, step times at batch 8 x 256 frames, the
                 shipped weights' SI-SDR on synth_bank(8, 12 s, 999) against the
                 JAX package's and the card's HPSS, a 20-step train_separator and
                 the train-separator CLI, and the learned serving path: a 30 s
                 click track through track_signal(separation="learned") on the
                 card and the CPU, launches counted, the DBN's three decodes
                 of its pulse, and infer / track-dir --separation learned;
                 then one untimed track_signal(separation="spleeter") of a
                 30 s click track at 44.1 kHz at Spleeter's published
                 widths, its magnitude, masks and streams against the plain
                 reference (benchmark/reference/spleeter.py).
10. suite     -- run_demo_suite at a small size on the card (launches counted;
                 finite results, F1 in [0, 1], the JAX suite's key tree), the
                 export-xlsx CLI on its output, resample_device card vs CPU, and
                 the card's log-VQT against the direct float64 oracle.
11. mesh      -- data parallelism over torch.distributed, one JSON line per part,
                 at full width (the twin, batch 16 x 313, float32, TF32 off): on
                 a world of one NCCL rank in this process the track-parallel
                 step (k = 2, dropout on) against the single-device step, both
                 timed, and ntxent_global against ntxent; two gloo ranks sharing
                 the card (run_ranks) against the single-rank k = 4 step and
                 ntxent on the global batch; pretext --data-parallel
                 --stem-root on phase 7's stems as a subprocess (one NCCL rank
                 a card), the VQT launches of its bank build as its rank 0
                 counts and prints them, and infer --params with its checkpoint;
                 then the time and model axes: parallel/dryrun.entry() card vs
                 CPU; dryrun_multichip(4) on four gloo ranks sharing the card,
                 each stage's lap; and one supervised step of the twin at
                 batch 8 x 768 (dropout 0) on a (1, 2, 1) and a (1, 1, 2) mesh
                 of two gloo ranks against the single-device step, with its
                 time, halo and channel bytes and peak memory a rank.
12. multistep -- steps_per_call, cuDNN deterministic: at the train and pretext
                 cells' shapes (the twin at 8 x 768 in float32 and bf16,
                 BockTCN at 8 x 768, the zerons step at 16 x 313 in float32
                 and bf16 and its k = 2 track step in bf16), one K = 8 call
                 (one CUDA graph, captured at the first call) against 8
                 eager steps of the same code from the same state: losses
                 finite, and losses, outputs and parameters bit for bit; ms
                 a step at K = 1 and K = 8, the capture's seconds, peak
                 memory and the device's idle share each way from the
                 profiler; then beat
                 --steps-per-call 8 against --steps-per-call 1 (4 folds,
                 batch 1): the same fold F1s and results.

Then the kernels summary line, the nvidia-smi line, and a last line
{"ok": true, "device": {...}}. Every line also goes to
chiprun_out/chip_smoke/smoke.jsonl in the checkout, whole, however much of
the standard output is kept. Any failed check raises and the exit code is
not 0. It imports nothing of JAX.

A kernel's ``ms`` (and ``plain_ms``, ``library_ms``) is its device time:
CUDA events around the replay of a CUDA graph of back-to-back calls, so the
host's launch cost is not in it and no tracer is needed. That is the number
held against ``bound_ms``. The CUDA-event time around the Python wrapper,
which also counts the argument checks and the ctypes call, is ``event_ms``
beside it. ``--trace`` adds torch.profiler readings: each kernel's self
device time in a trace (``trace_ms``, ``plain_trace_ms``,
``library_trace_ms``). The default run uses no profiler, so it does not
depend on CUPTI being free for this process.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.counts import PEAK_BYTES_S, PEAK_FP32_FLOPS

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
LOG_PATH = os.path.join(OUT_DIR, "smoke.jsonl")

SR = 16000
FPS = 62.5
CASCADE_TOL = dict(rtol=1e-5, atol=1e-5)
OCTAVE_ATOL = 1e-4  # log magnitudes, float32 sums in another order
VQT_ATOL = 5e-4  # kernels vs plain conv path, as the JAX package's Pallas tests
PULSE_ATOL = 1e-3  # card vs CPU: cuDNN may pick FFT/Winograd sums
LOG_FLOOR = -7.0  # log |X| at or below which a VQT cell holds float32 rounding noise
NEAR_EMPTY_ATOL = 1e-2  # such cells' log, JAX vs port on the CPU (tests/test_torch_infer.py)
# The same limit at the floor as an absolute error in |X|: a near-empty cell
# holds rounding noise of a fixed size, so deeper cells show a larger log error.
NEAR_EMPTY_MAG_ATOL = NEAR_EMPTY_ATOL * math.exp(LOG_FLOOR)
ETL_SONGS, ETL_SONG_S = 16, 12.0
PARITY_FRAMES = 768  # a 12 s song's 751 frames in its bucket
PARITY_LOSS_RTOL = 1e-4  # one train_step, card vs CPU
# The same step's gradients, card vs CPU, per tensor, as a share of that
# tensor's largest |g|: a max-pool tie moves a tensor by about 1e-3 of it, a
# wrong backward by about 1.
PARITY_GRAD_REL = 1e-2
EXPERIMENT_F1_MIN = 0.9
# The experiment's seed (fold split, initial weights, shuffles, dropout).
# pos_weight 8 and patience 60 were chosen on seed 0's folds, and patience 35
# lost a fold on seed 1, so the gate runs on seed 2, where no recipe was tried.
EXPERIMENT_SEED = 2
PRETEXT_TRACKS, PRETEXT_SONG_S = 12, 12.0
PRETEXT_CROP = 313  # the reference's crop; bank items of 10 s clips hold 626 frames
PRETEXT_FRAMES = 626
# The gate's lower bound for mining: these synthetic mixes balance drums and
# the rest in 17% to 37% of their frames after HPSS, under the default 0.3.
PRETEXT_LOWER_P = 0.1
PRETEXT_K2_RTOL = 1e-5  # the k = 2 step vs the mean of its tracks' NT-Xent, on the card
OLD_SCHOOL_F1_MIN = 0.8  # Ellis DP on a raw click track (tests/test_decoders.py)
KERNEL_SOURCES = {
    "cascade": ("zeronotesamba_torch/csrc/vqt_cascade.cu", "zeronotesamba_tpu/ops/pallas/vqt_kernel.py:157"),
    "octave": ("zeronotesamba_torch/csrc/vqt_octave.cu", "zeronotesamba_tpu/ops/pallas/vqt_kernel.py:32"),
    "viterbi": ("zeronotesamba_torch/csrc/dbn_viterbi.cu", "zeronotesamba_tpu/decode/dbn_jax.py:23"),
    "conv": ("zeronotesamba_torch/csrc/conv_fprop.cu", "none: the encoders' convs, which the JAX package leaves to XLA"),
    "wgrad": ("zeronotesamba_torch/csrc/conv_wgrad.cu",
              "none: the encoders' convs' weight gradients, which the JAX package leaves to XLA"),
    "deconv": ("zeronotesamba_torch/csrc/deconv_fprop.cu",
               "none: Spleeter's decoder blocks (the JAX package has no Spleeter)"),
}
# Golden activations whose device (float32) beats must equal the float64
# decode's; on the others (noise, near-silence, short, seeded-weight pulses)
# float32 rounding may pick another path, so their differences are reported.
DECODE_GATED = ("clean_", "jitter_", "weak_", "ramp_")
ONLINE_F1_MIN = 0.9  # online vs offline DBN on the clean activations (tests/test_dbn_online.py)
# The decode phase's evaluation set: GTZAN's 1,000 30 s excerpts as one batch.
DECODE_CORPUS_SONGS, DECODE_CORPUS_FRAMES, DECODE_CORPUS_SEED = 1000, 1876, 0
VITERBI_THREADS = (64, 128, 256, 512)  # the Viterbi kernel's block sizes timed at each decode shape
VITERBI_THREADS_F64 = (64, 128, 256, 384)  # and its float64 instance's (at most 384)
SEP_LR = 1e-3  # the separator step parity's Adam lr
# The shipped separator's mean SI-SDR (dB, drums and rest) on
# synth_bank(8, 12.0, 999), and HPSS's, from the JAX package on a CPU: the
# card must come within SEP_SI_SDR_ATOL of the first and beat its own HPSS.
# (results/separator_report.json's 15.82 / 28.61 came from an earlier synth_bank.)
SEP_JAX_SI_SDR = (15.4440, 28.6762)
SEP_SI_SDR_ATOL = 0.05
SEP_BATCH = 8  # the JAX CLI's default batch, of CROP_FRAMES (256) frames
SEP_TRAIN_STEPS, SEP_TRAIN_SONGS, SEP_EVAL_EVERY = 20, 8, 10
SUITE = dict(n_songs=8, n_songs_b=6, pretext_songs=12, pretext_epochs=3, folds=2, max_epochs=3, patience=3,
             few_shot_sizes=(1, 2), few_shot_repeats=1, few_shot_max_epochs=3, proxy_songs=2, seed=0)
RESAMPLE_ATOL = 1e-4  # resample_device card vs CPU, on a signal of peak 1
MESH_ONE_RANK_ATOL = 1e-7  # a one-rank NCCL mesh step vs the single-device step (cuDNN deterministic)
# Two gloo ranks on one card vs the single-rank k = 4 step: loss and cosines
# 1e-5 relative (tighter than the card-vs-CPU step's 1e-4), gradients
# PARITY_GRAD_REL of each tensor's largest, params 2 lr plus rounding.
MESH_LOSS_RTOL = 1e-5
MESH_NTX_GRAD_ATOL = 1e-6  # ntxent_global's gradients vs ntxent on the global batch (tests/test_ntxent.py)
MESH_SHARD = 2  # stem-bank tracks a rank in the two-rank step
MESH_DRYRUN_RANKS = 4  # dryrun_multichip's ranks, gloo, sharing the card
MESH_AXES_STEPS = 3  # timed supervised steps on each (1, 2, 1) and (1, 1, 2) mesh after the checked one


def out_line(line: str) -> None:
    """Print one line and append it to LOG_PATH."""
    print(line, flush=True)
    with open(LOG_PATH, "a") as fh:
        fh.write(line + "\n")


def emit(phase: str, **kw) -> None:
    out_line(json.dumps({"phase": phase, **kw}))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@functools.lru_cache(maxsize=1)
def _capture_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call: CUDA events around one replay of a CUDA
    graph of n back-to-back calls, over n; the median of ``reps`` replays.
    fn is warmed up on the capture stream first."""
    stream = _capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def trace_ms(fn, kernel: str | None = None, n: int = 20) -> float:
    """Device time of one fn() call: the self device time of every kernel and
    copy in a torch.profiler trace of n back-to-back warm calls, over n.
    With ``kernel``, a kernel of that name must be in the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernel is not None:
        check(any(kernel in e.key for e in events), f"{kernel} is not in the device trace")
    total_us = sum(e.self_device_time_total for e in events)
    check(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs one CUDA card")
    os.makedirs(OUT_DIR, exist_ok=True)
    open(LOG_PATH, "w").close()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from zeronotesamba_torch.device import disable_tf32

    disable_tf32()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build() -> None:
    """Every CUDA source with its own nvcc, all started together, and the
    native DBN's C++ source with g++ beside them."""
    from concurrent.futures import ThreadPoolExecutor

    from zeronotesamba_torch.decode import dbn_native
    from zeronotesamba_torch.ops.cuda import build

    def native() -> float:
        t0 = time.perf_counter()
        dbn_native.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        native_s = pool.submit(native)
        secs = build.build_all()
        native_s = native_s.result()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "smem", "spill"))]
             for n, log in build.build_logs().items()}
    emit("build", seconds=secs, dir=os.path.relpath(build.build_dir(), ROOT), ptxas=ptxas,
         native_dbn=dict(seconds=native_s, library=os.path.relpath(dbn_native.library_path(), ROOT),
                         flags=list(dbn_native.CXX_FLAGS)))


def _counted(prefix: str, before: dict) -> dict:
    """The counters under ``prefix`` (utils/profiling.totals) since the
    snapshot ``before`` (``profiling.totals()``), keyed without the prefix."""
    from zeronotesamba_torch.utils import profiling

    return {k[len(prefix):]: n - before.get(k, 0) for k, n in profiling.totals().items() if k.startswith(prefix)}


def _signal(batch: int, seconds: float, seed: int) -> torch.Tensor:
    y = np.random.default_rng(seed).standard_normal((batch, int(seconds * SR))).astype(np.float32)
    return torch.tensor(0.1 * y, device="cuda")


def phase_kernels(stats: dict, trace: bool) -> None:
    from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
    from zeronotesamba_torch.ops.filterbank import XQTParams
    from zeronotesamba_torch.ops.vqt import log_xqt

    params = XQTParams()
    banks = vk.octave_banks(params, torch.device("cuda"))
    plan = vk.octave_plan(params)
    taps = vk.halfband_taps(torch.device("cuda"))[None, None, :]
    n_taps = taps.shape[-1]
    lib_w = torch.cat([banks[j].t()[:, None, :] for j in range(params.n_octaves)]).view(
        params.n_octaves, 24, 1, 256)
    # (name, batch, seconds): the main path's shape first (anchor + positive of a 30 s clip).
    # The last is ragged: neither its cascade input is a multiple of the cascade's
    # 8,192-sample tile nor its 457 frames a multiple of the octave's 128-frame tile.
    shapes = [("main_path_b2_30s", 2, 30.0), ("b2_10s", 2, 10.0), ("b32_10s", 32, 10.0), ("b1_0.5s", 1, 0.5),
              ("ragged_b3_7.3s", 3, 7.3)]
    for k, (name, batch, secs) in enumerate(shapes):
        y = _signal(batch, secs, seed=100 + k)
        n_frames = params.num_frames(y.shape[1])
        x0 = vk.cascade_input(y, params)
        packed = vk.decimation_cascade_packed(x0, 7)
        got = vk.unpack_levels(packed, x0.shape[1])
        ref = vk.decimation_cascade_plain(x0, 7)
        torch.cuda.synchronize()
        c_err = 0.0
        for s, (g, r) in enumerate(zip(got, ref)):
            check(g.shape == r.shape, f"cascade level {s + 1} shape {g.shape} != {r.shape}")
            torch.testing.assert_close(g, r, **CASCADE_TOL, msg=lambda m: f"cascade level {s + 1} ({name}): {m}")
            c_err = max(c_err, (g - r).abs().max().item())
        levels = (x0,) + tuple(got)
        table = vk.octave_table(params, x0.shape[1])

        def octaves(fn, out):
            fn(x0, packed, table, banks, out, log_eps=params.log_eps)

        out_k = torch.full((batch, params.n_bins, n_frames), float("nan"), device="cuda")
        out_p = torch.full_like(out_k, float("nan"))
        octaves(vk.octaves_log_xqt, out_k)
        octaves(vk.octaves_log_xqt_plain, out_p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"octave kernel left non-finite cells ({name})")
        o_err = (out_k - out_p).abs().max().item()
        check(o_err <= OCTAVE_ATOL, f"octave kernel vs plain max |err| {o_err} > {OCTAVE_ATOL} ({name})")
        full = vk.log_xqt_fused(y, params)
        plain = log_xqt(y, params)
        v_err = (full - plain).abs().max().item()
        check(full.shape == plain.shape and v_err <= VQT_ATOL,
              f"log_xqt_fused vs log_xqt max |err| {v_err} > {VQT_ATOL} ({name})")

        len0 = x0.shape[1]
        n_out = sum(len0 >> s for s in range(1, 8))
        # The cascade's operations are those of the 41 non-zero taps (centre + 20 pairs).
        c_bound, c_by = bound(4.0 * batch * (len0 + n_out), 2.0 * (1 + 2 * vk.PAIRS) * batch * n_out)
        o_in = sum((n_frames - 1) * hop + 256 for _, _, _, _, hop in plan)
        o_bound, o_by = bound(4.0 * batch * (o_in + params.n_bins * n_frames) + 4.0 * banks.numel(),
                              params.n_octaves * batch * n_frames * (2.0 * 24 * 256 + 5 * 12))

        def lib_cascade():
            h = x0[:, None, :]
            for _ in range(7):
                h = F.conv1d(h, taps, stride=2, padding=n_taps // 2)

        def lib_octave():
            for j, dec, row, offset, hop in plan:
                span = levels[dec][:, None, offset: offset + (n_frames - 1) * hop + 256]
                F.conv1d(span, lib_w[j], stride=hop)

        def times(kernel_fn, kernel_name, plain_fn, lib_fn) -> dict:
            """ms / plain_ms / library_ms from CUDA-graph replays, the
            CUDA-event times around each Python call beside them, and with
            ``trace`` the profiler's device times."""
            out = dict(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn), library_ms=device_ms(lib_fn),
                       event_ms=time_ms(kernel_fn), plain_event_ms=time_ms(plain_fn),
                       library_event_ms=time_ms(lib_fn))
            if trace:
                out.update(trace_ms=trace_ms(kernel_fn, kernel_name), plain_trace_ms=trace_ms(plain_fn),
                           library_trace_ms=trace_ms(lib_fn))
            return out

        row = dict(
            shape=name, batch=batch, seconds=secs, len0=len0, n_frames=n_frames,
            cascade=dict(max_abs_err=c_err, bound_ms=c_bound, bound_by=c_by,
                         **times(lambda: vk.decimation_cascade_packed(x0, 7), "cascade_kernel",
                                 lambda: vk.decimation_cascade_plain(x0, 7), lib_cascade)),
            octave=dict(max_abs_err=o_err, bound_ms=o_bound, bound_by=o_by, launches_per_call=1,
                        **times(lambda: octaves(vk.octaves_log_xqt, out_k), "octaves_kernel",
                                lambda: octaves(vk.octaves_log_xqt_plain, out_p), lib_octave)),
            log_xqt_fused=dict(max_abs_err_vs_log_xqt=v_err, ms=time_ms(lambda: vk.log_xqt_fused(y, params)),
                               plain_log_xqt_ms=time_ms(lambda: log_xqt(y, params))),
        )
        emit("kernels", **row)
        for kname in ("cascade", "octave"):
            stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], row[kname]["max_abs_err"])
            if k == 0:  # summary times at the main path's shape
                stats[kname].update({f: v for f, v in row[kname].items()
                                     if f in ("ms", "bound_by") or f.endswith("_ms")})
    # cuBLAS keeps a workspace for each stream that ran a matmul (the capture
    # stream among them); free them so that later phases' peak memory is
    # the model's own.
    torch._C._cuda_clearCublasWorkspaces()


# The encoder's conv shapes: (name, batch, frames, same padding). "mesh" is one
# time rank of four at the fine-tune batch: 480 frames with the halo frames
# of its neighbours, padded in frequency only (models/encoder.Encoder._conv).
CONV_SHAPES = (("song", 1, 1876, True), ("finetune", 8, 1920, True), ("pretext", 16, 313, True),
               ("mesh_t4", 8, 480, False))
CONV_ROUNDING = 2.0 ** -24  # float32's unit roundoff


def _conv_inputs(i: int, batch: int, frames: int, same: bool, seed: int):
    """Conv i's input, weights, bias and padding at a shape, from a seed."""
    from zeronotesamba_torch.models.encoder import CONV_SPECS, POOL_AFTER

    h, cin = 96, 1
    for j in range(i):
        cin = CONV_SPECS[j][0]
        h //= POOL_AFTER.get(j, 1)
    cout, (kh, kw) = CONV_SPECS[i]
    t = frames if same else frames + 2 * (kw // 2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, cin, h, t, device="cuda", generator=gen)
    w = torch.randn(cout, cin, kh, kw, device="cuda", generator=gen) * math.sqrt(2.0 / (cin * kh * kw))
    b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
    return x, w, b, ((kh // 2, kw // 2) if same else (kh // 2, 0))


def phase_conv(stats: dict) -> None:
    """The encoders' conv kernel against a float64 conv on the card, at each
    conv and CONV_SHAPES shape: within the rounding bound of a float32 FFMA
    chain of its taps (each output's error at most (taps + 1) u times the
    float64 conv of |x| and |w| plus |b|), the same bits twice, and its times
    beside the card's bound, the plain version (F.conv2d as the port called
    it before the kernel) and cuDNN's own pick per shape (benchmark mode,
    set here only)."""
    from zeronotesamba_torch.ops.cuda import conv_kernel as ck

    totals = {}
    for s, (shape, batch, frames, same) in enumerate(CONV_SHAPES):
        for i in range(8):
            x, w, b, padding = _conv_inputs(i, batch, frames, same, seed=10 * i + s)
            cout, cin, kh, kw = w.shape
            wt = ck.kernel_weights(w)
            y = ck.launch(x, wt, b, padding)
            y2 = ck.launch(x, wt, b, padding)
            plain = ck.conv2d_plain(x, w, b, padding)
            ref = F.conv2d(x.double(), w.double(), b.double(), padding=padding)
            scale = F.conv2d(x.double().abs(), w.double().abs(), b.double().abs(), padding=padding)
            torch.cuda.synchronize()
            check(torch.equal(y, y2), f"conv {i + 1} ({shape}): two runs differ")
            err = (y.double() - ref).abs()
            ratio = (err / (scale * (cin * kh * kw + 1) * CONV_ROUNDING)).max().item()
            check(y.shape == ref.shape and ratio <= 1.0,
                  f"conv {i + 1} ({shape}): error {ratio} of the float32 rounding bound")
            flops = 2.0 * y.numel() * cin * kh * kw
            n = max(2, min(20, int(2e10 / flops)))
            tiles = ck._tiles(torch.cuda.current_device(), batch, cin, cout, kh, kw, *y.shape[2:])
            times = dict(ms=device_ms(lambda: ck.launch(x, wt, b, padding), n=n, reps=3),
                         wrapper_ms=device_ms(lambda: ck.conv2d(x, w, b, padding), n=n, reps=3),
                         plain_ms=device_ms(lambda: ck.conv2d_plain(x, w, b, padding), n=n, reps=3))
            torch.backends.cudnn.benchmark = True
            try:
                times["library_ms"] = device_ms(lambda: F.conv2d(x, w, b, padding=padding), n=n, reps=3)
            finally:
                torch.backends.cudnn.benchmark = False
            bound_ms, bound_by = bound(4.0 * (x.numel() + w.numel() + y.numel()), flops)
            row = dict(conv=i + 1, shape=shape, batch=batch, cin=cin, cout=cout, h=x.shape[2], t=x.shape[3],
                       kernel=[kh, kw], padding=list(padding), tiles=tiles._asdict(), bound_ms=bound_ms,
                       bound_by=bound_by, **times, fp32_peak_share=bound_ms / times["ms"],
                       max_abs_err_f64=err.max().item(), rounding_bound_share=ratio,
                       max_abs_diff_plain=(y - plain).abs().max().item(), bitwise_repeat=True)
            emit("conv", **row)
            tot = totals.setdefault(shape, dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                 bound_ms=0.0))
            for k in tot:
                tot[k] += row[k]
            stats["conv"]["max_abs_err"] = max(stats["conv"]["max_abs_err"], row["max_abs_err_f64"])
            del x, w, b, wt, y, y2, plain, ref, scale, err
        torch.cuda.empty_cache()
    for shape, tot in totals.items():
        emit("conv", part="sum", shape=shape, **tot, fp32_peak_share=tot["bound_ms"] / tot["ms"])
    # One stream's eight convs at the song's shape for the kernels summary.
    stats["conv"].update(totals["song"], bound_by="operations")
    _conv_wgrad(stats)


# The weight gradient's shapes: those of training (fine-tune, pretext, a mesh time rank).
WGRAD_SHAPES = CONV_SHAPES[1:]


def _conv_wgrad(stats: dict) -> None:
    """The weight-gradient kernel against the float64 weight and bias
    gradients on the card, at each conv and WGRAD_SHAPES shape: within both
    bounds of its split sums (ops/cuda/conv_kernel.wgrad_reference: the
    worst case, gamma(n) times the sum of |t|, and the probable, 7 sqrt(n) u
    times the root of the sum of t^2, t = gy x, for these independent
    zero-mean inputs), the same bits twice, and its times beside the card's
    bound, the plain version (convolution_backward with the mask [False,
    True, True], cuDNN's heuristic pick, as the port called it before the
    kernel) and cuDNN's own pick per shape (benchmark mode). The plain
    version's error against float64 is printed beside the kernel's."""
    from zeronotesamba_torch.ops.cuda import conv_kernel as ck

    totals = {}
    for s, (shape, batch, frames, same) in enumerate(WGRAD_SHAPES):
        for i in range(8):
            x, w, _, padding = _conv_inputs(i, batch, frames, same, seed=100 + 10 * i + s)
            cout, cin, kh, kw = w.shape
            gy = torch.randn(batch, cout, x.shape[2], frames, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(200 + 10 * i + s))
            gw, gb = ck.wgrad(x, gy, kh, kw, padding, True)
            gw2, gb2 = ck.wgrad(x, gy, kh, kw, padding, True)
            plain_w, plain_b = ck.wgrad_plain(x, gy, w, padding, True)
            layout, plan = ck.wgrad_plan(x, cout, kh, kw, padding)
            (ref, ref_b), worst, probable = ck.wgrad_reference(x, gy, w.shape, padding, ck.wgrad_chains(layout, plan))
            torch.cuda.synchronize()
            check(torch.equal(gw, gw2) and torch.equal(gb, gb2), f"wgrad {i + 1} ({shape}): two runs differ")
            err, err_b = (gw.double() - ref).abs(), (gb.double() - ref_b).abs()
            shares = {k: (e / bnd).max().item() for k, e, bnd in
                      (("worst", err, worst[0]), ("probable", err, probable[0]), ("bias_worst", err_b, worst[1]),
                       ("bias_probable", err_b, probable[1]))}
            check(max(shares.values()) <= 1.0, f"wgrad {i + 1} ({shape}): error over its rounding bounds {shares}")
            flops = 2.0 * gy.numel() * cin * kh * kw
            n = max(2, min(20, int(2e10 / flops)))
            times = dict(ms=device_ms(lambda: ck.wgrad(x, gy, kh, kw, padding, True), n=n, reps=3),
                         plain_ms=device_ms(lambda: ck.wgrad_plain(x, gy, w, padding, True), n=n, reps=3))
            torch.backends.cudnn.benchmark = True
            try:
                times["library_ms"] = device_ms(lambda: ck.wgrad_plain(x, gy, w, padding, True), n=n, reps=3)
            finally:
                torch.backends.cudnn.benchmark = False
            bound_ms, bound_by = bound(4.0 * (x.numel() + gy.numel() + w.numel() + cout), flops)
            row = dict(part="wgrad", conv=i + 1, shape=shape, batch=batch, cin=cin, cout=cout, h=x.shape[2],
                       t=x.shape[3], kernel=[kh, kw], padding=list(padding), plan=plan._asdict(), bound_ms=bound_ms,
                       bound_by=bound_by, **times, fp32_peak_share=bound_ms / times["ms"],
                       max_abs_err_f64=err.max().item(), max_abs_err_f64_bias=err_b.max().item(),
                       plain_max_abs_err_f64=(plain_w.double() - ref).abs().max().item(),
                       plain_max_abs_err_f64_bias=(plain_b.double() - ref_b).abs().max().item(),
                       rounding_bound_shares=shares, bitwise_repeat=True)
            emit("conv", **row)
            tot = totals.setdefault(shape, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0))
            for k in tot:
                tot[k] += row[k]
            stats["wgrad"]["max_abs_err"] = max(stats["wgrad"]["max_abs_err"], row["max_abs_err_f64"])
            del x, w, gy, gw, gb, gw2, gb2, plain_w, plain_b, ref, ref_b, worst, probable, err, err_b
        torch.cuda.empty_cache()
    for shape, tot in totals.items():
        emit("conv", part="wgrad_sum", shape=shape, **tot, fp32_peak_share=tot["bound_ms"] / tot["ms"])
    # One stream's eight weight gradients at the fine-tune's shape for the kernels summary.
    stats["wgrad"].update(totals["finetune"], bound_by="operations")


DECONV_SEGMENTS = 3  # a 30 s song's segments at 44.1 kHz, each net's batch
DECONV_CALLS = 5  # calls of the four nets' launches a timed graph holds


def _deconv_reference(skip, u, deconv, bn) -> tuple:
    """A decoder block in float64 from the same float32 inputs, and a bound
    on the kernel's error: an output's sum holds at most 9 cin products and
    the bias in float32 FFMA chains and their in-order adds, each rounding at
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
    bound = (9 * x.shape[1] + 10) * CONV_ROUNDING * za * v(scale.abs()) + 8 * CONV_ROUNDING * (
        F.relu(z) * v(scale.abs()) + v(shift.abs()))
    return ref, bound


def phase_deconv(stats: dict) -> None:
    """Spleeter's decoder kernel at each decoder block of the four nets at
    the published widths and S = DECONV_SEGMENTS, seeded weights and
    Gaussian inputs: each net's output against float64 within the rounding
    bound of its sums (``_deconv_reference``), the same bits twice, and the
    device time of the four nets' launches (CUDA events around a graph of
    DECONV_CALLS calls) beside the card's bound, the plain version
    (``block_plain``: the four phases as cuDNN convs, the epilogue in
    PyTorch) and the chain the kernel replaces (``torch.cat``, cuDNN's
    ConvTranspose2d with the crop, ReLU, BatchNorm; TF32 off, cuDNN's
    heuristic pick, as the port ran it)."""
    from zeronotesamba_torch.models.spleeter import Spleeter, up
    from zeronotesamba_torch.ops.cuda import deconv_kernel as dk

    with torch.device("cuda"):
        model = Spleeter()
    model.reset_parameters(torch.Generator().manual_seed(23))
    model.eval()
    nets = list(model.nets.values())
    f, cfg = model.cfg.filters, model.cfg
    gen = torch.Generator(device="cuda").manual_seed(29)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    with torch.inference_mode():
        for k in range(6):
            h, w = cfg.T >> (6 - k), cfg.F >> (6 - k)
            c_skip, c_u = (0, f[-1]) if k == 0 else (f[-1 - k], f[-1 - k])
            cin, cout = c_skip + c_u, nets[0].dec[k].out_channels
            blocks = []
            for net in nets:
                skip = torch.randn(DECONV_SEGMENTS, c_skip, h, w, device="cuda", generator=gen) if c_skip else None
                u = torch.randn(DECONV_SEGMENTS, c_u, h, w, device="cuda", generator=gen)
                blocks.append((skip, u, net.dec[k], net.dec_bn[k]))
            ratio = err = 0.0
            for args in blocks:
                y, y2 = dk.decoder_block(*args), dk.decoder_block(*args)
                ref, bnd = _deconv_reference(*args)
                torch.cuda.synchronize()
                check(torch.equal(y, y2), f"decoder block {k + 1}: two runs differ")
                ratio = max(ratio, ((y.double() - ref).abs() / bnd).max().item())
                err = max(err, (y.double() - ref).abs().max().item())
                del y, y2, ref, bnd
            check(ratio <= 1.0, f"decoder block {k + 1}: error {ratio} of the float32 rounding bound")

            def chain(skip, u, deconv, bn):
                return bn(F.relu(up(deconv, u if skip is None else torch.cat([skip, u], 1))))

            times = {name: device_ms(lambda fn=fn: [fn(*args) for args in blocks], n=DECONV_CALLS, reps=3)
                     for name, fn in (("ms", dk.decoder_block), ("plain_ms", dk.block_plain),
                                      ("library_ms", chain))}
            flops = 2.0 * len(nets) * DECONV_SEGMENTS * h * w * cin * cout * 25
            nbytes = 4.0 * len(nets) * (DECONV_SEGMENTS * (cin * h * w + cout * 4 * h * w) + cin * cout * 25)
            bound_ms, bound_by = bound(nbytes, flops)
            layout = dk.layout_for(blocks[0][0], blocks[0][1], cout)
            emit("deconv", block=k + 1, nets=len(nets), segments=DECONV_SEGMENTS, c_skip=c_skip, c_u=c_u, h=h, w=w,
                 cout=cout, layout=layout._asdict(), smem_bytes=dk.smem_bytes(layout), **times, bound_ms=bound_ms,
                 bound_by=bound_by, fp32_peak_share=bound_ms / times["ms"], beats_library=times["ms"] < times[
                     "library_ms"], rounding_bound_share=ratio, max_abs_err_f64=err, bitwise_repeat=True)
            for key in total:
                total[key] += bound_ms if key == "bound_ms" else times[key]
            stats["deconv"]["max_abs_err"] = max(stats["deconv"]["max_abs_err"], err)
            del blocks
            torch.cuda.empty_cache()
    emit("deconv", part="sum", nets=len(nets), segments=DECONV_SEGMENTS, **total,
         fp32_peak_share=total["bound_ms"] / total["ms"])
    stats["deconv"].update(total, bound_by="operations")
    del model
    torch.cuda.empty_cache()


def _beats_match(a: np.ndarray, b: np.ndarray, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} beats vs {len(b)}")
    if len(a):
        d = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        check(d <= 1.0 / FPS + 1e-9, f"{what}: beats differ by {d} s (> 1 frame)")


def _dbn_agrees(pulse: np.ndarray, what: str) -> None:
    """The DBN as track_signal runs it (its forward pass on the card), the
    native C++ and the numpy Viterbi on the same pulse: the same beats."""
    from zeronotesamba_torch.decode import decode
    from zeronotesamba_torch.decode.dbn import decode_beats

    card, native = decode(pulse, "dbn", device="cuda"), decode(pulse, "dbn")
    check(np.array_equal(native, decode_beats(pulse, use_native=False)),
          f"native and numpy DBN beats differ on the {what}'s pulse")
    check(np.array_equal(card, native), f"card and native DBN beats differ on the {what}'s pulse")


def phase_main_path(stats: dict) -> None:
    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.decode.ellis import beat_track_signal
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.metrics.beat import evaluate_beats
    from zeronotesamba_torch.ops.hpss import hpss_host
    from zeronotesamba_torch.utils import profiling

    sig, clicks = click_track(30.0, 120.0, seed=0)
    gpu = BeatTracker(seed=0, device="cuda")
    cpu = BeatTracker(seed=0, device="cpu")
    for k, v in gpu.state_dict().items():
        check(torch.equal(v, cpu.state_dict()[k]), f"seeded weights differ at {k}")

    before = profiling.totals()
    t0 = time.perf_counter()
    res_g = gpu.track_signal(sig, separation="hpss", decoder="dbn")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**_counted("vqt_launch.", before), **_counted("dbn_launch.", before)}
    backends = _counted("dbn.", before)
    # One log_xqt_fused call per track_signal: one cascade and one octave
    # launch; the DBN's forward pass runs on the card, one float64 launch.
    check(launches == {"cascade": 1, "octave": 1, "viterbi": 1}, f"main path launches {launches}")
    dbn_backend = "device" if backends == {"native": 0, "numpy": 0, "device": 1} else f"not device: {backends}"
    check(dbn_backend == "device", f"main path DBN backend {backends}, expected one device decode")
    stats["cascade"]["launches"] = launches["cascade"]
    stats["octave"]["launches"] = launches["octave"]
    # Eight encoder convs a stream, two streams, each one conv kernel launch; no weight gradient.
    conv_launches = _counted("conv_launch.", before)
    check(conv_launches == {"fprop": 16, "wgrad": 0}, f"main path conv launches {conv_launches}")
    stats["conv"]["launches"] = conv_launches["fprop"]

    t0 = time.perf_counter()
    gpu.track_signal(sig, separation="hpss", decoder="dbn")
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_c = cpu.track_signal(sig, separation="hpss", decoder="dbn")
    cpu_s = time.perf_counter() - t0

    n_frames = 1 + len(sig) // 256
    check(res_g.fused_pulse.shape == (n_frames,) and res_g.vqt.shape == (2, 96, n_frames), "main path shapes")
    check(bool(np.isfinite(res_g.vqt).all() and np.isfinite(res_g.fused_pulse).all()), "non-finite output")
    errs = {f: float(np.abs(getattr(res_g, f) - getattr(res_c, f)).max())
            for f in ("vqt", "anchor_pulse", "positive_pulse", "fused_pulse")}
    # Cells at float32 rounding level (log |X| <= -7) differ most; report both sides.
    above = res_c.vqt > -7.0
    errs["vqt_above_log_floor"] = float(np.abs(res_g.vqt - res_c.vqt)[above].max())
    h_g, h_c = hpss_host(sig, device="cuda"), hpss_host(sig, device="cpu")
    errs["hpss"] = max(float(np.abs(a - b).max()) for a, b in zip(h_g, h_c))
    for f in ("anchor_pulse", "positive_pulse", "fused_pulse"):
        check(errs[f] <= PULSE_ATOL, f"{f} card vs CPU max |err| {errs[f]} > {PULSE_ATOL}")
    _beats_match(res_g.beat_times, res_c.beat_times, "card vs CPU")
    check(len(res_g.beat_times) > 0, "no beats decoded")
    # The Ellis DP decoder on the same pulses, card vs CPU; and the old-school
    # route (Ellis DP on the raw click track) against the clicks.
    lib_g = gpu.track_signal(sig, separation="hpss", decoder="librosa").beat_times
    lib_c = cpu.track_signal(sig, separation="hpss", decoder="librosa").beat_times
    _beats_match(lib_g, lib_c, "librosa decoder card vs CPU")
    check(len(lib_g) > 0, "no beats from the librosa decoder")
    old_school_f1 = float(evaluate_beats(clicks, beat_track_signal(sig))[0])
    check(old_school_f1 >= OLD_SCHOOL_F1_MIN, f"Ellis DP on the click track F1 {old_school_f1} < {OLD_SCHOOL_F1_MIN}")
    _dbn_agrees(res_g.fused_pulse, "main path")
    # bfloat16 inference, untimed: its only check on the card.
    bf16 = BeatTracker(seed=0, device="cuda", compute_dtype=torch.bfloat16).track_signal(
        sig, separation="hpss", decoder=None).fused_pulse
    check(bf16.shape == (n_frames,), f"bf16 output shape {bf16.shape}")
    check(bool(np.isfinite(bf16).all()), "bf16 output not finite")

    # The CLI on the card, on a written wav, against the same tracker in-process.
    wav = os.path.join(OUT_DIR, "click_12s.wav")
    out_json = os.path.join(OUT_DIR, "infer.json")
    audio_io.write_wav(wav, click_track(12.0, 120.0, seed=1)[0], SR)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zeronotesamba_torch", "infer", wav, "--device", "cuda",
                           "--out", out_json], cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out_json) as fh:
        check(json.load(fh) == payload, "CLI --out differs from its stdout")
    ref = gpu.track_file(wav, separation="hpss", decoder="dbn")
    check(payload["n_frames"] == ref.fused_pulse.shape[0], "CLI n_frames")
    _beats_match(np.asarray(payload["beat_times"]), ref.beat_times, "CLI vs in-process")

    emit("main_path", clip_s=30.0, n_frames=n_frames, launches=launches, conv_launches=conv_launches,
         dbn_backend=dbn_backend,
         max_abs_err_card_vs_cpu=errs, n_beats=len(res_g.beat_times), librosa_n_beats=len(lib_g),
         old_school_f1=old_school_f1, card_first_s=first_s, card_warm_s=warm_s, cpu_s=cpu_s,
         cli=dict(seconds=cli_s, n_frames=payload["n_frames"], n_beats=len(payload["beat_times"])))
    return res_g.fused_pulse


VQT_ERR_KEYS = ("vqt", "near_empty_card_vs_f64", "near_empty_cpu_vs_f64", "near_empty_card_vs_cpu",
                "near_empty_card_vs_f64_mag", "near_empty_cpu_vs_f64_mag")


def _add_vqt_errs(errs: dict, card: np.ndarray, cpu: np.ndarray, exact: np.ndarray) -> None:
    """Fold one log-VQT's card, CPU and float64 evaluations into ``errs``:
    card vs CPU above the log floor, and in the near-empty cells each float32
    path against float64, in the log and in |X|."""
    low = exact <= LOG_FLOOR
    errs["vqt"] = max(errs["vqt"], float(np.abs(card - cpu)[~low].max()))
    if low.any():
        for key, a, b in (("card_vs_f64", card, exact), ("cpu_vs_f64", cpu, exact),
                          ("card_vs_cpu", card, cpu), ("card_vs_f64_mag", np.exp(card), np.exp(exact)),
                          ("cpu_vs_f64_mag", np.exp(cpu), np.exp(exact))):
            errs["near_empty_" + key] = max(errs["near_empty_" + key], float(np.abs(a - b)[low].max()))


def _vqt_errs_hold(errs: dict) -> bool:
    return (errs["vqt"] <= VQT_ATOL and errs["near_empty_card_vs_f64_mag"] <= NEAR_EMPTY_MAG_ATOL
            and errs["near_empty_cpu_vs_f64_mag"] <= NEAR_EMPTY_MAG_ATOL)


def _etl(stats: dict) -> tuple:
    """build_synthetic on the card: exactly one cascade and one octave launch
    per generate_xqt call (one per stream of a song), and two songs rebuilt
    on the CPU agree with the card's."""
    from zeronotesamba_torch.data.datasets import build_synthetic
    from zeronotesamba_torch.utils import profiling

    before = profiling.totals()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = build_synthetic(n_songs=ETL_SONGS, duration_s=ETL_SONG_S, seed=0, device="cuda")
    etl_s = time.perf_counter() - t0
    launches = _counted("vqt_launch.", before)
    n_calls = sum(r.vqt.shape[0] for r in ds)
    check(launches == {"cascade": n_calls, "octave": n_calls},
          f"ETL launches {launches}, expected {n_calls} of each (one per generate_xqt call)")
    for kname in launches:  # the log-VQT kernels
        stats[kname]["etl_launches_per_song"] = launches[kname] / len(ds)

    # Near-empty cells (log |X| <= -7 in a float64 evaluation) hold float32
    # rounding noise of the cascade, which depends on the order of its sums:
    # there each float32 path (card, CPU) is held against the float64 one in
    # |X|, within NEAR_EMPTY_MAG_ATOL; all other cells card vs CPU within
    # VQT_ATOL. The log errors are reported beside.
    from zeronotesamba_torch.data.synthetic import percussive_pair
    from zeronotesamba_torch.ops.vqt import log_xqt

    errs = dict.fromkeys(VQT_ERR_KEYS, 0.0)
    bpm_rng = np.random.default_rng(0)  # build_synthetic's draws, seed 0
    for i, ref in enumerate(build_synthetic(n_songs=2, duration_s=ETL_SONG_S, seed=0, device="cpu")):
        got = ds[i]
        check(ref.name == got.name and ref.vqt.shape == got.vqt.shape, f"ETL record {got.name} differs in shape")
        check(np.array_equal(ref.pulse, got.pulse) and np.array_equal(ref.beat_times, got.beat_times),
              f"ETL pulse of {got.name} differs")
        bpm = float(bpm_rng.uniform(70, 180))
        check(ref.name == f"synth_{i:03d}_bpm{bpm:.0f}", f"ETL song {ref.name} is not the regenerated one")
        streams = percussive_pair(ETL_SONG_S, bpm, seed=i)[:2]
        _add_vqt_errs(errs, got.vqt, ref.vqt, log_xqt(torch.tensor(np.stack(streams), dtype=torch.float64)).numpy())
    check(_vqt_errs_hold(errs), f"ETL log-VQT card vs CPU {errs}")
    emit("train", part="etl", n_songs=len(ds), song_s=ETL_SONG_S, seconds=etl_s, seconds_per_song=etl_s / len(ds),
         launches=launches, generate_xqt_calls=n_calls, max_abs_err_card_vs_cpu=errs)
    return ds


def _train_step_parity(ds) -> int:
    """One train_step at dropout off on the card and on the CPU from the
    same seeded pretrained FusedDownstream, on two staged songs; returns the
    card's weight-gradient launches."""
    from zeronotesamba_torch.train.state import downstream_learning_rate
    from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, train_step
    from zeronotesamba_torch.utils import profiling

    cfg = SupervisedConfig(status="pretrained", lr=1e-5, batch_size=2, bucket_frames=PARITY_FRAMES)
    lr = downstream_learning_rate(cfg.status, cfg.pre, cfg.lr)
    runs = {}
    for dev in ("cuda", "cpu"):
        staged = StagedDataset(ds.records[:2], cfg.bucket_frames, device=dev)
        (t, rows), = staged.plan(ds.names[:2], 2)
        b = staged.buckets[t]
        state = init_state(cfg, ds[0], 0, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        counted = profiling.totals()
        t0 = time.perf_counter()
        state, loss, _ = train_step(state, b.vqt, b.pulse, b.mask, None, cfg.status)
        runs[dev] = dict(loss=float(loss), seconds=time.perf_counter() - t0, before=before, frames=t,
                         conv_launches=_counted("conv_launch.", counted),
                         params={k: v.detach().cpu() for k, v in state.model.named_parameters()},
                         grads={k: v.grad.cpu() for k, v in state.model.named_parameters()})
    g, c = runs["cuda"], runs["cpu"]
    check(all(torch.equal(g["before"][k], c["before"][k]) for k in g["before"]), "seeded weights differ")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    param_err = max((g["params"][k] - c["params"][k]).abs().max().item() for k in c["params"])
    # Adam's first step moves a weight by at most lr, so the two sides differ
    # by at most 2 lr, plus the float32 rounding of each updated weight.
    eps = torch.finfo(torch.float32).eps
    param_excess = max(((g["params"][k] - c["params"][k]).abs() - 2 * lr - 2 * eps * c["params"][k].abs())
                       .max().item() for k in c["params"])
    moved = max((c["params"][k] - c["before"][k]).abs().max().item() for k in c["params"])
    # Adam's first step moves every weight by about lr whatever its gradient,
    # so the parameters cannot show a wrong backward: the gradients are held
    # too. A max-pool window whose two largest inputs lie within float32
    # rounding can route the gradient to the other one on the card, which
    # moves every gradient below that pool by about 4e-3 of its largest
    # (tests/test_torch_train.py): hence a limit of PARITY_GRAD_REL, not 1e-4.
    grad_rel = {k: ((g["grads"][k] - c["grads"][k]).abs().max() / c["grads"][k].abs().max()).item()
                for k in c["grads"]}
    worst = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= PARITY_LOSS_RTOL, f"train_step loss card {g['loss']} vs CPU {c['loss']}")
    check(0.0 < moved and param_excess <= 0.0, f"train_step params card vs CPU {param_err} > 2 lr ({2 * lr})")
    check(grad_rel[worst] <= PARITY_GRAD_REL,
          f"train_step gradient of {worst} card vs CPU {grad_rel[worst]} of its largest > {PARITY_GRAD_REL}")
    # Eight convs a stream, two streams: a forward and a weight gradient each on the card, none on the CPU.
    check(g["conv_launches"] == {"fprop": 16, "wgrad": 16} and c["conv_launches"] == {"fprop": 0, "wgrad": 0},
          f"train_step conv launches card {g['conv_launches']}, CPU {c['conv_launches']}")
    emit("train", part="step_parity", status=cfg.status, batch=2, frames=g["frames"], lr=lr,
         loss_card=g["loss"], loss_cpu=c["loss"], loss_rel_err=loss_rel, max_param_err=param_err,
         max_param_step=moved, max_grad_err_of_tensor_max=grad_rel[worst], worst_grad=worst,
         grad_rel_limit=PARITY_GRAD_REL, seconds_card=g["seconds"],
         seconds_cpu=c["seconds"], conv_launches=g["conv_launches"])
    return g["conv_launches"]["wgrad"]


def _experiment(ds) -> None:
    """Does it learn: vanilla, lr 2e-4, batch 8, 4 folds, DBN decoding,
    through run_beat_experiment, with the JAX demo suite's class balancing
    and budget for these synthetic songs (zeronotesamba_tpu/experiments/
    demo_suite.py:73-82): pos_weight 8, which removes the all-zeros plateau
    of plain BCE, and at most 100 epochs. Validation F1 is flat while a fold
    sits on the plateau, which lasted over 35 epochs in one fold, so
    patience is 60; a fold that peaks by epoch 40 still stops early. The
    seed is EXPERIMENT_SEED. cuDNN runs its deterministic algorithms here, so
    the run repeats on the same card and software; its default ones moved
    one fold's F1 from 0.917 to 0.833 between two runs."""
    from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, run_beat_experiment, summarize

    cfg = BeatExperimentConfig(status="vanilla", lr=2e-4, batch_size=8, n_folds=4, max_epochs=100, patience=60,
                               seed=EXPERIMENT_SEED, pos_weight=8.0, compute_dtype="float32", eval_method="dbn")
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        results = run_beat_experiment(ds, cfg, device="cuda", progress=False)
        secs = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    summary = summarize(results)
    folds = [dict(fold=r.fold, test_f1=float(r.test_metrics[0]), best_val_f1=r.best_val_f1, epochs=r.epochs_run,
                  seconds=r.seconds) for r in results]
    emit("train", part="experiment", status=cfg.status, lr=cfg.lr, batch=cfg.batch_size, pos_weight=cfg.pos_weight,
         max_epochs=cfg.max_epochs, patience=cfg.patience, seed=cfg.seed, cudnn_deterministic=True, folds=folds,
         mean_test_f1=summary["F1"], summary=summary, seconds=secs)
    check(summary["F1"] >= EXPERIMENT_F1_MIN, f"mean held-out F1 {summary['F1']} < {EXPERIMENT_F1_MIN}")


def _train_cli(ds) -> None:
    """build-data as a subprocess on the card, then beat in this process."""
    import shutil

    from zeronotesamba_torch.data.datasets import BeatDataset

    data_dir, out_json = os.path.join(OUT_DIR, "synth4"), os.path.join(OUT_DIR, "beat.json")
    shutil.rmtree(data_dir, ignore_errors=True)
    cmds = {
        "build_data": ["build-data", "synthetic", "--out", data_dir, "--n-songs", "4", "--device", "cuda"],
        "beat": ["beat", "--data", data_dir, "--folds", "2", "--max-epochs", "2", "--out", out_json,
                 "--device", "cuda"],
    }
    secs = {name: _cli(args, in_process=name == "beat")[0] for name, args in cmds.items()}
    cache = BeatDataset.load(data_dir)
    check(cache.names == ds.names[:4], "build-data songs differ from build_synthetic's")
    vqt_err = max(float(np.abs(a.vqt - b.vqt).max()) for a, b in zip(cache, ds))
    check(vqt_err <= VQT_ATOL and all(np.array_equal(a.pulse, b.pulse) for a, b in zip(cache, ds)),
          f"build-data cache vs in-process ETL: log-VQT {vqt_err}")
    with open(out_json) as fh:
        res = json.load(fh)
    names = ("F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain")
    check(all(math.isfinite(res[n]) and math.isfinite(res[n + "_std"]) for n in names), f"beat results {res}")
    emit("train", part="cli", seconds=secs, in_process=["beat"], n_songs=len(cache),
         max_abs_err_vqt_vs_in_process=vqt_err, results=res)


def phase_train(stats: dict):
    t0 = time.perf_counter()
    ds = _etl(stats)
    stats["wgrad"]["launches"] = _train_step_parity(ds)
    _experiment(ds)
    _train_cli(ds)
    emit("train", part="done", seconds=time.perf_counter() - t0)
    return ds


def _pretext_bank(stats: dict) -> tuple:
    """mine_stems (HPSS on the card) over PRETEXT_TRACKS synthetic 12 s mixes
    and a pure tone (the gate rejects it), then the stem bank and the CLMR
    bank on the card, with their kernel launches counted; two stem-bank
    items rebuilt on the CPU from the same stem wavs."""
    import random
    import shutil

    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.fma import gen_clmr_bank, mine_stems
    from zeronotesamba_torch.data.separation import load_stem_dir
    from zeronotesamba_torch.data.stems import fold_stems, mine_pair
    from zeronotesamba_torch.data.synthetic import percussive_pair
    from zeronotesamba_torch.experiments.pretext_driver import build_bank_from_stem_root
    from zeronotesamba_torch.ops.vqt import generate_xqt, log_xqt
    from zeronotesamba_torch.utils import profiling

    corpus, stem_root = os.path.join(OUT_DIR, "pretext_corpus"), os.path.join(OUT_DIR, "pretext_stems")
    for d in (corpus, stem_root):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(corpus)
    names = []
    for i in range(PRETEXT_TRACKS):
        anchor, positive, _ = percussive_pair(PRETEXT_SONG_S, 80.0 + 8 * i, seed=100 + i, click_freq=900.0 + 100 * i)
        names.append(f"mix{i:02d}")
        audio_io.write_wav(os.path.join(corpus, names[-1] + ".wav"), anchor + positive, SR)
    t = np.arange(int(PRETEXT_SONG_S * SR)) / SR
    audio_io.write_wav(os.path.join(corpus, "tone.wav"), 0.3 * np.sin(2 * np.pi * 440.0 * t), SR)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = mine_stems(corpus, stem_root, separation="hpss", lower_p=PRETEXT_LOWER_P, device="cuda")
    mine_s = time.perf_counter() - t0
    check(written == names, f"mine_stems wrote {written}, expected every mix and not the tone")

    counts = {}
    for name, build in (("stem", lambda: build_bank_from_stem_root(stem_root, 10**9, seed=0, device="cuda")),
                        ("clmr", lambda: gen_clmr_bank(corpus, 10**9, clip_frames=PRETEXT_CROP, seed=0,
                                                       device="cuda"))):
        before = profiling.totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = build()
        torch.cuda.synchronize()
        counts[name] = dict(items=len(bank), shape=list(bank.shape), seconds=time.perf_counter() - t0,
                            launches=_counted("vqt_launch.", before))
        counts[name]["seconds_per_item"] = counts[name]["seconds"] / len(bank)
        per_item = 2 if name == "stem" else 1  # generate_xqt calls an item
        check(counts[name]["launches"] == {"cascade": per_item * len(bank), "octave": per_item * len(bank)},
              f"{name} bank launches {counts[name]['launches']}, expected {per_item} of each a bank item")
        if name == "stem":
            stem_bank = bank
    check(stem_bank.shape == (PRETEXT_TRACKS, 2, 96, PRETEXT_FRAMES), f"stem bank shape {stem_bank.shape}")
    check(counts["clmr"]["shape"] == [PRETEXT_TRACKS + 1, 2, 96, PRETEXT_CROP], f"CLMR bank {counts['clmr']}")
    check(bool(np.isfinite(stem_bank).all()), "stem bank not finite")
    for kname in counts["stem"]["launches"]:  # the log-VQT kernels
        stats[kname]["pretext_launches_per_bank_item"] = counts["stem"]["launches"][kname] / len(stem_bank)
        stats[kname]["pretext_launches_per_clmr_item"] = counts["clmr"]["launches"][kname] / counts["clmr"]["items"]

    # The first two items again on the CPU: build_bank_from_stem_root's
    # walk (shuffled track ids, one gated crop pair a track) from the same
    # seed, each crop's log-VQT in float32 on the CPU and in float64.
    errs = dict.fromkeys(VQT_ERR_KEYS, 0.0)
    rng = random.Random(0)
    tids = sorted(os.listdir(stem_root))
    rng.shuffle(tids)
    tids = [t for t in tids if os.path.isdir(os.path.join(stem_root, t))]
    for item, tid in zip(stem_bank[:2], tids):
        anchor, positive = fold_stems(load_stem_dir(os.path.join(stem_root, tid)))
        pair = np.stack(mine_pair(anchor, positive, rng=rng))
        cpu = np.stack([generate_xqt(x, SR, "vqt", device="cpu") for x in pair])
        _add_vqt_errs(errs, item, cpu, log_xqt(torch.tensor(pair, dtype=torch.float64)).numpy())
    check(_vqt_errs_hold(errs), f"stem bank log-VQT card vs CPU {errs}")
    emit("pretext", part="bank", tracks=PRETEXT_TRACKS, song_s=PRETEXT_SONG_S, mined=len(written),
         mine_stems_seconds=mine_s, lower_p=PRETEXT_LOWER_P, stem_bank=counts["stem"], clmr_bank=counts["clmr"],
         max_abs_err_card_vs_cpu=errs)
    return stem_bank


def _pretext_step_parity(bank: np.ndarray) -> None:
    """One staged zerons step at k = 2, batch 4 x 313, dropout 0, on the card
    and on the CPU from the same seeded TwinPretext; on the card, the k = 2
    loss against the mean of the two tracks' own NT-Xent.

    Near the NT-Xent plateau a max-pool or ReLU decision that flips between
    the two float32 runs (inputs within rounding of a tie) moves a gradient
    by up to about 1e-2 of its tensor's largest entry, so the gradients are
    held on a third run: the card's step replaying the CPU's decisions
    (utils/parity.py). The card's own step gives the loss, the parameters,
    the gradients' gap without sharing and the count of flipped decisions."""
    from zeronotesamba_torch.train.pretext import (
        PretextConfig, init_pretext_state, make_eval_step, make_staged_train_step, sample_shifts, staged_crops,
    )
    from zeronotesamba_torch.utils.parity import PiecewiseDecisions

    cfg = PretextConfig(batch_size=4, crop_frames=PRETEXT_CROP, dropout_rate=0.0, lr=1e-5)
    rng = np.random.default_rng(3)
    tracks = np.array([0, 1])
    starts = np.stack([sample_shifts(bank.shape[-1], cfg.batch_size, cfg.crop_frames, rng) for _ in tracks])
    runs, decisions = {}, {"cpu": PiecewiseDecisions(), "card": PiecewiseDecisions()}
    for run, dev in (("cpu", "cpu"), ("card", "cuda"), ("shared", "cuda")):
        bank_dev = torch.as_tensor(bank[:2], device=dev)
        state = init_pretext_state(cfg, 0, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        singles = [[v.item() for v in make_eval_step(cfg)(state, staged_crops(
            bank_dev, torch.tensor([t], device=dev), torch.as_tensor(st[None], device=dev), cfg.crop_frames)[0])]
            for t, st in zip(tracks, starts)] if run == "card" else None
        t0 = time.perf_counter()
        with decisions["cpu"].replay() if run == "shared" else decisions[run].record():
            state, loss, pc, nc = make_staged_train_step(cfg)(state, bank_dev, tracks, starts, None)
        runs[run] = dict(loss=loss.item(), cosines=[pc.item(), nc.item()], singles=singles,
                         seconds=time.perf_counter() - t0, before=before,
                         params={k: v.detach().cpu() for k, v in state.model.named_parameters()},
                         grads={k: v.grad.cpu() for k, v in state.model.named_parameters()})
    g, c = runs["card"], runs["cpu"]
    check(all(torch.equal(g["before"][k], c["before"][k]) for k in g["before"]), "seeded weights differ")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    eps = torch.finfo(torch.float32).eps
    param_excess = max(((g["params"][k] - c["params"][k]).abs() - 2 * cfg.lr - 2 * eps * c["params"][k].abs())
                       .max().item() for k in c["params"])
    moved = max((c["params"][k] - c["before"][k]).abs().max().item() for k in c["params"])

    def grad_rel(run: str) -> dict:
        return {k: ((runs[run]["grads"][k] - c["grads"][k]).abs().max() / c["grads"][k].abs().max()).item()
                for k in c["grads"]}

    shared, own = grad_rel("shared"), grad_rel("card")
    worst, worst_own = max(shared, key=shared.get), max(own, key=own.get)
    mean_singles = np.mean(g["singles"], axis=0)
    k2_rel = float(np.max(np.abs(np.array([g["loss"]] + g["cosines"]) - mean_singles) / np.abs(mean_singles)))
    check(loss_rel <= PARITY_LOSS_RTOL, f"pretext step loss card {g['loss']} vs CPU {c['loss']}")
    check(0.0 < moved and param_excess <= 0.0, f"pretext step params card vs CPU exceed 2 lr by {param_excess}")
    check(shared[worst] <= PARITY_GRAD_REL,
          f"pretext step gradient of {worst} card vs CPU {shared[worst]} of its largest > {PARITY_GRAD_REL}")
    check(k2_rel <= PRETEXT_K2_RTOL, f"k = 2 step vs the mean of its tracks' NT-Xent: {k2_rel} relative")
    emit("pretext", part="step_parity", task=cfg.task, tracks=2, batch=cfg.batch_size, crop=cfg.crop_frames,
         lr=cfg.lr, loss_card=g["loss"], loss_cpu=c["loss"], loss_rel_err=loss_rel, ln_batch=math.log(cfg.batch_size),
         max_param_excess_over_2lr=param_excess, max_param_step=moved, max_grad_err_of_tensor_max=shared[worst],
         worst_grad=worst, grad_rel_limit=PARITY_GRAD_REL, unshared_max_grad_err_of_tensor_max=own[worst_own],
         unshared_worst_grad=worst_own, decisions_flipped=decisions["cpu"].differing(decisions["card"]),
         k2_vs_mean_of_tracks_rel=k2_rel, seconds_card=g["seconds"], seconds_cpu=c["seconds"])


def _pretext_run(bank: np.ndarray) -> None:
    """train_pretext on the mined bank (10 train, 2 val items), zerons,
    batch 16 x 313, lr 3e-6, 3 epochs, proxy-F1 selection on 4 synthetic
    songs every epoch, with a resume directory; then one more epoch from it,
    and the val-loss checkpoint into BeatTracker on the card."""
    import shutil

    from zeronotesamba_torch.data.datasets import build_synthetic
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.experiments.pretext_driver import PretextRunConfig, train_pretext
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.train.checkpoint import load_params

    run_dir = os.path.join(OUT_DIR, "pretext_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt = os.path.join(run_dir, "shift_pret_cnn_16.pth")
    cfg = PretextRunConfig(task="zerons", num_epochs=3, batch_size=16, crop_frames=PRETEXT_CROP, lr=3e-6, seed=0,
                           checkpoint_path=ckpt, selection="proxy_f1",
                           proxy_dataset=build_synthetic(4, 12.0, seed=7, device="cuda"), proxy_every=1,
                           resume_dir=os.path.join(run_dir, "resume"))
    t0 = time.perf_counter()
    _, hist = train_pretext(bank[:10], bank[10:12], cfg, device="cuda")
    run_s = time.perf_counter() - t0
    finite = all(math.isfinite(v) for key in ("train_loss", "val_loss", "train_pos", "train_neg", "val_pos",
                                              "val_neg", "proxy_f1") for v in hist[key])
    check(len(hist["val_loss"]) == 3 and len(hist["proxy_f1"]) == 3 and finite, f"pretext history {hist}")
    valsel = os.path.join(run_dir, "shift_pret_cnn_16_valsel.pth")
    check(os.path.exists(ckpt) and os.path.exists(valsel), "pretext checkpoints not written")
    res = BeatTracker(load_params(valsel), device="cuda").track_signal(click_track(8.0, 120.0, seed=2)[0])
    check(bool(np.isfinite(res.fused_pulse).all()) and res.fused_pulse.shape == (501,), "valsel BeatTracker output")

    t0 = time.perf_counter()
    _, more = train_pretext(bank[:10], bank[10:12], dataclasses.replace(cfg, num_epochs=4), device="cuda")
    resume_s = time.perf_counter() - t0
    check(len(more["val_loss"]) == 1, f"resumed run ran {len(more['val_loss'])} epochs, expected 1")
    emit("pretext", part="run", train_items=10, val_items=2, batch=cfg.batch_size, crop=PRETEXT_CROP, lr=cfg.lr,
         epochs=cfg.num_epochs, seconds=run_s, val_loss=hist["val_loss"], ln_batch=math.log(cfg.batch_size),
         train_loss=hist["train_loss"],
         val_pos=hist["val_pos"], val_neg=hist["val_neg"], proxy_f1=hist["proxy_f1"], restarts=hist["restarts"],
         resumed_epochs=len(more["val_loss"]), resumed_val_loss=more["val_loss"], resumed_proxy_f1=more["proxy_f1"],
         resume_seconds=resume_s, valsel_beats=len(res.beat_times))
    shutil.rmtree(run_dir)  # the twin's checkpoints and resume states: about a GB, checked above


def _pretext_cli(bank: np.ndarray) -> None:
    """pretext --bank as a subprocess on the card, then infer --params with
    the checkpoint it wrote, in this process."""
    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.synthetic import click_track

    npz, ckpt = os.path.join(OUT_DIR, "pretext_bank.npz"), os.path.join(OUT_DIR, "pretext_cli.pth")
    wav = os.path.join(OUT_DIR, "pretext_click.wav")
    np.savez(npz, train_bank=bank[:4], val_bank=bank[10:12])
    audio_io.write_wav(wav, click_track(8.0, 120.0, seed=3)[0], SR)
    cmds = {
        "pretext": ["pretext", "--bank", npz, "--epochs", "1", "--batch-size", "16", "--checkpoint", ckpt,
                    "--device", "cuda"],
        "infer": ["infer", wav, "--params", ckpt, "--device", "cuda"],
    }
    secs, out = {}, {}
    for name, args in cmds.items():
        secs[name], stdout = _cli(args, in_process=name == "infer")
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    check(out["pretext"]["epochs"] == 1 and math.isfinite(out["pretext"]["best_val_loss"]), f"pretext CLI {out}")
    check(out["infer"]["n_frames"] == 501, f"infer --params output {out['infer']}")
    emit("pretext", part="cli", seconds=secs, in_process=["infer"], pretext=out["pretext"],
         infer_n_beats=len(out["infer"]["beat_times"]))
    os.remove(ckpt)  # 107 MB of twin weights, checked above


def phase_pretext(stats: dict) -> np.ndarray:
    """The pretext phase; returns the stem bank."""
    t0 = time.perf_counter()
    bank = _pretext_bank(stats)
    _pretext_step_parity(bank)
    _pretext_run(bank)
    _pretext_cli(bank)
    emit("pretext", part="done", seconds=time.perf_counter() - t0)
    return bank


def _decode_batch(pulse: np.ndarray):
    """The decode phase's ragged batch: every golden activation (187 to
    1,250 frames), the main path's fused pulse (1,876), that pulse tiled to
    3,750 frames, and a song of no frames, zero-padded to 3,750."""
    gold = np.load(os.path.join(ROOT, "tests", "fixtures", "dbn_golden.npz"))
    songs = {k[len("act_"):]: gold[k].astype(np.float64) for k in sorted(gold.files) if k.startswith("act_")}
    songs["main_path_pulse"] = np.asarray(pulse, np.float64)
    songs["main_path_pulse_x2"] = np.tile(songs["main_path_pulse"], 2)[:3750]
    songs["empty"] = np.zeros(0)
    t_pad = max(len(a) for a in songs.values())
    acts = np.stack([np.pad(a, (0, t_pad - len(a))) for a in songs.values()])
    return list(songs), acts, [len(a) for a in songs.values()], gold


def _decode_corpus(pulse: np.ndarray, gold):
    """A GTZAN-sized evaluation set as one batch: DECODE_CORPUS_SONGS songs
    of 29 to 30 s (1,813 to 1,876 frames, seeded), each a seeded crop of a
    golden activation or the main path's pulse, in turn, tiled to length;
    zero-padded to 1,876."""
    sources = {k[len("act_"):]: gold[k].astype(np.float64) for k in sorted(gold.files) if k.startswith("act_")}
    sources["main_path_pulse"] = np.asarray(pulse, np.float64)
    keys, rng = list(sources), np.random.default_rng(DECODE_CORPUS_SEED)
    names, songs = [], []
    for i in range(DECODE_CORPUS_SONGS):
        src = sources[keys[i % len(keys)]]
        n = DECODE_CORPUS_FRAMES - int(rng.integers(0, 64))
        off = int(rng.integers(0, len(src)))
        names.append(keys[i % len(keys)])
        songs.append(np.tile(src, -(-(off + n) // len(src)))[off:off + n])
    acts = np.stack([np.pad(a, (0, DECODE_CORPUS_FRAMES - len(a))) for a in songs])
    return names, acts, [len(a) for a in songs]


def _viterbi_timed(stats: dict, shape: str, acts: np.ndarray, lengths: list, dtype=torch.float32) -> dict:
    """The Viterbi kernel's instance for scores of ``dtype`` on one padded
    batch: against its plain version on the card (all three outputs equal),
    its device time at each block size it takes (the default's is
    ``kernel_ms``), the plain version's time (once) and the card's bound
    (float64 at half the float32 peak). Launches here are not counted
    against the path."""
    from zeronotesamba_torch.decode import dbn_device
    from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig
    from zeronotesamba_torch.ops.cuda import dbn_kernel

    cfg = DBNBeatDecoderConfig()
    masked = acts.copy()
    for b, nf in enumerate(lengths):
        masked[b, nf:] = 0.0
    score = 4 if dtype == torch.float32 else 8
    la, lna = (torch.tensor(x.astype(np.float32 if score == 4 else np.float64), device="cuda")
               for x in dbn_device._observations(masked, cfg))
    space = dbn_device._space(cfg, torch.device("cuda"), dtype)
    got = dbn_kernel.viterbi_forward(la, lna, space)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = dbn_kernel.viterbi_forward_plain(la, lna, space)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for what, g, r in zip(("v_final", "fc", "best"), got, ref):
        check(g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r),
              f"viterbi kernel {what} differs from its plain version at {shape}")
    err = float((got[0] - ref[0]).abs().max())
    del got, ref
    # Each song-frame: n_int^2 candidate adds and as many compares, n_states
    # observation adds and as many argmax compares.
    batch, t_pad = acts.shape
    n_int, n_states = space.n_int, space.n_states
    threads_ms = {t: device_ms(lambda t=t: dbn_kernel._viterbi_forward_cuda(la, lna, space, threads=t), n=5, reps=3)
                  for t in (VITERBI_THREADS if score == 4 else VITERBI_THREADS_F64)}
    ms = device_ms(lambda: dbn_kernel.viterbi_forward(la, lna, space), n=5, reps=3)
    nbytes = score * 2.0 * batch * t_pad + score * n_int * n_int + 8.0 * n_int + n_states \
        + 2.0 * batch * t_pad * n_int + 4.0 * batch * t_pad + score * batch * n_states
    b_ms, b_by = bound(nbytes, score / 4 * 2.0 * (n_int * n_int + n_states) * batch * t_pad)
    row = dict(shape=shape, batch=batch, t_pad=t_pad, frames_per_round=space.frames_per_round, kernel_ms=ms,
               us_per_frame=ms * 1e3 / t_pad, threads_ms=threads_ms, plain_ms=plain_s * 1e3, bound_ms=b_ms,
               bound_by=b_by, max_abs_err_v_final=err)
    stats["viterbi"].setdefault("shapes", {})[shape] = {k: row[k] for k in (
        "kernel_ms", "us_per_frame", "plain_ms", "bound_ms", "bound_by", "frames_per_round", "threads_ms")}
    if shape == "20x3750":  # the kernel's row in the summary, as in every PR before
        stats["viterbi"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            frames_per_round=space.frames_per_round, us_per_frame=ms * 1e3 / t_pad,
            event_ms=time_ms(lambda: dbn_kernel.viterbi_forward(la, lna, space), n=5, warmup=1))
    return row


def _device_decode(fn, n_songs: int) -> tuple:
    """One device decode with the Viterbi launches counted: (result, its
    host seconds a song, split into forward and backtrack)."""
    from zeronotesamba_torch.utils import profiling

    before = profiling.totals()
    stage = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(stage)
    secs = time.perf_counter() - t0
    launches = _counted("dbn_launch.", before)
    check(launches == {"viterbi": 1}, f"decode launches {launches}, expected one viterbi launch a batch")
    return out, dict(device_decode=secs / n_songs, forward=stage["forward_s"] / n_songs,
                     backtrack=stage["backtrack_s"] / n_songs)


def _beats_vs_float64(name: str, beats: np.ndarray, act: np.ndarray) -> tuple:
    """(device beats equal the float64 native DBN's, beats in one and not the
    other, the native decode's seconds); gated on DECODE_GATED."""
    from zeronotesamba_torch.decode.dbn import decode_beats

    t0 = time.perf_counter()
    native = decode_beats(act)
    secs = time.perf_counter() - t0
    same = len(beats) == len(native) and np.array_equal(beats, native)
    diff = int(np.sum(~np.isin(np.round(beats * FPS), np.round(native * FPS)))
               + np.sum(~np.isin(np.round(native * FPS), np.round(beats * FPS))))
    if name.startswith(DECODE_GATED):
        check(same, f"{name}: device beats differ from the float64 DBN's ({diff} not shared)")
    return same, diff, secs, native


def phase_decode(stats: dict, pulse: np.ndarray) -> None:
    """The batched DBN Viterbi on its path at three shapes, each decoded once
    through the device entry points with its one launch counted, the kernel
    held against its plain version on the card exactly, and the gated songs'
    beats against the float64 DBN: 20 ragged songs padded to 3,750 frames
    (decode_beats_batch_device; with native against numpy and the golden
    beats, and the online DBN), the main path's pulse alone
    (decode_beats_device), and a 1,000-song evaluation set of 30 s songs
    (decode_beats_batch_device)."""
    from zeronotesamba_torch.decode import dbn_device
    from zeronotesamba_torch.decode.dbn import DBNBeatDecoderConfig, decode_beats
    from zeronotesamba_torch.decode.dbn_online import decode_beats_online
    from zeronotesamba_torch.metrics.beat import f_measure

    cfg = DBNBeatDecoderConfig()
    launches = 0

    # 20 x 3,750: the golden rows, the main path's pulse, it tiled, an empty song.
    names, acts, lengths, gold = _decode_batch(pulse)
    n_songs = sum(1 for n in lengths if n > 0)
    device_beats, host = _device_decode(
        lambda st: dbn_device.decode_beats_batch_device(acts, lengths, cfg, device="cuda", stage_s=st), n_songs)
    launches += 1
    row = _viterbi_timed(stats, "20x3750", acts, lengths)
    per_song, t_native, t_numpy = {}, 0.0, 0.0
    for name, act, nf, beats in zip(names, acts, lengths, device_beats):
        act = act[:nf]
        same, diff, secs, native = _beats_vs_float64(name, beats, act)
        t1 = time.perf_counter()
        plain = decode_beats(act, cfg, use_native=False)
        t_native, t_numpy = t_native + secs, t_numpy + time.perf_counter() - t1
        check(np.array_equal(native, plain), f"{name}: native and numpy DBN beats differ")
        per_song[name] = dict(frames=len(act), beats=len(native), device_equal=same, beats_not_shared=diff)
        if f"act_{name}" in gold.files:
            for correct, tag in ((True, "c"), (False, "u")):
                c = dataclasses.replace(cfg, correct=correct)
                nat = decode_beats(act, c)
                check(np.array_equal(nat, decode_beats(act, c, use_native=False)), f"{name}: native != numpy")
                check(np.allclose(nat, gold[f"beats_{tag}_{name}"], atol=1e-9), f"{name}: golden beats differ")
    online = {}
    for name in names:
        if name.startswith("clean_"):
            act = gold[f"act_{name}"].astype(np.float64)
            on, off = decode_beats_online(act), decode_beats(act, cfg)
            online[name] = float(f_measure(off[off > 3], on[on > 3]))  # after the 3 s burn-in
            check(online[name] >= ONLINE_F1_MIN, f"online DBN F1 on {name} {online[name]} < {ONLINE_F1_MIN}")
    emit("decode", **row, lengths=lengths, launches={"viterbi": 1}, serial_frames=row["t_pad"],
         host_s_per_song=dict(host, numpy=t_numpy / n_songs, native=t_native / n_songs), songs=per_song,
         online_f1=online)

    # 1 x 1,876: the main path's pulse, one song through decode_beats_device.
    act = np.asarray(pulse, np.float64)
    beats, host = _device_decode(lambda st: dbn_device.decode_beats_device(act, cfg, device="cuda", stage_s=st), 1)
    launches += 1
    row = _viterbi_timed(stats, f"1x{act.size}", act[None], [act.size])
    same, diff, secs, native = _beats_vs_float64("main_path_pulse", beats, act)
    emit("decode", **row, launches={"viterbi": 1}, serial_frames=row["t_pad"],
         host_s_per_song=dict(host, native=secs), songs={"main_path_pulse": dict(
             frames=act.size, beats=len(native), device_equal=same, beats_not_shared=diff)})
    # The same song in float64, as track_signal decodes it on the card.
    row = _viterbi_timed(stats, f"1x{act.size}_f64", act[None], [act.size], torch.float64)
    t0 = time.perf_counter()
    beats = decode_beats(act, cfg, device="cuda")
    check(np.array_equal(beats, native), "main_path_pulse: float64 device beats differ from the native DBN's")
    emit("decode", **row, serial_frames=row["t_pad"], host_s_per_song=dict(decode=time.perf_counter() - t0))

    # 1,000 x 1,876: an evaluation set of ragged 30 s songs.
    names, acts, lengths = _decode_corpus(pulse, gold)
    device_beats, host = _device_decode(
        lambda st: dbn_device.decode_beats_batch_device(acts, lengths, cfg, device="cuda", stage_s=st), len(names))
    launches += 1
    row = _viterbi_timed(stats, f"{len(names)}x{acts.shape[1]}", acts, lengths)
    gated, equal, not_shared, t_native = 0, 0, 0, 0.0
    for name, a, nf, beats in zip(names, acts, lengths, device_beats):
        if name.startswith(DECODE_GATED):  # checked in _beats_vs_float64
            same, diff, secs, _ = _beats_vs_float64(name, beats, a[:nf])
            gated, equal, not_shared, t_native = gated + 1, equal + same, not_shared + diff, t_native + secs
    emit("decode", **row, lengths=dict(min=min(lengths), max=max(lengths), sum=sum(lengths)),
         launches={"viterbi": 1}, serial_frames=row["t_pad"],
         host_s_per_song=dict(host, native=t_native / gated),
         gated_songs=dict(songs=gated, device_equal=equal, beats_not_shared=not_shared))
    stats["viterbi"]["launches"] = launches


def _bock_parity(ds) -> None:
    """One status='bock' train_step at dropout off on the card and on the
    CPU from the same seeded BockTCN, on two staged songs, at the train
    step's tolerances."""
    from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, train_step

    cfg = SupervisedConfig(status="bock", lr=1e-3, batch_size=2, bucket_frames=PARITY_FRAMES)
    runs = {}
    for dev in ("cuda", "cpu"):
        staged = StagedDataset(ds.records[:2], cfg.bucket_frames, device=dev)
        (t, rows), = staged.plan(ds.names[:2], 2)
        b = staged.buckets[t]
        state = init_state(cfg, ds[0], 0, device=dev)
        state, loss, _ = train_step(state, b.vqt, b.pulse, b.mask, None, cfg.status)
        runs[dev] = dict(loss=float(loss), params={k: v.detach().cpu() for k, v in state.model.named_parameters()},
                         grads={k: v.grad.cpu() for k, v in state.model.named_parameters()})
    g, c = runs["cuda"], runs["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    eps = torch.finfo(torch.float32).eps
    param_excess = max(((g["params"][k] - c["params"][k]).abs() - 2 * cfg.lr - 2 * eps * c["params"][k].abs())
                       .max().item() for k in c["params"])
    grad_rel = {k: ((g["grads"][k] - c["grads"][k]).abs().max() / c["grads"][k].abs().max()).item()
                for k in c["grads"]}
    worst = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= PARITY_LOSS_RTOL, f"bock train_step loss card {g['loss']} vs CPU {c['loss']}")
    check(param_excess <= 0.0, f"bock train_step params card vs CPU exceed 2 lr by {param_excess}")
    check(grad_rel[worst] <= PARITY_GRAD_REL, f"bock gradient of {worst} card vs CPU {grad_rel[worst]} of its largest")
    emit("evaluate", part="bock_step_parity", batch=2, frames=PARITY_FRAMES, lr=cfg.lr, loss_card=g["loss"],
         loss_cpu=c["loss"], loss_rel_err=loss_rel, max_grad_err_of_tensor_max=grad_rel[worst], worst_grad=worst,
         max_param_excess_over_2lr=param_excess)


def _bock_steps() -> None:
    """BockTCN train steps on the card at batch 8 x 768 in float32: the
    median time of 6 after 2 warm-up over distinct batches; then 20 steps on
    one batch, after which its loss must have fallen."""
    from zeronotesamba_torch.train.supervised import SupervisedConfig, dropout_generator, init_state, train_step

    batch, frames, steps, warmup, distinct = 8, 768, 6, 2, 3
    gen = torch.Generator(device="cuda").manual_seed(4)
    data = [torch.randn(batch, 1, 96, frames, device="cuda", generator=gen) * 4.0 - 6.0 for _ in range(distinct)]
    pulse = (torch.rand(batch, frames, device="cuda", generator=gen) < 0.05).float()
    mask = torch.ones(batch, frames, device="cuda")
    cfg = SupervisedConfig(status="bock", lr=1e-3, bucket_frames=frames)
    state = init_state(cfg, None, 0, device="cuda")
    times = []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss, _ = train_step(state, data[i % distinct], pulse, mask, dropout_generator(0, i, "cuda"), "bock")
        check(math.isfinite(float(loss)), "bock step loss not finite")  # the read syncs
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    state = init_state(cfg, None, 1, device="cuda")
    losses = [float(train_step(state, data[0], pulse, mask, dropout_generator(1, i, "cuda"), "bock")[1])
              for i in range(20)]
    check(losses[-1] < losses[0], f"20 bock steps on one batch did not lower its loss: {losses[0]} -> {losses[-1]}")
    emit("evaluate", part="bock_throughput", dtype="float32", batch=batch, frames=frames, steps=steps,
         ms_per_step=statistics.median(times), step_ms=times, fit_losses=[losses[0], losses[-1]])


def _cli(args: list, timeout: int = 300, in_process: bool = False) -> tuple:
    """One CLI call on the card: (seconds, stdout). A subprocess, its start
    included, or with ``in_process`` zeronotesamba_torch.cli.main(args) in
    this process with its standard output captured; each phase keeps at
    least one subprocess, so process start stays measured."""
    t0 = time.perf_counter()
    if in_process:
        import contextlib
        import io

        from zeronotesamba_torch.cli import main as cli_main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, buf.getvalue()
    proc = subprocess.run([sys.executable, "-m", "zeronotesamba_torch", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI {args[0]} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return secs, proc.stdout


def _evaluate_cli(ds) -> None:
    """The evaluation entry points on the card, on the train phase's songs,
    the pretext phase's bank and three click-track wavs: track-dir --decoder
    dbn as a subprocess, the others through cli.main in this process (each
    subprocess spends most of its time starting)."""
    import shutil

    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.datasets import BeatDataset, SongRecord
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker

    root = os.path.join(OUT_DIR, "evaluate")
    shutil.rmtree(root, ignore_errors=True)
    train_dir, test_dir, all_dir, wav_dir = (os.path.join(root, d) for d in ("train8", "test8", "all16", "wavs"))
    BeatDataset(ds.records[:8]).save(train_dir)
    BeatDataset(ds.records[8:]).save(test_dir)
    ds.save(all_dir)
    os.makedirs(wav_dir)
    records = []
    for i, bpm in enumerate((96.0, 120.0, 150.0)):
        sig, beats = click_track(12.0, bpm, seed=40 + i)
        name = f"click_{i}.wav"
        audio_io.write_wav(os.path.join(wav_dir, name), sig, SR)
        records.append(SongRecord(name, np.zeros((1, 96, 8), np.float32), np.zeros(8), np.zeros(8), beats,
                                  np.zeros(0)))
    BeatDataset(records).save(os.path.join(root, "clicks"))
    out = {n: os.path.join(root, n + ".json") for n in ("beat", "cross", "few", "dbn", "librosa")}
    meas = os.path.join(root, "measures")
    bank = os.path.join(OUT_DIR, "pretext_bank.npz")  # the pretext phase's bank
    secs, results = {}, {}
    runs = {
        "beat_bock": ["beat", "--data", os.path.join(OUT_DIR, "synth4"), "--status", "bock", "--folds", "2",
                      "--max-epochs", "2", "--lr", "1e-3", "--out", out["beat"]],
        "cross": ["cross", "--train-data", train_dir, "--test-data", test_dir, "--folds", "2", "--max-epochs", "3",
                  "--lr", "2e-4", "--out", out["cross"]],
        "few_shot": ["few-shot", "--data", all_dir, "--sizes", "1,2", "--repeats", "1", "--max-epochs", "3",
                     "--lr", "2e-4", "--out", out["few"]],
        "measures_vanilla": ["measures", "--data", all_dir, "--status", "van", "--model", "vanilla", "--out", meas],
        "measures_bock": ["measures", "--data", all_dir, "--status", "bock", "--model", "bock", "--out", meas],
        "measures_anchor": ["measures", "--data", all_dir, "--status", "ros", "--stream", "anchor", "--out", meas],
        "measures_std": ["measures", "--status", "std", "--bank", bank, "--out", meas],
        "old_school": ["old-school", "--data", os.path.join(root, "clicks"), "--audio-root", wav_dir],
        "track_dir_dbn": ["track-dir", wav_dir, "--decoder", "dbn", "--out", out["dbn"]],
        "track_dir_librosa": ["track-dir", wav_dir, "--decoder", "librosa", "--out", out["librosa"]],
        "resave": ["resave", wav_dir, "--out", os.path.join(root, "wavs44k"), "--rate", "44100"],
    }
    for name, args in runs.items():
        if args[0] not in ("old-school", "resave"):  # host-only subcommands take no device
            args = args + ["--device", "cuda"]
        secs[name], stdout = _cli(args, in_process=name != "track_dir_dbn")
        if name.startswith("measures_") and name != "measures_std":
            results[name] = {k: v["q0.5"] for k, v in json.loads(stdout).items()}
        elif name == "measures_std":
            results[name] = json.loads(stdout)
        elif name == "old_school":
            results[name] = {ln.split()[1]: float(ln.split()[3]) for ln in stdout.strip().splitlines()}
    for name in ("beat", "cross"):
        with open(out[name]) as fh:
            results[name] = json.load(fh)
        check(all(math.isfinite(v) for v in results[name].values()), f"{name} CLI results {results[name]}")
    with open(out["few"]) as fh:
        results["few_shot"] = json.load(fh)
    check(set(results["few_shot"]) == {"1", "2"}, f"few-shot CLI results {results['few_shot']}")
    check(all(math.isfinite(v) for v in results["measures_std"].values()), f"measures --status std {results}")
    for name in ("measures_vanilla", "measures_bock", "measures_anchor"):
        check(all(math.isfinite(v) for v in results[name].values()), f"{name}: {results[name]}")
    check(results["old_school"]["F1"] >= OLD_SCHOOL_F1_MIN, f"old-school mean F1 {results['old_school']}")
    tracker = BeatTracker(device="cuda")
    for decoder in ("dbn", "librosa"):
        with open(out[decoder]) as fh:
            tracked = json.load(fh)
        check(sorted(tracked) == [r.name for r in records], f"track-dir {decoder} files {sorted(tracked)}")
        for name, beats in tracked.items():
            _beats_match(np.asarray(beats), tracker.track_file(os.path.join(wav_dir, name), decoder=decoder).beat_times,
                         f"track-dir {decoder} {name} vs in-process")
    for r in records:
        sig, sr = audio_io.read_wav(os.path.join(root, "wavs44k", r.name))
        check(sr == 44100 and sig.shape[0] == 12 * 44100, f"resave {r.name}: {sr} Hz, {sig.shape[0]} samples")
    emit("evaluate", part="cli", seconds=secs, subprocess=["track_dir_dbn"], results=results)
    shutil.rmtree(root)


def phase_evaluate(ds) -> None:
    t0 = time.perf_counter()
    _bock_parity(ds)
    _bock_steps()
    _evaluate_cli(ds)
    emit("evaluate", part="done", seconds=time.perf_counter() - t0)


def _separator_step_parity() -> None:
    """One MaskNet train_step at batch 2 on the card and on the CPU from the
    same seeded params, bank and crops, at the train step's tolerances."""
    from zeronotesamba_torch.train.separator import CROP_LEN, SeparatorConfig, init_separator_state, synth_bank, train_step

    bank = synth_bank(2, 4.5, seed=5)
    rng = np.random.default_rng(3)
    song, offs = rng.integers(0, 2, size=2), rng.integers(0, bank.shape[-1] - CROP_LEN + 1, size=2)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = init_separator_state(SeparatorConfig(lr=SEP_LR), 0, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        t0 = time.perf_counter()
        state, loss = train_step(state, *(torch.as_tensor(a, device=dev) for a in (bank, song, offs)))
        runs[dev] = dict(loss=float(loss), seconds=time.perf_counter() - t0, before=before,
                         params={k: v.detach().cpu() for k, v in state.model.named_parameters()},
                         grads={k: v.grad.cpu() for k, v in state.model.named_parameters()})
    g, c = runs["cuda"], runs["cpu"]
    check(all(torch.equal(g["before"][k], c["before"][k]) for k in c["before"]), "seeded separator weights differ")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    eps = torch.finfo(torch.float32).eps
    param_excess = max(((g["params"][k] - c["params"][k]).abs() - 2 * SEP_LR - 2 * eps * c["params"][k].abs())
                       .max().item() for k in c["params"])
    moved = max((c["params"][k] - c["before"][k]).abs().max().item() for k in c["params"])
    grad_rel = {k: ((g["grads"][k] - c["grads"][k]).abs().max() / c["grads"][k].abs().max()).item()
                for k in c["grads"]}
    worst = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= PARITY_LOSS_RTOL, f"separator step loss card {g['loss']} vs CPU {c['loss']}")
    check(0.0 < moved and param_excess <= 0.0, f"separator step params card vs CPU exceed 2 lr by {param_excess}")
    check(grad_rel[worst] <= PARITY_GRAD_REL, f"separator gradient of {worst} card vs CPU {grad_rel[worst]}")
    emit("separator", part="step_parity", batch=2, frames=256, lr=SEP_LR, loss_card=g["loss"], loss_cpu=c["loss"],
         loss_rel_err=loss_rel, max_grad_err_of_tensor_max=grad_rel[worst], worst_grad=worst,
         max_param_excess_over_2lr=param_excess, max_param_step=moved, seconds_card=g["seconds"],
         seconds_cpu=c["seconds"])


def separator_flops(frames: int) -> float:
    """Forward FLOPs (mul+add = 2) of one MaskNet column of 512 bins x frames:
    the MACs per (bin, frame) of MASK_SPECS and the 1x1 output conv."""
    from zeronotesamba_torch.models.separator import MASK_SPECS, N_BINS, N_STEMS

    macs, cin = 0, 1
    for ch, (kf, kt), _ in MASK_SPECS:
        macs += kf * kt * cin * ch
        cin = ch
    return 2.0 * (macs + cin * N_STEMS) * N_BINS * frames


def _separator_throughput() -> None:
    """MaskNet train steps on the card at batch 8 x 256 frames in float32
    (the JAX CLI's default batch), crops of a random 8-song 12 s bank on the
    device: the median of 6 after 2 warm-up, each ended by a loss read."""
    from zeronotesamba_torch.train.separator import (
        CROP_FRAMES, CROP_LEN, SeparatorConfig, init_separator_state, train_step,
    )

    steps, warmup = 6, 2
    bank = 0.1 * torch.randn(8, 3, int(12 * SR), device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    rng = np.random.default_rng(4)
    state = init_separator_state(SeparatorConfig(), 0, device="cuda")
    flops = 3.0 * SEP_BATCH * separator_flops(CROP_FRAMES)  # fwd + bwd
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup + steps):
        song = torch.as_tensor(rng.integers(0, 8, size=SEP_BATCH), device="cuda")
        offs = torch.as_tensor(rng.integers(0, bank.shape[-1] - CROP_LEN + 1, size=SEP_BATCH), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, bank, song, offs)
        check(math.isfinite(float(loss)), "separator step loss not finite")  # the read syncs
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    emit("separator", part="throughput", dtype="float32", batch=SEP_BATCH, frames=CROP_FRAMES, steps=steps,
         ms_per_step=ms, step_ms=times, tflop_per_step=flops / 1e12, tflop_per_s=flops / 1e12 / (ms / 1e3),
         max_memory_allocated=torch.cuda.max_memory_allocated())


def _separator_quality() -> None:
    """The shipped separator's SI-SDR on synth_bank(8, 12 s, 999) on the card:
    within SEP_SI_SDR_ATOL of the JAX package's, above the card's HPSS."""
    from zeronotesamba_torch.models.separator import load_separator
    from zeronotesamba_torch.train.separator import eval_si_sdr, hpss_baseline_si_sdr, synth_bank

    val = synth_bank(8, 12.0, 999)
    model = load_separator(device="cuda")
    eval_si_sdr(model, *(torch.as_tensor(val[:1, i], device="cuda") for i in range(3)))  # cuDNN plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learned = [float(v) for v in eval_si_sdr(model, *(torch.as_tensor(val[:, i], device="cuda") for i in range(3)))]
    eval_s = time.perf_counter() - t0
    hpss = list(hpss_baseline_si_sdr(val, device="cuda"))
    gaps = [a - b for a, b in zip(learned, SEP_JAX_SI_SDR)]
    check(all(abs(d) <= SEP_SI_SDR_ATOL for d in gaps), f"shipped separator SI-SDR {learned} vs JAX {SEP_JAX_SI_SDR}")
    check(learned[0] > hpss[0] and learned[1] > hpss[1], f"learned SI-SDR {learned} does not beat HPSS {hpss}")
    emit("separator", part="quality", songs=8, song_s=12.0, si_sdr_drums_rest=learned, jax_si_sdr=SEP_JAX_SI_SDR,
         gap_vs_jax_db=gaps, hpss_si_sdr_drums_rest=hpss, eval_seconds=eval_s)


def _separator_train() -> None:
    """train_separator for 20 steps on 8 songs, evaluated every 10, on the
    card: its saved npz reloads equal; then train-separator as a subprocess
    at the same size."""
    from zeronotesamba_torch.models.separator import load_separator
    from zeronotesamba_torch.train.separator import SeparatorConfig, train_separator

    ckpt, cli_ckpt, cli_json = (os.path.join(OUT_DIR, f) for f in ("separator_run.npz", "separator_cli.npz",
                                                                    "separator_cli.json"))
    cfg = SeparatorConfig(steps=SEP_TRAIN_STEPS, eval_every=SEP_EVAL_EVERY, checkpoint_path=ckpt)
    t0 = time.perf_counter()
    best, hist = train_separator(cfg, train_songs=SEP_TRAIN_SONGS, device="cuda")
    run_s = time.perf_counter() - t0
    check(len(hist["loss"]) == SEP_TRAIN_STEPS // SEP_EVAL_EVERY
          and all(math.isfinite(v) for vals in hist.values() for v in vals), f"train_separator history {hist}")
    loaded = load_separator(ckpt, device="cpu").state_dict()
    check(set(loaded) == set(best) and all(torch.equal(loaded[k], best[k]) for k in best),
          "the saved separator npz does not reload equal")
    cli_s, stdout = _cli(["train-separator", "--steps", str(SEP_TRAIN_STEPS), "--train-songs", str(SEP_TRAIN_SONGS),
                          "--checkpoint", cli_ckpt, "--out", cli_json, "--device", "cuda"])
    report = json.loads(stdout)
    check(all(math.isfinite(v) for v in report.values()) and os.path.exists(cli_ckpt), f"train-separator {report}")
    emit("separator", part="train", steps=SEP_TRAIN_STEPS, batch=cfg.batch_size, train_songs=SEP_TRAIN_SONGS,
         eval_every=SEP_EVAL_EVERY, seconds=run_s, history=hist, cli_seconds=cli_s, cli=report)


def _separator_serving(stats: dict) -> None:
    """The learned serving path: track_signal(separation="learned") with the
    shipped separator on the main path's 30 s click track, on the card (with
    the kernel launches of one call counted) and on the CPU; the DBN's three
    decodes of its pulse; the infer (in this process) and track-dir --separation learned (a
    subprocess) CLI against the same tracker."""
    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.models.separator import SEPARATOR_NPZ
    from zeronotesamba_torch.utils import profiling

    sig, _ = click_track(30.0, 120.0, seed=0)
    kw = dict(separation="learned", sep_model=SEPARATOR_NPZ, decoder="dbn")
    gpu, cpu = BeatTracker(seed=0, device="cuda"), BeatTracker(seed=0, device="cpu")
    t0 = time.perf_counter()
    gpu.track_signal(sig, **kw)  # loads the MaskNet onto the card once
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    before = profiling.totals()
    t0 = time.perf_counter()
    res_g = gpu.track_signal(sig, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {**_counted("vqt_launch.", before), **_counted("dbn_launch.", before)}
    check(launches == {"cascade": 1, "octave": 1, "viterbi": 1}, f"learned path launches {launches}")
    for kname, n in launches.items():
        stats[kname]["learned_path_launches"] = n
    t0 = time.perf_counter()
    res_c = cpu.track_signal(sig, **kw)
    cpu_s = time.perf_counter() - t0
    errs = {f: float(np.abs(getattr(res_g, f) - getattr(res_c, f)).max())
            for f in ("anchor_pulse", "positive_pulse", "fused_pulse")}
    check(all(e <= PULSE_ATOL for e in errs.values()), f"learned path pulses card vs CPU {errs}")
    _beats_match(res_g.beat_times, res_c.beat_times, "learned path card vs CPU")
    check(len(res_g.beat_times) > 0 and bool(np.isfinite(res_g.vqt).all()), "learned path output")

    wav_dir = os.path.join(OUT_DIR, "learned_wavs")
    os.makedirs(wav_dir, exist_ok=True)
    wav, out_json = os.path.join(wav_dir, "click_12s.wav"), os.path.join(OUT_DIR, "track_dir_learned.json")
    audio_io.write_wav(wav, click_track(12.0, 120.0, seed=1)[0], SR)
    cli_s, stdout = _cli(["infer", wav, "--separation", "learned", "--device", "cuda"], in_process=True)
    payload = json.loads(stdout.strip().splitlines()[-1])
    ref = gpu.track_file(wav, **kw)
    check(payload["n_frames"] == ref.fused_pulse.shape[0], "infer --separation learned n_frames")
    _beats_match(np.asarray(payload["beat_times"]), ref.beat_times, "infer --separation learned vs in-process")
    track_dir_s, _ = _cli(["track-dir", wav_dir, "--separation", "learned", "--device", "cuda", "--out", out_json])
    with open(out_json) as fh:
        tracked = json.load(fh)
    check(list(tracked) == ["click_12s.wav"], f"track-dir --separation learned {tracked}")
    _beats_match(np.asarray(tracked["click_12s.wav"]), ref.beat_times, "track-dir --separation learned vs in-process")
    _dbn_agrees(res_g.fused_pulse, "learned path")
    emit("separator", part="serving", clip_s=30.0, launches=launches, max_abs_err_card_vs_cpu=errs,
         n_beats=len(res_g.beat_times), card_first_s=first_s, card_warm_s=warm_s, cpu_s=cpu_s,
         masknet_gflop=separator_flops(res_g.fused_pulse.shape[0]) / 1e9,
         cli=dict(seconds=cli_s, n_frames=payload["n_frames"], n_beats=len(payload["beat_times"]),
                  track_dir_seconds=track_dir_s))


def _separator_spleeter(stats: dict) -> None:
    """The Spleeter serving path, untimed (the spleeter-etl-30s cell times
    it): a 30 s click track at 44.1 kHz through
    track_signal(separation="spleeter") at the published widths (the
    backend's seeded weights), its counters, and its magnitude, masks and
    16 kHz streams (``Spleeter.last``) against the plain reference
    (benchmark/reference/spleeter.py) within that cell's limits; a second
    call, which replays the stages' CUDA graphs, gives the same magnitude
    and masks and streams within those limits."""
    from benchmark.reference import spleeter as ref
    from zeronotesamba_torch.data.separation import _spleeter_model
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.models.weights import spleeter_source_from_state_dict
    from zeronotesamba_torch.utils import profiling

    with open(os.path.join(ROOT, "benchmark", "configs", "spleeter_4stems.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(ROOT, "benchmark", "limits", "spleeter-etl-30s.json")) as fh:
        limits = json.load(fh)
    sig, _ = click_track(30.0, 120.0, sr=44100, seed=0)
    tracker = BeatTracker(seed=0, device="cuda")
    before = profiling.totals()
    res = tracker.track_signal(sig, 44100, separation="spleeter", decoder="dbn")
    counted = _counted("spleeter.", before)
    check(counted == {"segments": 3, "unet_launch": 4, "deconv_launch": 24}, f"spleeter path counters {counted}")
    stats["deconv"]["launches"] = {"spleeter_song": counted["deconv_launch"]}
    model = _spleeter_model(None, "cuda")
    last = model.last
    w = {k: torch.as_tensor(v, device="cuda")
         for k, v in spleeter_source_from_state_dict(model.state_dict(), model.cfg.instruments).items()}
    spec = ref.stft(sig, cfg, "cuda")
    mag = ref.magnitude(spec, cfg, torch.float64)
    streams = ref.streams(spec, last["masks"], len(sig), cfg)
    got = last["streams"].double()
    gaps = {"spec_gap": float((last["magnitude"].double() - mag).abs().max() / mag.max()),
            "mask_gap": float((last["masks"] - ref.masks(w, last["magnitude"], cfg)).abs().max()),
            "stream_gap": float(((got - streams).abs().amax(-1) / streams.abs().amax(-1)).max())}
    check(all(gaps[k] <= limits[k] for k in gaps), f"spleeter path against the reference {gaps} (limits {limits})")
    check(res.vqt.shape == (2, 96, 1876) and bool(np.isfinite(res.vqt).all()) and len(res.beat_times) > 0,
          "spleeter path output")
    # The first call ran the stages and captured them; the second replays the graphs.
    first = {k: v.clone() for k, v in last.items()}
    model.separate(sig, 44100)
    replay_gap = {k: float((model.last[k] - first[k]).abs().max() / first[k].abs().max()) for k in first}
    # cuDNN's encoder convs may add in another order; the STFT's and the decoder kernel's do not.
    check(replay_gap["magnitude"] == 0.0 and replay_gap["masks"] <= limits["mask_gap"]
          and replay_gap["streams"] <= limits["stream_gap"],
          f"spleeter graph replay against its eager call {replay_gap}")
    emit("separator", part="spleeter", clip_s=30.0, sample_rate=44100, counters=counted, gaps=gaps,
         replay_gap=replay_gap, n_beats=len(res.beat_times), parameters=sum(t.numel() for t in w.values()))


def phase_separator(stats: dict) -> None:
    t0 = time.perf_counter()
    _separator_step_parity()
    _separator_throughput()
    _separator_quality()
    _separator_train()
    _separator_serving(stats)
    _separator_spleeter(stats)
    emit("separator", part="done", seconds=time.perf_counter() - t0)


def key_tree(doc) -> dict | None:
    """A JSON document's keys, nested; None at every leaf."""
    return {k: key_tree(v) for k, v in doc.items()} if isinstance(doc, dict) else None


def suite_key_tree(few_shot_sizes, clmr: bool = False) -> dict:
    """The key tree of the JAX demo suite's summary.json for a run with these
    few-shot sizes: that of the committed results/synthetic/summary.json,
    brought up to three changes the JAX demo suite
    (zeronotesamba_tpu/experiments/demo_suite.py) made after that file was
    written: ``pretext`` gained ``selection``, ``watchdog_restarts`` and
    ``proxy_f1_best`` (:270-274); ``supervised.arm_overrides`` went and
    ``by_decoder.bock`` became ``by_decoder.bock_tcn`` (:319-327); and
    ``supervised.bock_tcn_note`` came (:330)."""
    with open(os.path.join(ROOT, "results", "synthetic", "summary.json")) as fh:
        tree = key_tree(json.load(fh))
    tree["pretext"].update(selection=None, watchdog_restarts=None, proxy_f1_best=None)
    sup = tree["supervised"]
    del sup["arm_overrides"]
    sup["by_decoder"]["bock_tcn"] = sup["by_decoder"].pop("bock")
    sup["bock_tcn_note"] = None
    for arm in tree["few_shot"].values():
        leaf = next(iter(arm.values()))
        arm.clear()
        arm.update({str(s): leaf for s in few_shot_sizes})
    if not clmr:
        del tree["clmr"]
    return tree


def _json_leaves(doc, path=""):
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from _json_leaves(v, f"{path}/{k}")
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            yield from _json_leaves(v, f"{path}[{i}]")
    else:
        yield path, doc


def _suite_run(stats: dict) -> str:
    """run_demo_suite at SUITE's size on the card, with the kernel launches
    of the whole run counted: one cascade and one octave launch per
    generate_xqt call, three a corpus song; one Viterbi launch a DBN decode
    on the card (the experiments' scored validation and test passes)."""
    import glob
    import shutil

    from zeronotesamba_torch.experiments.demo_suite import DemoSuiteConfig, run_demo_suite
    from zeronotesamba_torch.utils import profiling

    out_dir = os.path.join(OUT_DIR, "suite")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = DemoSuiteConfig(out_dir=out_dir, **SUITE)
    before = profiling.totals()
    t0 = time.perf_counter()
    summary = run_demo_suite(cfg, device="cuda")
    secs = time.perf_counter() - t0
    launches = {**_counted("vqt_launch.", before), **_counted("dbn_launch.", before)}
    decodes = _counted("dbn.", before)["device"]
    songs = cfg.n_songs + cfg.n_songs_b + cfg.pretext_songs + cfg.proxy_songs
    check(launches == {"cascade": 3 * songs, "octave": 3 * songs, "viterbi": decodes},
          f"suite launches {launches}, expected {3 * songs} of each VQT kernel (3 a corpus song) "
          f"and {decodes} Viterbi launches (one a DBN decode on the card)")
    for kname, n in launches.items():
        stats[kname]["suite_launches"] = n
    for ckpt in glob.glob(os.path.join(out_dir, "*.pth")):  # the pretext twin's weights, ~100 MB each
        os.remove(ckpt)
    bad = [(p, v) for p, v in _json_leaves(summary)
           if not isinstance(v, str) and not (isinstance(v, (int, float)) and math.isfinite(v))]
    check(not bad, f"suite results not finite: {bad}")
    f1 = {p: v for p, v in _json_leaves(summary) if "f1" in p.rsplit("/", 1)[-1].lower()}
    check(f1 and all(0.0 <= v <= 1.0 for v in f1.values()), f"suite F1 outside [0, 1]: {f1}")
    expected = suite_key_tree(cfg.few_shot_sizes)
    check(key_tree(summary) == expected, f"suite key tree {key_tree(summary)} != {expected}")
    emit("suite", part="run", config=SUITE, corpus_songs=songs, seconds=secs, launches=launches,
         summary={k: v for k, v in summary.items() if k != "supervised"},
         supervised={k: v["F1"] for k, v in summary["supervised"].items() if isinstance(v, dict) and "F1" in v})
    return out_dir


def _suite_checks(out_dir: str) -> None:
    """export-xlsx on the suite's output as a subprocess; resample_device
    card vs CPU at 44.1 -> 16 kHz; the card's log-VQT (both kernels) against
    the direct float64 oracle on a 3 s click track, at the JAX package's
    tests/test_vqt.py limits."""
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.ops.filterbank import XQTParams
    from zeronotesamba_torch.ops.oracle import MULTIRATE_LIMITS, multirate_errors, xqt_direct
    from zeronotesamba_torch.ops.resample import resample_device
    from zeronotesamba_torch.ops.vqt import best_log_xqt

    xlsx_s, stdout = _cli(["export-xlsx", "--src", out_dir, "--out", os.path.join(out_dir, "xlsx")])
    manifest = json.loads(stdout)
    wanted = ["unsupervised.xlsx", "cross_data.xlsx", "few_shot.xlsx", "measures.xlsx", "beat_tracking.xlsx"]
    check(manifest["written"] == wanted and all(os.path.getsize(os.path.join(out_dir, "xlsx", f)) > 0
                                               for f in wanted), f"export-xlsx {manifest}")

    y = torch.tensor(np.random.default_rng(6).uniform(-1.0, 1.0, (2, 3 * 44100)).astype(np.float32))
    y_card = y.cuda()
    got = resample_device(y_card, 44100, SR)
    ref = resample_device(y, 44100, SR)
    rs_err = float((got.cpu() - ref).abs().max())
    check(got.is_cuda and got.shape == ref.shape == (2, 3 * SR) and rs_err <= RESAMPLE_ATOL,
          f"resample_device card vs CPU {rs_err}")
    rs_ms = time_ms(lambda: resample_device(y_card, 44100, SR), n=10)

    oracle = {}
    sig = click_track(3.0, 120.0, seed=3)[0]
    for mode in ("vqt", "cqt"):
        p = XQTParams(mode=mode)
        with torch.inference_mode():
            card = best_log_xqt(torch.tensor(sig, device="cuda")[None], p)[0].double().cpu().numpy()
        oracle[mode] = multirate_errors(np.exp(card) - p.log_eps, xqt_direct(sig, p), p)
        check(all(oracle[mode][k] < lim for k, lim in MULTIRATE_LIMITS.items()),
              f"card log-{mode} vs the direct oracle {oracle[mode]} (limits {MULTIRATE_LIMITS})")
    emit("suite", part="checks", export_xlsx=dict(seconds=xlsx_s, written=manifest["written"]),
         resample=dict(shape=list(got.shape), max_abs_err_card_vs_cpu=rs_err, event_ms=rs_ms),
         oracle=oracle, oracle_limits=MULTIRATE_LIMITS)


def phase_suite(stats: dict) -> None:
    t0 = time.perf_counter()
    out_dir = _suite_run(stats)
    _suite_checks(out_dir)
    emit("suite", part="done", seconds=time.perf_counter() - t0)


def _mesh_step_inputs(bank: np.ndarray, world: int, k: int, batch: int) -> tuple:
    """Rank-local track indices (world*k,), their global rows, and starts."""
    rng = np.random.default_rng(4)
    local = rng.integers(0, MESH_SHARD, size=(world, k))
    starts = np.stack([rng.choice(bank.shape[-1] - PRETEXT_CROP + 1, size=batch, replace=False)
                       for _ in range(world * k)])
    return local.reshape(-1), (np.arange(world)[:, None] * MESH_SHARD + local).reshape(-1), starts


def _np_params(model) -> tuple:
    return ({k: v.detach().cpu().numpy() for k, v in model.named_parameters()},
            {k: v.grad.cpu().numpy() for k, v in model.named_parameters()})


def _mesh_one_rank(bank: np.ndarray, smi: str) -> None:
    """A world of one NCCL rank in this process: the track-parallel staged
    step (k = 2, dropout on, cuDNN deterministic) against the single-device
    step from the same seeded twin, each then timed with CUDA events;
    the one flattened gradient all-reduce timed alone; ntxent_global
    against ntxent."""
    from zeronotesamba_torch.losses.ntxent import ntxent, ntxent_global
    from zeronotesamba_torch.parallel.launch import single_rank
    from zeronotesamba_torch.parallel.mesh import all_reduce_grads
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
    from zeronotesamba_torch.train.supervised import dropout_generator

    cfg = PretextConfig(batch_size=16, crop_frames=PRETEXT_CROP, lr=1e-5)
    local, _, starts = _mesh_step_inputs(bank, 1, 2, cfg.batch_size)
    bank_dev = torch.as_tensor(bank[:MESH_SHARD], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    emb = [torch.rand(32, PRETEXT_CROP, device="cuda", generator=g) for _ in range(2)]  # pulse-like, in (0, 1)
    torch.backends.cudnn.deterministic = True
    runs, ms = {}, {}
    try:
        with single_rank("nccl", "cuda:0") as mesh:
            for name, m in (("plain", None), ("mesh", mesh)):
                state = init_pretext_state(cfg, 0, device="cuda")
                step = make_staged_train_step(cfg, m)
                _, loss, pc, nc = step(state, bank_dev, local, starts, dropout_generator(1, 0, "cuda"))
                runs[name] = ([loss.item(), pc.item(), nc.item()], _np_params(state.model)[0])
                ms[name] = time_ms(lambda: step(state, bank_dev, local, starts, dropout_generator(1, 1, "cuda")),
                                   n=3, warmup=1)
            params = list(state.model.parameters())
            ms["grad_all_reduce"] = time_ms(lambda: all_reduce_grads(params, mesh.group), n=20)
            n_grad = sum(p.numel() for p in params)
            ntx = {}
            for name, fn in (("ntxent", lambda a, p: ntxent(a, p, cfg.temperature)),
                             ("global", lambda a, p: ntxent_global(a, p, cfg.temperature, mesh.group))):
                a, p = (e.clone().requires_grad_(True) for e in emb)
                vals = fn(a, p)
                vals[0].backward()
                ntx[name] = ([v.item() for v in vals], a.grad.cpu().numpy(), p.grad.cpu().numpy())
    finally:
        torch.backends.cudnn.deterministic = False
    (v0, p0), (v1, p1) = runs["plain"], runs["mesh"]
    step_err = max([abs(a - b) for a, b in zip(v0, v1)] + [float(np.abs(p1[k] - p0[k]).max()) for k in p0])
    check(step_err <= MESH_ONE_RANK_ATOL, f"one-rank mesh step vs single device: {step_err} > {MESH_ONE_RANK_ATOL}")
    nv, ng = ntx["ntxent"], ntx["global"]
    ntx_rel = max(abs(a - b) / abs(a) for a, b in zip(nv[0], ng[0]))
    ntx_grad = max(float(np.abs(nv[i] - ng[i]).max()) for i in (1, 2))
    check(ntx_rel <= MESH_LOSS_RTOL and ntx_grad <= MESH_NTX_GRAD_ATOL,
          f"ntxent_global at world 1 vs ntxent: {ntx_rel} relative, gradients {ntx_grad}")
    emit("mesh", part="one_rank", backend="nccl", world=1, tracks=2, batch=cfg.batch_size, crop=PRETEXT_CROP,
         dropout=cfg.dropout_rate, loss=v1[0], max_abs_err_mesh_vs_single=step_err, bitwise=step_err == 0.0,
         step_ms_single=ms["plain"], step_ms_mesh=ms["mesh"], mesh_minus_single_ms=ms["mesh"] - ms["plain"],
         grad_all_reduce_ms=ms["grad_all_reduce"], grad_floats=n_grad, ntxent_global_rel_err=ntx_rel,
         ntxent_global_grad_err=ntx_grad, card=smi)


def _mesh_rank(mesh, t_spawn, bank, local, starts, a, p):
    """One rank of the two gloo ranks sharing the card: ntxent_global on its
    rows of (a, p), and the track-parallel staged step (dropout 0) on its
    shard of ``bank``; numpy results, with the wall-clock seconds since
    ``t_spawn`` at which each stage ended."""
    timeline = {"in_process_group": time.time() - t_spawn}
    from zeronotesamba_torch.device import disable_tf32
    from zeronotesamba_torch.losses.ntxent import ntxent_global
    from zeronotesamba_torch.parallel.mesh import shard_batch
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step

    disable_tf32()
    torch.backends.cudnn.deterministic = True
    la, lp = (x.requires_grad_(True) for x in shard_batch(mesh, a, p))
    vals = ntxent_global(la, lp, 0.25, mesh.group)
    vals[0].backward()
    timeline["ntxent_global"] = time.time() - t_spawn
    cfg = PretextConfig(batch_size=starts.shape[1], crop_frames=PRETEXT_CROP, dropout_rate=0.0, lr=1e-5)
    state = init_pretext_state(cfg, 0, device=mesh.device)
    timeline["init"] = time.time() - t_spawn
    _, loss, pc, nc = make_staged_train_step(cfg, mesh)(state, shard_batch(mesh, bank), local, starts, None)
    values = [loss.item(), pc.item(), nc.item()]  # the read waits for the step
    timeline["step"] = time.time() - t_spawn
    params, grads = _np_params(state.model)
    return dict(ntx=([v.item() for v in vals], la.grad.cpu().numpy(), lp.grad.cpu().numpy()),
                values=values, params=params, grads=grads, timeline=timeline, device=str(mesh.device))


def _mesh_two_ranks(bank: np.ndarray, smi: str) -> None:
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device; gloo stages the card's tensors through the host): the d = 2,
    k = 2 track-parallel step against the single-rank k = 4 step, and
    ntxent_global against ntxent on the global batch."""
    from zeronotesamba_torch.losses.ntxent import ntxent
    from zeronotesamba_torch.parallel.launch import run_ranks
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step

    world, k, batch = 2, 2, 16
    local, global_idx, starts = _mesh_step_inputs(bank, world, k, batch)
    g = np.random.default_rng(6)
    a, p = (g.random((world * batch, PRETEXT_CROP), dtype=np.float32) for _ in range(2))
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_rank, world, "gloo", time.time(), bank[:world * MESH_SHARD], local, starts, a, p,
                      device="cuda:0", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    check([r["device"] for r in ranks] == ["cuda:0"] * world, f"rank devices {[r['device'] for r in ranks]}")
    check(all(np.array_equal(ranks[1]["params"][n], v) for n, v in ranks[0]["params"].items())
          and ranks[0]["values"] == ranks[1]["values"], "the two ranks' parameters or losses differ")

    cfg = PretextConfig(batch_size=batch, crop_frames=PRETEXT_CROP, dropout_rate=0.0, lr=1e-5)
    torch.backends.cudnn.deterministic = True
    try:
        state = init_pretext_state(cfg, 0, device="cuda")
        _, loss, pc, nc = make_staged_train_step(cfg)(state, torch.as_tensor(bank[:world * MESH_SHARD], device="cuda"),
                                                       global_idx, starts, None)
        params, grads = _np_params(state.model)
        ta, tp = (torch.tensor(x, device="cuda", requires_grad=True) for x in (a, p))
        ref = ntxent(ta, tp, 0.25)
        ref[0].backward()
    finally:
        torch.backends.cudnn.deterministic = False
    got = ranks[0]
    single = [loss.item(), pc.item(), nc.item()]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(got["values"], single))
    grad_rel = {n: float(np.abs(got["grads"][n] - gr).max() / np.abs(gr).max()) for n, gr in grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    eps = float(np.finfo(np.float32).eps)
    param_excess = max(float((np.abs(got["params"][n] - v) - 2 * cfg.lr - 2 * eps * np.abs(v)).max())
                       for n, v in params.items())
    ntx_vals = got["ntx"][0]
    ntx_rel = max(abs(x - y.item()) / abs(y.item()) for x, y in zip(ntx_vals, ref))
    ntx_grad = max(float(np.abs(np.concatenate([r["ntx"][i] for r in ranks]) - t.grad.cpu().numpy()).max())
                   for i, t in ((1, ta), (2, tp)))
    check(loss_rel <= MESH_LOSS_RTOL, f"two-rank step loss/cosines {got['values']} vs single k = 4 {single}")
    check(grad_rel[worst] <= PARITY_GRAD_REL, f"two-rank step gradient of {worst}: {grad_rel[worst]} of its largest")
    check(param_excess <= 0.0, f"two-rank step params exceed 2 lr by {param_excess}")
    check(ntx_rel <= MESH_LOSS_RTOL and ntx_grad <= MESH_NTX_GRAD_ATOL,
          f"ntxent_global on two ranks vs ntxent: {ntx_rel} relative, gradients {ntx_grad}")
    emit("mesh", part="two_ranks", backend="gloo", world=world, device="cuda:0 (shared)", tracks_per_rank=k,
         batch=batch, crop=PRETEXT_CROP, loss=got["values"][0], loss_single_k4=single[0], loss_rel_err=loss_rel,
         max_grad_err_of_tensor_max=grad_rel[worst], worst_grad=worst, max_param_excess_over_2lr=param_excess,
         ntxent_global_rel_err=ntx_rel, ntxent_global_grad_err=ntx_grad, rank_timelines=[r["timeline"] for r in ranks],
         seconds_with_spawn=ranks_s, card=smi)


def _mesh_cli(stats: dict, bank: np.ndarray, smi: str) -> None:
    """pretext --data-parallel --stem-root on phase 7's stems (one NCCL rank
    a card), with the VQT launches of the bank build that its rank 0 counts
    and prints, and infer --params with the checkpoint it wrote, in this
    process."""
    import shutil

    stem_root = os.path.join(OUT_DIR, "pretext_stems")
    run_dir = os.path.join(OUT_DIR, "mesh_cli")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt = os.path.join(run_dir, "shift_pret_cnn_16.pth")
    wav = os.path.join(OUT_DIR, "pretext_click.wav")  # phase 7's
    secs, out = {}, {}
    for name, args in (("pretext", ["pretext", "--data-parallel", "--stem-root", stem_root, "--epochs", "2",
                                    "--checkpoint", ckpt]),
                       ("infer", ["infer", wav, "--params", ckpt])):
        secs[name], stdout = _cli(args, timeout=600, in_process=name == "infer")
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        check(name != "pretext" or len(lines) == 1, f"pretext --data-parallel printed {len(lines)} JSON lines")
        out[name] = json.loads(lines[-1])
    p = out["pretext"]
    check(p["ranks"] == torch.cuda.device_count() and p["epochs"] == 2 and math.isfinite(p["best_val_loss"]),
          f"pretext --data-parallel {p}")
    launches, n_items = p["bank_vqt_launches"], p["bank_items"]
    check(n_items == len(bank) and launches == {k: 2 * n_items for k in ("cascade", "octave")},
          f"pretext --data-parallel bank of {n_items} items (phase 7: {len(bank)}) launched {launches}, "
          "expected 2 of each kernel an item")
    for kname in ("cascade", "octave"):
        stats[kname]["data_parallel_bank_launches_per_item"] = launches[kname] / n_items
    check(os.listdir(run_dir) == [os.path.basename(ckpt)], f"checkpoints written: {os.listdir(run_dir)}")
    check(out["infer"]["n_frames"] == 501, f"infer --params output {out['infer']}")
    emit("mesh", part="cli", ranks=p["ranks"], bank_items=n_items, train_items=n_items - max(1, n_items // 10),
         epochs=p["epochs"], best_val_loss=p["best_val_loss"], seconds=secs, bank_launches=launches,
         infer_n_beats=len(out["infer"]["beat_times"]), card=smi)
    shutil.rmtree(run_dir)  # 107 MB of twin weights, checked above


def _mesh_entry(smi: str) -> None:
    """parallel/dryrun.entry() on the card against the CPU, from the same
    seeded weights, at the pulse tolerance."""
    from zeronotesamba_torch.parallel.dryrun import entry

    outs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        fn, args = entry(device=dev)
        t0 = time.perf_counter()
        outs[dev] = fn(*args).cpu()
        secs[dev] = time.perf_counter() - t0
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    check(outs["cuda"].shape == (2, 313) and bool(torch.isfinite(outs["cuda"]).all()),
          f"entry() output {tuple(outs['cuda'].shape)}")
    check(err <= PULSE_ATOL, f"entry() card vs CPU max |err| {err} > {PULSE_ATOL}")
    emit("mesh", part="entry", shape=list(outs["cuda"].shape), max_abs_err_card_vs_cpu=err, tol=PULSE_ATOL,
         seconds_card_first_call=secs["cuda"], seconds_cpu=secs["cpu"], card=smi)


def _mesh_dryrun(smi: str) -> None:
    """dryrun_multichip(4) on four gloo ranks sharing the card (one card:
    more ranks than cards). A stage that fails raises, so every lap listed
    passed."""
    from zeronotesamba_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    laps = dryrun_multichip(MESH_DRYRUN_RANKS, device="cuda")
    check(laps[-1]["stage"] == "tp", f"dry run ended at {laps[-1]}")
    emit("mesh", part="dryrun", ranks=MESH_DRYRUN_RANKS, backend="gloo", device="cuda:0 (shared)",
         stages=[dict(lap, passed=True) for lap in laps], seconds_with_spawn=time.perf_counter() - t0, card=smi)


def _mesh_axes_rank(mesh0, t_spawn, shapes, arrays, lr):
    """One of two gloo ranks sharing the card. Rank 0 takes the
    single-device supervised step (the reference, its max-pool and ReLU
    decisions recorded); every rank records the same decisions from a
    forward of its own, then takes one step on each mesh of ``shapes``,
    replaying its share of them, and times MESH_AXES_STEPS more. Rank 0
    returns the errors against the single-device step; every rank its times,
    halo and channel bytes and peak memory."""
    from zeronotesamba_torch.parallel.mesh import gather_params_tp, gather_tp, make_mesh, shard_params_tp, \
        spectrogram_sharding
    from zeronotesamba_torch.train.state import downstream_learning_rate
    from zeronotesamba_torch.train.supervised import SupervisedConfig, init_state, train_step
    from zeronotesamba_torch.utils import profiling
    from zeronotesamba_torch.utils.parity import PiecewiseDecisions

    torch.backends.cudnn.deterministic = True
    timeline = {"in_process_group": time.time() - t_spawn}
    dev = mesh0.device
    cfg = SupervisedConfig(status="pretrained", lr=lr)
    step_lr = downstream_learning_rate(cfg.status, cfg.pre, cfg.lr)
    full = [torch.as_tensor(a, device=dev) for a in arrays]

    def timed_steps(state, xs, mesh):
        times = []
        for _ in range(MESH_AXES_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss, _ = train_step(state, *xs, None, cfg.status, mesh=mesh)
            check(math.isfinite(loss.item()), "mesh axes step loss not finite")  # the read syncs
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    decisions, ref, out = PiecewiseDecisions(), None, {"rank": mesh0.flat_rank, "device": str(dev), "meshes": {}}
    state = init_state(cfg, None, 0, device=dev)
    if mesh0.flat_rank == 0:
        torch.cuda.reset_peak_memory_stats()
        with decisions.record():
            state, loss, _ = train_step(state, *full, None, cfg.status)
        ref = dict(loss=loss.item(), params={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                   grads={k: p.grad.clone() for k, p in state.model.named_parameters()})
        step_ms = timed_steps(state, full, None)
        out["single"] = dict(ms_per_step=statistics.median(step_ms), step_ms=step_ms,
                             max_memory_allocated=torch.cuda.max_memory_allocated())
    else:
        with torch.no_grad(), decisions.record():
            state.model.eval()  # a train step without a generator runs with dropout off
            state.model.logits(full[0][:, 0:1], full[0][:, 1:2])
    del state
    timeline["reference"] = time.time() - t_spawn
    eps = torch.finfo(torch.float32).eps
    for shape in shapes:
        mesh = make_mesh(*shape, device=dev)
        state = init_state(cfg, None, 0, device=dev)
        if shape[2] > 1:
            shard_params_tp(mesh, state.model)
        xs = [spectrogram_sharding(mesh)(a) for a in full]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = profiling.totals()
        with decisions.shard(mesh).replay():
            state, loss, _ = train_step(state, *xs, None, cfg.status, mesh=mesh)
        bytes_step = (_counted("sequence.", before).get("halo_bytes", 0),
                      _counted("tensor.", before).get("channel_bytes", 0))
        grads = gather_tp(mesh, state.model, {k: p.grad for k, p in state.model.named_parameters()})
        params = gather_params_tp(mesh, state.model)
        step_ms = timed_steps(state, xs, mesh)
        res = dict(loss=loss.item(), ms_per_step=statistics.median(step_ms), step_ms=step_ms,
                   halo_bytes_per_step=bytes_step[0], channel_bytes_per_step=bytes_step[1],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        if ref is not None:
            rel = {k: ((grads[k] - g).abs().max() / g.abs().max()).item() for k, g in ref["grads"].items()}
            worst = max(rel, key=rel.get)
            res.update(loss_single=ref["loss"], loss_rel_err=abs(loss.item() - ref["loss"]) / abs(ref["loss"]),
                       max_grad_err_of_tensor_max=rel[worst], worst_grad=worst,
                       max_param_excess_over_2lr=max(((params[k] - v).abs() - 2 * step_lr - 2 * eps * v.abs())
                                                     .max().item() for k, v in ref["params"].items()))
        out["meshes"]["x".join(map(str, shape))] = res
        timeline["x".join(map(str, shape))] = time.time() - t_spawn
        del state, grads, params
    out["timeline"] = timeline
    return out


def _mesh_axes_steps(smi: str) -> None:
    """The supervised step at the train cell's shape (the twin
    FusedDownstream, batch 8 x 768, float32, TF32 off, dropout 0) on a
    (1, 2, 1) and a (1, 1, 2) mesh of two gloo ranks sharing the card,
    against the single-device step: loss MESH_LOSS_RTOL, gradients
    PARITY_GRAD_REL of each tensor's largest (both with the single-device
    step's max-pool and ReLU decisions replayed), parameters 2 lr plus
    float32 rounding."""
    from zeronotesamba_torch.parallel.launch import run_ranks
    from zeronotesamba_torch.train.state import downstream_learning_rate

    batch, frames = 8, PARITY_FRAMES
    g = np.random.default_rng(8)
    vqt = (g.standard_normal((batch, 2, 96, frames)) * 4.0 - 6.0).astype(np.float32)
    mask = np.ones((batch, frames), np.float32)
    mask[:, 751:] = 0.0  # a 12 s song's 751 frames in its bucket
    mask[3, 500:] = 0.0  # and one shorter song
    pulse = (g.uniform(size=(batch, frames)) < 0.05).astype(np.float32) * mask
    shapes = ((1, 2, 1), (1, 1, 2))
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_axes_rank, 2, "gloo", time.time(), shapes, (vqt, pulse, mask), 1e-4,
                      device="cuda:0", timeout_s=600)
    seconds = time.perf_counter() - t0
    lr = downstream_learning_rate("pretrained", "finetune", 1e-4)
    for name, res in ranks[0]["meshes"].items():
        check(res["loss_rel_err"] <= MESH_LOSS_RTOL, f"mesh {name} step loss {res['loss']} vs {res['loss_single']}")
        check(res["max_grad_err_of_tensor_max"] <= PARITY_GRAD_REL,
              f"mesh {name} gradient of {res['worst_grad']}: {res['max_grad_err_of_tensor_max']} of its largest")
        check(res["max_param_excess_over_2lr"] <= 0.0,
              f"mesh {name} params exceed 2 lr by {res['max_param_excess_over_2lr']}")
        check((res["halo_bytes_per_step"] > 0) == (name == "1x2x1") and (res["channel_bytes_per_step"] > 0)
              == (name == "1x1x2"), f"mesh {name} exchanged {res['halo_bytes_per_step']} halo bytes and "
              f"{res['channel_bytes_per_step']} channel bytes")
    emit("mesh", part="axes_steps", backend="gloo", world=2, device="cuda:0 (shared)", batch=batch, frames=frames,
         dropout=0.0, lr=lr, single=ranks[0]["single"],
         meshes={name: dict(res, per_rank=[dict(ms_per_step=r["meshes"][name]["ms_per_step"],
                                                max_memory_allocated=r["meshes"][name]["max_memory_allocated"],
                                                halo_bytes_per_step=r["meshes"][name]["halo_bytes_per_step"],
                                                channel_bytes_per_step=r["meshes"][name]["channel_bytes_per_step"])
                                           for r in ranks])
                 for name, res in ranks[0]["meshes"].items()},
         rank_timelines=[r["timeline"] for r in ranks], seconds_with_spawn=seconds, card=smi)


def phase_mesh(stats: dict, bank: np.ndarray, smi: str) -> None:
    t0 = time.perf_counter()
    _mesh_one_rank(bank, smi)
    _mesh_two_ranks(bank, smi)
    _mesh_cli(stats, bank, smi)
    _mesh_entry(smi)
    _mesh_dryrun(smi)
    _mesh_axes_steps(smi)
    emit("mesh", part="done", seconds=time.perf_counter() - t0, card=smi)


MULTISTEP_K = 8  # steps a call in the multistep phase
# (name, engine, status or task, dtype, batch, frames, tracks a step): the
# train cell's twin and BockTCN at 8 x 768, the pretext cell at 16 x 313.
MULTISTEP_SHAPES = (
    ("twin_f32", "supervised", "pretrained", "float32", 8, 768, 1),
    ("twin_bf16", "supervised", "pretrained", "bfloat16", 8, 768, 1),
    ("bock_f32", "supervised", "bock", "float32", 8, 768, 1),
    ("pretext_f32", "pretext", "zerons", "float32", 16, PRETEXT_CROP, 1),
    ("pretext_bf16", "pretext", "zerons", "bfloat16", 16, PRETEXT_CROP, 1),
    ("pretext_k2_bf16", "pretext", "zerons", "bfloat16", 16, PRETEXT_CROP, 2),
)


def _profiled(fn) -> dict:
    """Host seconds of fn() (ended by a synchronize) under torch.profiler
    with CUDA activity only; the device's busy seconds in it, the union of
    its kernels' and copies' spans in the trace (their summed durations
    count overlapping spans twice, ``kernel_sum_s``); and the idle share.
    No device time in the trace gives None."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy = busy_us / 1e6
    return dict(wall_s=wall, busy_s=busy or None, kernel_sum_s=sum(b - a for a, b in spans) / 1e6,
                idle_share=1.0 - busy / wall if busy else None)


_MULTISTEP_WEIGHTS: dict = {}  # seeded initial weights, drawn once per model


def _multistep_case(engine: str, status: str, dtype: str, batch: int, frames: int, tracks: int):
    """(init, eager_step, multi_step, lr) for one shape: ``init()`` a seeded
    state; ``eager_step(state, s)`` the current eager path's step s (dropout
    on) with its loss read; ``multi_step(state, c)`` call c of K steps, its
    losses read once; each returns (state, losses, outputs)."""
    from zeronotesamba_torch.train.pretext import (
        PretextConfig, init_pretext_state, make_staged_train_step, sample_shifts,
    )
    from zeronotesamba_torch.train.state import downstream_learning_rate
    from zeronotesamba_torch.train.supervised import (
        SupervisedConfig, dropout_generator, init_state, make_multistep_train_step, train_step,
    )

    k_call, gen = MULTISTEP_K, torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    if engine == "supervised":
        cfg = SupervisedConfig(status=status, lr=1e-4, bucket_frames=frames, compute_dtype=dtype)
        n, streams = 2 * batch, 1 if status == "bock" else 2
        bucket = (torch.randn(n, streams, 96, frames, device="cuda", generator=gen) * 4.0 - 6.0,
                  (torch.rand(n, frames, device="cuda", generator=gen) < 0.05).float(),
                  torch.ones(n, frames, device="cuda"))
        idx = [np.stack([rng.choice(n, batch, replace=False) for _ in range(k_call)]) for _ in range(4)]
        multi = make_multistep_train_step(status)

        def init():
            state = init_state(cfg, None, 0, params=_MULTISTEP_WEIGHTS.get(status), device="cuda")
            _MULTISTEP_WEIGHTS.setdefault(status, {k: v.clone() for k, v in state.model.state_dict().items()})
            return state

        def eager_step(state, s):
            rows = torch.as_tensor(idx[s // k_call][s % k_call], device="cuda")
            state, loss, out = train_step(state, *(t.index_select(0, rows) for t in bucket),
                                          dropout_generator(11, s, "cuda"), status)
            return state, [float(loss)], out

        def multi_step(state, c):
            gens = [dropout_generator(11, c * k_call + k, "cuda") for k in range(k_call)]
            state, losses, outs = multi(state, *bucket, idx[c], gens)
            return state, losses.tolist(), outs

        return init, eager_step, multi_step, downstream_learning_rate(status, cfg.pre, cfg.lr)
    cfg = PretextConfig(batch_size=batch, crop_frames=frames, compute_dtype=dtype, lr=1e-5)
    bank = torch.randn(8, 2, 96, 2 * frames, device="cuda", generator=gen)
    shape = (k_call,) if tracks == 1 else (k_call, tracks)
    calls = [(rng.integers(0, 8, size=shape), np.stack([sample_shifts(2 * frames, batch, frames, rng)
                                                         for _ in range(k_call * tracks)]).reshape(*shape, batch))
             for _ in range(4)]
    single, multi = make_staged_train_step(cfg), make_staged_train_step(cfg, steps_per_call=k_call)

    def init():
        state = init_pretext_state(cfg, 0, params=_MULTISTEP_WEIGHTS.get("zerons"), device="cuda")
        _MULTISTEP_WEIGHTS.setdefault("zerons", {k: v.clone() for k, v in state.model.state_dict().items()})
        return state

    def eager_step(state, s):
        ti, st = (a[s % k_call] for a in calls[s // k_call])
        state, loss, pc, nc = single(state, bank, ti, st, dropout_generator(11, s, "cuda"))
        return state, [float(loss)], torch.stack([pc, nc])

    def multi_step(state, c):
        gens = [dropout_generator(11, c * k_call + k, "cuda") for k in range(k_call)]
        state, losses, pcs, ncs = multi(state, bank, *calls[c], gens)
        return state, losses.tolist(), torch.stack([pcs, ncs], 1)

    return init, eager_step, multi_step, cfg.lr


def _graph_pool_bytes() -> int:
    """Bytes the card holds in the multi-step graphs' memory pool."""
    from zeronotesamba_torch.train import multistep

    pool = multistep._POOLS[torch.cuda.current_device()]
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _multistep_shape(name, engine, status, dtype, batch, frames, tracks, smi: str) -> None:
    """One K = 8 graph call against 8 eager steps of the same code from the
    same state (cuDNN deterministic): the 16 losses finite; the 8 losses,
    outputs and the final parameters bit for bit, or within the step
    tolerances with the reason.
    ms a step at K = 1: the median of those eager steps, each ended by its
    loss read; at K = 8: the first call less its capture (warm-up and
    record), over 8, the losses read once. The capture's seconds, peak
    memory (an eager step's own, over what was allocated before it, beside
    the graph pool's bytes), and the device's idle share over 8 steps each
    way (a replay; eager steps) from the profiler."""
    from zeronotesamba_torch.utils import profiling

    t_shape = time.perf_counter()
    k_call = MULTISTEP_K
    init, eager_step, multi_step, lr = _multistep_case(engine, status, dtype, batch, frames, tracks)
    eager, graph = init(), init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e_losses, e_outs, e_ms = [], [], []
    for s in range(k_call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager, losses, out = eager_step(eager, s)
        e_ms.append((time.perf_counter() - t0) * 1e3)
        e_losses += losses
        e_outs.append(out)
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    captures = profiling.totals("multistep.")["captures"]
    t0 = time.perf_counter()
    graph, g_losses, g_outs = multi_step(graph, 0)
    first_call_s = time.perf_counter() - t0
    peak_graph = torch.cuda.max_memory_allocated()
    pool_bytes = _graph_pool_bytes()
    (entry,) = graph.graphs.values()
    check(profiling.totals("multistep.")["captures"] == captures + 1, f"{name}: the first K-step call did not capture")
    check(all(math.isfinite(v) for v in e_losses + g_losses), f"{name}: loss not finite")
    e_outs = torch.stack(e_outs)
    pairs = [(a, b) for a, b in zip(graph.model.parameters(), eager.model.parameters())]
    bitwise = (g_losses == e_losses and torch.equal(g_outs, e_outs)
               and all(torch.equal(a, b) for a, b in pairs))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g_losses, e_losses))
    out_err = (g_outs - e_outs).abs().max().item()
    eps = torch.finfo(torch.float32).eps
    param_excess = max(((a - b).abs() - 2 * lr * k_call - 2 * eps * b.abs()).max().item() for a, b in pairs)
    reason = None
    if not bitwise:
        reason = (f"graph and eager differ (losses {loss_rel}, outputs {out_err}); held at the step tolerances: "
                  f"loss {PARITY_LOSS_RTOL} relative, params 2 lr a step")
        check(loss_rel <= PARITY_LOSS_RTOL and param_excess <= 0.0, f"{name}: {reason}: out of them")
    prof = {"k8": _profiled(lambda: multi_step(graph, 1))}

    def eager_window():
        nonlocal eager
        for s in range(k_call, 2 * k_call):
            eager, _, _ = eager_step(eager, s)

    prof["k1"] = _profiled(eager_window)
    check(profiling.totals("multistep.")["captures"] == captures + 1, f"{name}: a replay captured again")
    k1_ms, k8_ms = statistics.median(e_ms), (first_call_s - entry.seconds) * 1e3 / k_call
    # The profiler's own host cost slows the eager steps (up to 45% here at
    # BockTCN's step), so the idle share is also given at the unprofiled
    # step time, with the device's busy time from the trace.
    unprofiled = {k: None if prof[k]["busy_s"] is None else 1.0 - prof[k]["busy_s"] / k_call / (ms / 1e3)
                  for k, ms in (("k1", k1_ms), ("k8", k8_ms))}
    emit("multistep", part="shape", name=name, engine=engine, model=status, dtype=dtype, batch=batch,
         frames=frames, tracks=tracks, k=k_call, cudnn_deterministic=True, bitwise=bitwise, reason=reason,
         max_loss_rel_err=loss_rel, max_out_err=out_err, max_param_excess_over_2lr_k=param_excess,
         ms_per_step_k1=k1_ms, step_ms_k1=e_ms, ms_per_step_k8=k8_ms, first_call_s=first_call_s,
         capture_s=entry.seconds, max_memory_allocated_k1=peak_eager, eager_step_peak_bytes=peak_eager - base,
         max_memory_allocated_k8=peak_graph, graph_pool_bytes=pool_bytes,
         profiled_ms_per_step_k1=prof["k1"]["wall_s"] * 1e3 / k_call,
         profiled_ms_per_step_k8=prof["k8"]["wall_s"] * 1e3 / k_call,
         device_busy_s_k1=prof["k1"]["busy_s"], device_busy_s_k8=prof["k8"]["busy_s"],
         kernel_sum_s_k1=prof["k1"]["kernel_sum_s"], kernel_sum_s_k8=prof["k8"]["kernel_sum_s"],
         idle_share_k1=prof["k1"]["idle_share"], idle_share_k8=prof["k8"]["idle_share"],
         idle_share_k1_unprofiled=unprofiled["k1"], idle_share_k8_unprofiled=unprofiled["k8"],
         seconds=time.perf_counter() - t_shape, card=smi)


def _multistep_beat(ds, smi: str) -> None:
    """beat --steps-per-call 8 against --steps-per-call 1 on the train
    phase's 16 songs, in this process, cuDNN deterministic: 4 folds, 2
    epochs, batch 1, so a fold's 9 training songs make one 8-step call and
    one single step an epoch (2 folds would leave 4 training songs, no
    group of 8). Every fold's test F1 (from the experiment's log records)
    and the CLI's JSON must be equal."""
    import logging
    import shutil

    from zeronotesamba_torch.utils import profiling

    root = os.path.join(OUT_DIR, "multistep")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "all16")
    ds.save(data)
    folds = {}

    class FoldF1(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith("fold %d: test F1"):
                folds.setdefault(self.k, []).append(float(record.args[1]))

    handler = FoldF1()
    logger = logging.getLogger("zns_torch.experiments.beat")
    logger.addHandler(handler)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for k in (8, 1):
            handler.k = k
            out = os.path.join(root, f"beat_k{k}.json")
            before = profiling.totals()
            secs, _ = _cli(["beat", "--data", data, "--folds", "4", "--max-epochs", "2", "--batch-size", "1",
                            "--steps-per-call", str(k), "--out", out, "--device", "cuda"], in_process=True)
            with open(out) as fh:
                runs[k] = dict(seconds=secs, results=json.load(fh),
                               **_counted("multistep.", before))
    finally:
        torch.backends.cudnn.deterministic = False
        logger.removeHandler(handler)
    check(runs[8]["captures"] == 4 and runs[8]["replays"] == 8 and runs[1]["replays"] == 0,
          f"beat --steps-per-call 8 ran {runs[8]['captures']} captures, {runs[8]['replays']} replays")
    check(len(folds.get(8, [])) == 4 and folds[8] == folds[1] and runs[8]["results"] == runs[1]["results"],
          f"beat --steps-per-call 8 vs 1: fold F1s {folds}, results {runs[8]['results']} vs {runs[1]['results']}")
    emit("multistep", part="beat", folds=4, max_epochs=2, batch=1, fold_f1_k8=folds[8], fold_f1_k1=folds[1],
         seconds_k8=runs[8]["seconds"], seconds_k1=runs[1]["seconds"], captures_k8=runs[8]["captures"],
         replays_k8=runs[8]["replays"], results_equal=True, F1=runs[8]["results"]["F1"], card=smi)
    shutil.rmtree(root)


def phase_multistep(ds, smi: str) -> None:
    """Multi-step dispatch (steps_per_call): K optimizer steps as one CUDA
    graph against K eager steps at the train and pretext cells' shapes, and
    the beat CLI at K = 8 against K = 1. cuDNN runs deterministic here."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        for shape in MULTISTEP_SHAPES:
            _multistep_shape(*shape, smi)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    _multistep_beat(ds, smi)
    emit("multistep", part="done", seconds=time.perf_counter() - t0, card=smi)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="add torch.profiler device times and the device's busy share (needs CUPTI)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    stats = {k: {"max_abs_err": 0.0} for k in KERNEL_SOURCES}
    phase_kernels(stats, args.trace)
    phase_conv(stats)
    phase_deconv(stats)
    pulse = phase_main_path(stats)
    phase_decode(stats, pulse)
    ds = phase_train(stats)
    bank = phase_pretext(stats)
    phase_evaluate(ds)
    phase_separator(stats)
    phase_suite(stats)
    phase_mesh(stats, bank, smi)
    phase_multistep(ds, smi)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        s = stats.pop(name)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=s.pop("launches"),
                            max_abs_err=s.pop("max_abs_err"), ms=s.pop("ms"), plain_ms=s.pop("plain_ms"),
                            bound_ms=s.pop("bound_ms"), bound_by=s.pop("bound_by"),
                            library_ms=s.pop("library_ms"), **s))
        k = kernels[-1]
        # No single PyTorch call computes the Viterbi recursion: its library_ms is null.
        timed = ("ms", "plain_ms", "bound_ms") + (() if name == "viterbi" else ("library_ms",))
        check(all(math.isfinite(k[f]) for f in timed), f"{name}: missing time")
    emit("done", seconds=time.perf_counter() - t_start)
    out_line(json.dumps({"kernels": kernels}))
    out_line(smi)
    out_line(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
