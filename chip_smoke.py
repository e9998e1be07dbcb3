#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zeronotesamba_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace]

Phases, each printing one JSON line:

1. device     -- refuse to run without CUDA; card name and power limit; TF32 off.
2. build      -- compile the kernels from csrc/ with nvcc (parallel, one per source).
3. kernels    -- each kernel against its plain PyTorch version on the card at the
                 main path's shapes (and batch 2 x 10 s, 32 x 10 s, 1 x 0.5 s, and
                 a ragged 3 x 7.3 s), with times: kernel, plain version, one
                 library call, and the card's bound.
4. main_path  -- BeatTracker.track_signal on a 30 s click track on the card and on
                 the CPU with the same seeded weights; launch counters; the CLI.
5. throughput -- log-VQT + FusedDownstream on batch 32 x 10 s, float32 and bf16.
6. train      -- the supervised training path, one JSON line per part: the ETL
                 (build_synthetic, 16 songs x 12 s, on the card, with its kernel
                 launches counted and two songs held against the CPU), one
                 train_step card vs CPU, train-step times at batch 8 x 768
                 frames in float32 and bf16, the 4-fold experiment (mean
                 held-out F1 >= 0.9, class-balanced BCE), and the
                 build-data / beat CLI.
7. pretext    -- self-supervised pretext training, one JSON line per part: the
                 banks (mine_stems with HPSS on 12 synthetic 12 s mixes and a
                 tone, the stem bank and the CLMR bank on the card, launches
                 counted, two items held against the CPU), one staged k = 2
                 NT-Xent step card vs CPU, step times at batch 16 x 313 in
                 float32 and bf16, a 3-epoch train_pretext with proxy-F1
                 selection and one resumed epoch, and the pretext / infer CLI.

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
``library_trace_ms``) and the device's busy time over one warm
``track_signal``. The default run uses no profiler, so it does not depend on
CUPTI being free for this process.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
LOG_PATH = os.path.join(OUT_DIR, "smoke.jsonl")

SR = 16000
FPS = 62.5
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
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
KERNEL_SOURCES = {
    "cascade": ("zeronotesamba_torch/csrc/vqt_cascade.cu", "zeronotesamba_tpu/ops/pallas/vqt_kernel.py:157"),
    "octave": ("zeronotesamba_torch/csrc/vqt_octave.cu", "zeronotesamba_tpu/ops/pallas/vqt_kernel.py:32"),
}


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
    from zeronotesamba_torch.ops.cuda import build

    secs = build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "smem", "spill"))]
             for n, log in build.build_logs().items()}
    emit("build", seconds=secs, dir=os.path.relpath(build.build_dir(), ROOT), ptxas=ptxas)


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
    # stream among them); free them so that the throughput phase's peak
    # memory is the model's own.
    torch._C._cuda_clearCublasWorkspaces()


def _beats_match(a: np.ndarray, b: np.ndarray, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} beats vs {len(b)}")
    if len(a):
        d = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        check(d <= 1.0 / FPS + 1e-9, f"{what}: beats differ by {d} s (> 1 frame)")


def _stage_breakdown(tracker, sig: np.ndarray, trace: bool) -> dict:
    """Host-clock seconds of each stage of one warm track_signal on the card
    (the same calls, each ended by a synchronize), and with ``trace`` the
    device's busy time over one whole warm call from the profiler."""
    from zeronotesamba_torch.data.separation import separate
    from zeronotesamba_torch.decode import decode
    from zeronotesamba_torch.ops.filterbank import XQTParams
    from zeronotesamba_torch.ops.vqt import best_log_xqt

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {}
    with torch.inference_mode():
        (anc, pos), out["separation_hpss_s"] = timed(lambda: separate(sig, SR, "hpss", device=tracker.device))
        vqts, out["log_vqt_s"] = timed(lambda: best_log_xqt(
            torch.as_tensor(np.stack([anc, pos]), device=tracker.device), XQTParams()))
        fused, out["encoders_s"] = timed(lambda: tracker.model(vqts[0:1, None], vqts[1:2, None]).cpu().numpy()[0])
    _, out["dbn_decode_s"] = timed(lambda: decode(fused, "dbn"))
    if not trace:
        return out
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: tracker.track_signal(sig, separation="hpss", decoder="dbn"))
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    out["profiled_wall_s"] = wall
    out["device_busy_s"] = busy_us / 1e6
    out["device_idle_share"] = 1.0 - busy_us / 1e6 / wall
    out["top_device_ops"] = [(e.key[:60], e.self_device_time_total / 1e3)
                             for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]]
    return out


def phase_main_path(stats: dict, trace: bool) -> None:
    from zeronotesamba_torch.data import audio_io
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
    from zeronotesamba_torch.ops.hpss import hpss_host

    sig, _ = click_track(30.0, 120.0, seed=0)
    gpu = BeatTracker(seed=0, device="cuda")
    cpu = BeatTracker(seed=0, device="cpu")
    for k, v in gpu.state_dict().items():
        check(torch.equal(v, cpu.state_dict()[k]), f"seeded weights differ at {k}")

    for key in vk.LAUNCHES:
        vk.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    res_g = gpu.track_signal(sig, separation="hpss", decoder="dbn")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(vk.LAUNCHES)
    # One log_xqt_fused call per track_signal: one cascade and one octave launch.
    check(launches == {"cascade": 1, "octave": 1}, f"main path launches {launches}, expected one of each")
    stats["cascade"]["launches"] = launches["cascade"]
    stats["octave"]["launches"] = launches["octave"]

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

    emit("main_path", clip_s=30.0, n_frames=n_frames, launches=launches, max_abs_err_card_vs_cpu=errs,
         n_beats=len(res_g.beat_times), card_first_s=first_s, card_warm_s=warm_s, cpu_s=cpu_s,
         card_breakdown=_stage_breakdown(gpu, sig, trace),
         cli=dict(seconds=cli_s, n_frames=payload["n_frames"], n_beats=len(payload["beat_times"])))


def encoder_flops(n_frames: int) -> float:
    """Forward FLOPs (mul+add = 2) of one encoder stream + head at n_frames,
    counted as bench.py counts them."""
    from zeronotesamba_torch.models.encoder import CONV_SPECS, EMBED_DIM, POOL_AFTER

    macs, h, cin = 0, 96, 1
    for i, (cout, (kh, kw)) in enumerate(CONV_SPECS):
        macs += kh * kw * cin * cout * h
        if i in POOL_AFTER:
            h //= POOL_AFTER[i]
        cin = cout
    return 2.0 * (macs + EMBED_DIM) * n_frames


def phase_throughput() -> None:
    from zeronotesamba_torch.models.encoder import FusedDownstream
    from zeronotesamba_torch.ops.filterbank import XQTParams
    from zeronotesamba_torch.ops.vqt import best_log_xqt

    batch, secs, steps, warmup, distinct = 32, 10.0, 6, 2, 3
    params = XQTParams()
    gen = torch.Generator(device="cuda").manual_seed(7)
    data = [(0.1 * torch.randn(batch, int(secs * SR), device="cuda", generator=gen),
             0.1 * torch.randn(batch, int(secs * SR), device="cuda", generator=gen)) for _ in range(distinct)]
    for dtype in (torch.float32, torch.bfloat16):
        model = FusedDownstream(compute_dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to("cuda").eval()
        torch.cuda.reset_peak_memory_stats()
        step_ms, vqt_ms = [], []
        with torch.inference_mode():
            for i in range(warmup + steps):
                anc, pos = data[i % distinct]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                va, vp = best_log_xqt(anc, params), best_log_xqt(pos, params)
                e1.record()
                out = model(va[:, None], vp[:, None])
                torch.cuda.synchronize()
                if i >= warmup:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    vqt_ms.append(e0.elapsed_time(e1))
        check(out.shape == (batch, params.num_frames(int(secs * SR))), f"throughput output shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "throughput output not finite")
        ms = statistics.median(step_ms)
        enc_flops = 2 * batch * encoder_flops(out.shape[1])  # anchor + positive streams
        emit("throughput", dtype=str(dtype).replace("torch.", ""), batch=batch, clip_s=secs, steps=steps,
             ms_per_step=ms, audio_min_per_s=batch * secs / 60.0 / (ms / 1e3),
             vqt_ms_per_step=statistics.median(vqt_ms), encoder_tflop_per_step=enc_flops / 1e12,
             encoder_tflop_per_s=enc_flops / 1e12 / ((ms - statistics.median(vqt_ms)) / 1e3),
             max_memory_allocated=torch.cuda.max_memory_allocated())


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
    from zeronotesamba_torch.ops.cuda import vqt_kernel as vk

    for key in vk.LAUNCHES:
        vk.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = build_synthetic(n_songs=ETL_SONGS, duration_s=ETL_SONG_S, seed=0, device="cuda")
    etl_s = time.perf_counter() - t0
    launches = dict(vk.LAUNCHES)
    n_calls = sum(r.vqt.shape[0] for r in ds)
    check(launches == {"cascade": n_calls, "octave": n_calls},
          f"ETL launches {launches}, expected {n_calls} of each (one per generate_xqt call)")
    for kname in KERNEL_SOURCES:
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


def _train_step_parity(ds) -> None:
    """One train_step at dropout off on the card and on the CPU from the
    same seeded pretrained FusedDownstream, on two staged songs."""
    from zeronotesamba_torch.train.state import downstream_learning_rate
    from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, train_step

    cfg = SupervisedConfig(status="pretrained", lr=1e-5, batch_size=2, bucket_frames=PARITY_FRAMES)
    lr = downstream_learning_rate(cfg.status, cfg.pre, cfg.lr)
    runs = {}
    for dev in ("cuda", "cpu"):
        staged = StagedDataset(ds.records[:2], cfg.bucket_frames, device=dev)
        (t, rows), = staged.plan(ds.names[:2], 2)
        b = staged.buckets[t]
        state = init_state(cfg, ds[0], 0, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        t0 = time.perf_counter()
        state, loss, _ = train_step(state, b.vqt, b.pulse, b.mask, None, cfg.status)
        runs[dev] = dict(loss=float(loss), seconds=time.perf_counter() - t0, before=before, frames=t,
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
    emit("train", part="step_parity", status=cfg.status, batch=2, frames=g["frames"], lr=lr,
         loss_card=g["loss"], loss_cpu=c["loss"], loss_rel_err=loss_rel, max_param_err=param_err,
         max_param_step=moved, max_grad_err_of_tensor_max=grad_rel[worst], worst_grad=worst,
         grad_rel_limit=PARITY_GRAD_REL, seconds_card=g["seconds"],
         seconds_cpu=c["seconds"])


def _train_throughput() -> None:
    """bench.py's bench_supervised_train on the card: pretrained fused twin,
    batch 8 x 768 frames, dropout on, distinct device batches."""
    from zeronotesamba_torch.train.supervised import SupervisedConfig, dropout_generator, init_state, train_step

    batch, frames, steps, warmup, distinct = 8, 768, 6, 2, 3
    gen = torch.Generator(device="cuda").manual_seed(1)
    data = [torch.randn(batch, 2, 96, frames, device="cuda", generator=gen) * 4.0 - 6.0 for _ in range(distinct)]
    pulse = torch.zeros(batch, frames, device="cuda")
    mask = torch.ones(batch, frames, device="cuda")
    flops = 3.0 * 2.0 * batch * encoder_flops(frames)  # fwd + bwd, two streams
    for dtype in ("float32", "bfloat16"):
        cfg = SupervisedConfig(status="pretrained", lr=1e-4, bucket_frames=frames, compute_dtype=dtype)
        state = init_state(cfg, None, 0, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, _ = train_step(state, data[i % distinct], pulse, mask,
                                        dropout_generator(0, i, "cuda"), cfg.status)
            check(math.isfinite(float(loss)), f"train step loss not finite ({dtype})")  # the read syncs
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        emit("train", part="throughput", dtype=dtype, batch=batch, frames=frames, steps=steps, ms_per_step=ms,
             step_ms=times, tflop_per_step=flops / 1e12, tflop_per_s=flops / 1e12 / (ms / 1e3),
             max_memory_allocated=torch.cuda.max_memory_allocated())
        del state


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
    """build-data and beat as subprocesses on the card."""
    import shutil

    from zeronotesamba_torch.data.datasets import BeatDataset

    data_dir, out_json = os.path.join(OUT_DIR, "synth4"), os.path.join(OUT_DIR, "beat.json")
    shutil.rmtree(data_dir, ignore_errors=True)
    cmds = {
        "build_data": ["build-data", "synthetic", "--out", data_dir, "--n-songs", "4", "--device", "cuda"],
        "beat": ["beat", "--data", data_dir, "--folds", "2", "--max-epochs", "2", "--out", out_json,
                 "--device", "cuda"],
    }
    secs = {}
    for name, args in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "zeronotesamba_torch", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        secs[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI {name} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    cache = BeatDataset.load(data_dir)
    check(cache.names == ds.names[:4], "build-data songs differ from build_synthetic's")
    vqt_err = max(float(np.abs(a.vqt - b.vqt).max()) for a, b in zip(cache, ds))
    check(vqt_err <= VQT_ATOL and all(np.array_equal(a.pulse, b.pulse) for a, b in zip(cache, ds)),
          f"build-data cache vs in-process ETL: log-VQT {vqt_err}")
    with open(out_json) as fh:
        res = json.load(fh)
    names = ("F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain")
    check(all(math.isfinite(res[n]) and math.isfinite(res[n + "_std"]) for n in names), f"beat results {res}")
    emit("train", part="cli", seconds=secs, n_songs=len(cache), max_abs_err_vqt_vs_in_process=vqt_err, results=res)


def phase_train(stats: dict) -> None:
    t0 = time.perf_counter()
    ds = _etl(stats)
    _train_step_parity(ds)
    _train_throughput()
    _experiment(ds)
    _train_cli(ds)
    emit("train", part="done", seconds=time.perf_counter() - t0)


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
    from zeronotesamba_torch.ops.cuda import vqt_kernel as vk
    from zeronotesamba_torch.ops.vqt import generate_xqt, log_xqt

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
        for key in vk.LAUNCHES:
            vk.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = build()
        torch.cuda.synchronize()
        counts[name] = dict(items=len(bank), shape=list(bank.shape), seconds=time.perf_counter() - t0,
                            launches=dict(vk.LAUNCHES))
        counts[name]["seconds_per_item"] = counts[name]["seconds"] / len(bank)
        per_item = 2 if name == "stem" else 1  # generate_xqt calls an item
        check(counts[name]["launches"] == {"cascade": per_item * len(bank), "octave": per_item * len(bank)},
              f"{name} bank launches {counts[name]['launches']}, expected {per_item} of each a bank item")
        if name == "stem":
            stem_bank = bank
    check(stem_bank.shape == (PRETEXT_TRACKS, 2, 96, PRETEXT_FRAMES), f"stem bank shape {stem_bank.shape}")
    check(counts["clmr"]["shape"] == [PRETEXT_TRACKS + 1, 2, 96, PRETEXT_CROP], f"CLMR bank {counts['clmr']}")
    check(bool(np.isfinite(stem_bank).all()), "stem bank not finite")
    for kname in KERNEL_SOURCES:
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


def _pretext_throughput() -> None:
    """bench.py's bench_pretext_train on the card: the staged zerons step,
    batch 16 x 313 from a random 4-track bank of 626 frames on the device,
    distinct (track, starts) a step, dropout on, 3 warm-up and 10 timed
    steps, each ended by a loss read."""
    from zeronotesamba_torch.train.pretext import (
        PretextConfig, init_pretext_state, make_staged_train_step, sample_shifts,
    )
    from zeronotesamba_torch.train.supervised import dropout_generator

    batch, steps, warmup = 16, 10, 3
    bank = torch.randn(4, 2, 96, 2 * PRETEXT_CROP, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))
    flops = 3.0 * 2.0 * batch * encoder_flops(PRETEXT_CROP)  # fwd + bwd, two streams
    for dtype in ("float32", "bfloat16"):
        cfg = PretextConfig(batch_size=batch, crop_frames=PRETEXT_CROP, compute_dtype=dtype)
        state = init_pretext_state(cfg, 0, device="cuda")
        step = make_staged_train_step(cfg)
        rng = np.random.default_rng(2)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup + steps):
            starts = sample_shifts(bank.shape[-1], batch, PRETEXT_CROP, rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, _, _ = step(state, bank, i % 4, starts, dropout_generator(3, i, "cuda"))
            check(math.isfinite(float(loss)), f"pretext step loss not finite ({dtype})")  # the read syncs
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        emit("pretext", part="throughput", dtype=dtype, batch=batch, crop=PRETEXT_CROP, steps=steps, ms_per_step=ms,
             step_ms=times, tflop_per_step=flops / 1e12, tflop_per_s=flops / 1e12 / (ms / 1e3),
             max_memory_allocated=torch.cuda.max_memory_allocated())
        del state


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
    the checkpoint it wrote."""
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
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "zeronotesamba_torch", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        secs[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI {name} failed ({proc.returncode}): {proc.stderr[-2000:]}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["pretext"]["epochs"] == 1 and math.isfinite(out["pretext"]["best_val_loss"]), f"pretext CLI {out}")
    check(out["infer"]["n_frames"] == 501, f"infer --params output {out['infer']}")
    emit("pretext", part="cli", seconds=secs, pretext=out["pretext"], infer_n_beats=len(out["infer"]["beat_times"]))
    os.remove(ckpt)  # 107 MB of twin weights, checked above


def phase_pretext(stats: dict) -> None:
    t0 = time.perf_counter()
    bank = _pretext_bank(stats)
    _pretext_step_parity(bank)
    _pretext_throughput()
    _pretext_run(bank)
    _pretext_cli(bank)
    emit("pretext", part="done", seconds=time.perf_counter() - t0)


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
    phase_main_path(stats, args.trace)
    phase_throughput()
    phase_train(stats)
    phase_pretext(stats)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        s = stats.pop(name)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=s.pop("launches"),
                            max_abs_err=s.pop("max_abs_err"), ms=s.pop("ms"), plain_ms=s.pop("plain_ms"),
                            bound_ms=s.pop("bound_ms"), bound_by=s.pop("bound_by"),
                            library_ms=s.pop("library_ms"), **s))
        k = kernels[-1]
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "library_ms", "bound_ms")), f"{name}: missing time")
    emit("done", seconds=time.perf_counter() - t_start)
    out_line(json.dumps({"kernels": kernels}))
    out_line(smi)
    out_line(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
