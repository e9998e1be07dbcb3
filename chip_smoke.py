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
