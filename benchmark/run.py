"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's driver makes its inputs and weights
from the seed and sets up the program (set-up ends at the first timed
request or step), measures for ``--seconds`` seconds (with ``--trace 1``,
the traffic's ``trace_seconds`` at most, under the profiler), then judges
what the timed path produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits 2; if JAX or the JAX package was loaded, 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at a fixed path."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def measure(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> dict:
    """One run of ``cell``: set-up, the window, the checks, the metrics.
    Returns the result object."""
    import torch

    from benchmark import harness

    spans = harness.Spans(trace)
    run = cell.driver.Run(cell.config, cell.traffic, seed, device)
    setup_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    tr = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
        with torch.profiler.profile(activities=acts) as prof:
            run.window(min(seconds, cell.traffic["trace_seconds"]), spans)
        tr = harness.Trace(prof, {n for n, _, _ in spans.spans})
    else:
        run.window(seconds, spans)
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())) if on_card else 0
    e2e = dict(run.end_to_end(), setup_s=setup_s)
    facts = run.facts()
    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = harness.judge(run.readings(), cell.limits)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed}
    if trace:
        ctx = {"trace": tr, "spans": spans, "window_s": run.window_s, "facts": facts}
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s() if on_card else 0.0, window_s=run.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown={"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})
    else:
        result.update(metrics={m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                               for m in cell.metrics("end_to_end")}, device=dev)
    result["card"] = _card() if on_card else "cpu"
    print(f"correct: {correct}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"run: {args.workload} needs {cell.entry['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible; no result", file=sys.stderr)
        return 2
    return emit(measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0))


def emit(result: dict) -> int:
    """Print the result line, last, unless the process has loaded JAX or the
    JAX package by now (the check, the metric readers and all): then say what
    on standard error, print no result and return 3."""
    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        print(f"run: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
