"""What every cell shares: the manifest, finding files by name, the benchmark's
own spans, the reduction of a profiler trace, and the checks.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its configuration
is ``configs/<config>.json``, its traffic ``traffic/<traffic>.json``, whose
``driver`` names ``drivers/<driver>.py``; its limits for ``correct`` are
``limits/<cell>.json``; a per-layer metric is ``metrics/<metric>.py``.
Adding a cell adds files and entries and edits none of these.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "zeronotesamba_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A Python file of the benchmark, imported by its path (its name may hold
    dots and hyphens)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}".replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload's entry with its configuration, traffic, driver and limits."""

    def __init__(self, name: str):
        self.manifest = load_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.config = load_json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.driver = load_module(HERE / "drivers" / f"{self.traffic['driver']}.py")
        self.limits = load_json(HERE / "limits" / f"{name}.json")

    def metrics(self, section: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.manifest[section] if self.name in m.get("workloads", [self.name])]


class Spans:
    """The benchmark's own spans around its calls into the program, on the
    host clock; under the profiler each is also a ``record_function`` range."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in microseconds."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6


class Trace:
    """The device's and the host's events of a profiled window."""

    def __init__(self, prof, span_names=()):
        import torch

        device, host, spans = [], [], []
        for e in prof.events():
            rng = (e.name, e.time_range.start, e.time_range.end)
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            if e.name in span_names or getattr(e, "is_user_annotation", False):
                # A range a program or the benchmark named shows on the host and, as its
                # device-side annotation, on the device: it is no device work.
                if not on_device and e.name in span_names:
                    spans.append(rng)
            elif on_device:
                device.append(rng)
            elif e.cpu_parent is None or e.cpu_parent.name in span_names:
                host.append(rng)
        self.device = device  # kernels, copies and sets: (name, start_us, end_us)
        self.host = host  # the host's outermost torch ops
        self.spans = spans  # the benchmark's own spans

    def busy_s(self) -> float:
        return union_s((a, b) for _, a, b in self.device)

    def device_time(self, substring: str) -> tuple:
        """(seconds, launches) of the device events whose name holds ``substring``."""
        hits = [b - a for n, a, b in self.device if substring in n]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n[:120], s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time by what the host was doing: each gap's
        overlap with an outermost host torch op goes to that op; the rest
        goes to the benchmark's span it falls in (``<span>:python``: the
        program's Python and native host code, such as the DBN) or to
        ``harness`` outside every span."""
        gaps, end = [], None
        for a, b in sorted((a, b) for _, a, b in self.device):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [a for _, a, _ in host]
        by: dict = {}

        def add(label, us):
            by[label] = by.get(label, 0.0) + us / 1e6

        for g0, g1 in gaps:
            covered = []
            # Outermost torch ops are short: look at those starting up to 0.1 s before the gap.
            for n, a, b in host[bisect.bisect_left(starts, g0 - 1e5): bisect.bisect_left(starts, g1)]:
                lo, hi = max(a, g0), min(b, g1)
                if hi > lo:
                    add(n, hi - lo)
                    covered.append((lo, hi))
            at = g0
            for lo, hi in sorted(covered) + [(g1, g1)]:
                if lo > at:
                    self._add_uncovered(at, lo, add)
                at = max(at, hi)
        return sorted(([n[:120], s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def _add_uncovered(self, u0, u1, add) -> None:
        left = u1 - u0
        for n, a, b in self.spans:
            over = min(b, u1) - max(a, u0)
            if over > 0:
                add(f"{n}:python", over)
                left -= over
        if left > 0:
            add("harness", left)


def mfu(ctx) -> float | None:
    """The window's work at the frozen FLOP count (the cell driver's
    ``flops`` fact) over the traced window, as a share of one card's float32 peak."""
    from benchmark.reference.counts import PEAK_FP32_FLOPS

    flops = ctx["facts"].get("flops")
    return 100.0 * flops / ctx["window_s"] / PEAK_FP32_FLOPS if flops else None


def idle_share(ctx) -> float | None:
    """1 - (the union of the device's kernel, copy and set spans) / (the traced window)."""
    busy = ctx["trace"].busy_s() if ctx["trace"] is not None else 0.0
    return 100.0 * (1.0 - busy / ctx["window_s"]) if busy else None


def span_share(ctx, name: str) -> float | None:
    """The share of the traced window inside the benchmark's ``name`` spans."""
    inside = ctx["spans"].total(name)
    return 100.0 * inside / ctx["window_s"] if inside else None


def forbidden_modules() -> list:
    """The JAX modules, or the JAX package, this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every reading at or under its limit; a reading
    that is missing or not a number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = isinstance(value, (int, float)) and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
