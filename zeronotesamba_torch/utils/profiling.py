"""Profiling / tracing hooks (port of zeronotesamba_tpu/utils/profiling.py).

``trace`` wraps torch.profiler (with CUDA activity when a card is present)
and writes a Chrome trace into its directory; ``annotate`` names a region in
that trace; ``timer`` is a small wall-clock registry for host-side stages
(decode, ETL).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_timers: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Device trace context: ``with trace('traces/run1'): step(...)``. Writes
    ``<log_dir>/trace_<time>.json`` (chrome://tracing or Perfetto)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    """Host wall-clock timer; aggregate with ``timing_summary()``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _timers[name].append(time.perf_counter() - t0)


def timing_summary(reset: bool = False) -> Dict[str, Dict[str, float]]:
    out = {}
    for name, vals in _timers.items():
        out[name] = {
            "count": len(vals),
            "total_s": sum(vals),
            "mean_ms": 1000.0 * sum(vals) / max(1, len(vals)),
        }
    if reset:
        _timers.clear()
    return out


def dump_timings(path: str):
    with open(path, "w") as fh:
        json.dump(timing_summary(), fh, indent=2)
