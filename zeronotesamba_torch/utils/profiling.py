"""The port's tracer: spans and counters of the program's host code, and the
``torch.profiler`` wrapper (the JAX package's utils/profiling.py wraps
``jax.profiler``).

- ``span(name)``: one span of the program, with its start and end on
  ``time.perf_counter()``, the index of the enclosing span and the request
  it serves, recorded into a buffer of fixed size (``CAPACITY``) while
  tracing is on. Tracing is on while a ``torch.profiler`` profile is active
  (``torch.autograd.profiler._is_profiler_enabled``) or after ``enable()``.
  Off, a span reads that flag and records nothing. A span is not a
  ``record_function`` range, so a profiler that sorts host ops under its own
  annotations sees the program's ops where it saw them without spans.
- ``count(name, n)``: adds ``n`` to the process's total of ``name``
  (``totals``), always; while tracing is on it also records ``(name, n,
  enclosing span)``, so a reader can divide one window's counts by its songs
  or steps. ``to_device`` and ``to_host`` count the crossings between the
  host and a card: ``h2d_bytes`` sent, ``d2h_syncs`` the host waited on.
- ``spans()``, ``counts()``, ``dropped()`` read the buffer, ``reset()``
  clears it. A full buffer records nothing more and counts what it drops.
- ``trace(log_dir)``: a profile of the block, written as a Chrome trace with
  the program's spans on a track of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16  # spans, and as many counts, a buffer holds
ANCHOR = "profiling.anchor"  # the record_function that ties perf_counter to a trace's clock


class Span(NamedTuple):
    name: str
    start: float  # perf_counter seconds
    end: Optional[float]  # None while the span is open
    parent: int  # the enclosing span's index in spans(), -1 at the top
    request: int  # the request (song, batch or step) the span serves; 0 before the first


class Count(NamedTuple):
    name: str
    n: int
    span: int  # the enclosing span's index in spans(), -1 outside every span


_totals: Dict[str, int] = {}
_spans: list = [None] * CAPACITY
_counts: list = [None] * CAPACITY
_n_spans = _n_counts = _dropped = _request = 0
_open: List[int] = []  # indices of the open spans, innermost last
_enabled = False


def enable(on: bool = True) -> None:
    """Record spans and counts whether or not a profiler is active."""
    global _enabled
    _enabled = on


class _Recorded:
    __slots__ = ("name", "new_request", "index")

    def __init__(self, name: str, new_request: bool):
        self.name, self.new_request = name, new_request

    def __enter__(self):
        global _n_spans, _dropped, _request
        if self.new_request:
            _request += 1
        if _n_spans == CAPACITY:
            _dropped += 1
            self.index = -1
            return self
        self.index = i = _n_spans
        _n_spans += 1
        _spans[i] = [self.name, time.perf_counter(), None, _open[-1] if _open else -1, _request]
        _open.append(i)
        return self

    def __exit__(self, *exc) -> bool:
        # After a reset() inside the span its slot belongs to another span.
        if _open and _open[-1] == self.index:
            _spans[self.index][2] = time.perf_counter()
            _open.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, *, request: bool = False):
    """``with span(name):`` records the block as a span while tracing is on.
    ``request=True`` starts a new request: this span and every span after it,
    until the next such span, carry its id."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Recorded(name, request)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the total of ``name``; while tracing is on, also records
    it under the innermost open span. ``count(name, 0)`` registers a name."""
    global _n_counts, _dropped
    _totals[name] = _totals.get(name, 0) + n
    if _enabled or _autograd_profiler._is_profiler_enabled:
        if _n_counts == CAPACITY:
            _dropped += 1
        else:
            _counts[_n_counts] = (name, n, _open[-1] if _open else -1)
            _n_counts += 1


def totals(prefix: str = "") -> Dict[str, int]:
    """The process's totals of the names that start with ``prefix``, keyed by
    the rest of the name."""
    return {k[len(prefix):]: v for k, v in _totals.items() if k.startswith(prefix)}


def spans() -> List[Span]:
    return [Span(*s) for s in _spans[:_n_spans]]


def counts() -> List[Count]:
    return [Count(*c) for c in _counts[:_n_counts]]


def dropped() -> int:
    """Spans and counts a full buffer did not record."""
    return _dropped


def reset() -> None:
    """Clears the buffer of spans and counts (the totals stay)."""
    global _n_spans, _n_counts, _dropped, _request
    _spans[:_n_spans] = [None] * _n_spans
    _counts[:_n_counts] = [None] * _n_counts
    _n_spans = _n_counts = _dropped = _request = 0
    _open.clear()


def to_device(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``; the bytes it sends
    from the host to a card count as ``h2d_bytes``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.is_cuda and not (isinstance(x, torch.Tensor) and x.is_cuda):
        count("h2d_bytes", t.nbytes)
    return t


def to_host(t) -> np.ndarray:
    """``t`` as a numpy array: ``t.cpu().numpy()`` for a tensor. A copy from a
    card, which the host waits on, counts as one of ``d2h_syncs``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.is_cuda:
        count("d2h_syncs")
    return t.cpu().numpy()


def _anchor() -> tuple:
    """(which of three ``ANCHOR`` ranges, perf_counter before, after): the
    narrowest bracket of a range with nothing inside it."""
    best = None
    for k in range(3):
        t0 = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        t1 = time.perf_counter()
        if best is None or t1 - t0 < best[2] - best[1]:
            best = (k, t0, t1)
    return best


def _add_spans(path: str, anchor: tuple, first: int) -> None:
    """Writes the recorded spans from index ``first`` on into the Chrome trace
    at ``path`` as one track (``Program spans``), on the trace's clock:
    ``anchor`` (from ``_anchor``) ties perf_counter to the trace's ``ANCHOR``
    event. Each span carries its request and the counts recorded under it."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    k, t0, t1 = anchor
    ref = [e for e in events if e.get("name") == ANCHOR and e.get("cat") == "user_annotation"][k]
    offset_us = ref["ts"] + ref.get("dur", 0.0) / 2 - (t0 + t1) / 2 * 1e6
    under: Dict[int, Dict[str, int]] = {}
    for c in counts():
        if c.span >= first:
            mine = under.setdefault(c.span, {})
            mine[c.name] = mine.get(c.name, 0) + c.n
    pid = "Program spans"
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": pid}})
    for i, s in enumerate(spans()[first:], first):
        if s.end is not None:
            events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": 0,
                           "ts": s.start * 1e6 + offset_us, "dur": (s.end - s.start) * 1e6,
                           "args": dict(request=s.request, parent=s.parent, **under.get(i, {}))})
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Device trace context: ``with trace('traces/run1'): step(...)``. Writes
    ``<log_dir>/trace_<time>.json`` (chrome://tracing or Perfetto) with the
    program's spans of the block on their own track."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        anchor = _anchor()
        first = _n_spans
        yield
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, anchor, first)
