"""The program's own spans and counts of a traced window, on the profiler's clock.

The port's tracer (``zeronotesamba_torch.utils.profiling``) records spans on
``time.perf_counter()`` while a profiler is active, and counts under the span
that encloses them. The profiler's events are in microseconds from the
trace's start. The benchmark's own spans (``harness.Spans``) are on both
clocks: on ``perf_counter`` in ``ctx["spans"]`` and, as ``record_function``
ranges, in ``ctx["trace"].spans``. ``load`` fits one offset between the two
from those anchors' midpoints (the median of their differences) and gives
None where the result cannot be trusted: fewer than ``MIN_ANCHORS``
anchors, a residual (the median distance of an anchor from the fit) over
``MAX_RESIDUAL_US``, a recording that dropped spans or counts, or a program
without the tracer.
"""

from __future__ import annotations

import bisect
import statistics

MIN_ANCHORS = 2
MAX_RESIDUAL_US = 100.0


def recording():
    """(spans, counts, dropped) of the program's tracer, or None for a
    program that has none."""
    try:
        from zeronotesamba_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "counts", "dropped")):
        return None
    return profiling.spans(), profiling.counts(), profiling.dropped()


def fit(ctx) -> tuple | None:
    """(offset_us, residual_us, anchors): the profiler's microseconds less
    perf_counter's, from the benchmark's spans on both clocks."""
    if ctx.get("trace") is None:
        return None
    mine: dict = {}
    theirs: dict = {}
    for name, a, b in ctx["spans"].spans:
        mine.setdefault(name, []).append((a, b))
    for name, a, b in ctx["trace"].spans:
        theirs.setdefault(name, []).append((a, b))
    diffs = []
    for name, pcs in mine.items():
        trs = sorted(theirs.get(name, []))
        if len(trs) != len(pcs):
            return None
        diffs += [(c + d) / 2 - (a + b) / 2 * 1e6 for (a, b), (c, d) in zip(sorted(pcs), trs)]
    if len(diffs) < MIN_ANCHORS:
        return None
    offset = statistics.median(diffs)
    return offset, statistics.median(abs(d - offset) for d in diffs), len(diffs)


def load(ctx, recorded=None) -> "Window | None":
    """The window's program spans and counts on the profiler's clock, or
    None (module docstring). ``recorded`` stands in for ``recording()``."""
    recorded = recording() if recorded is None else recorded
    fitted = fit(ctx)
    if recorded is None or fitted is None or recorded[2] > 0 or fitted[1] > MAX_RESIDUAL_US:
        return None
    return Window(ctx, recorded[0], recorded[1], fitted[0])


class Window:
    def __init__(self, ctx, spans, counts, offset_us: float):
        self.ctx, self.spans, self.counts, self.offset_us = ctx, spans, counts, offset_us

    def _within(self, i: int, outer: str) -> bool:
        """Whether span ``i`` is ``outer`` or lies inside one."""
        while i >= 0:
            if self.spans[i].name == outer:
                return True
            i = self.spans[i].parent
        return False

    def named(self, name: str, within: str | None = None) -> list:
        """The closed spans called ``name`` (inside an ``within`` span)."""
        return [s for i, s in enumerate(self.spans) if s.name == name and s.end is not None
                and (within is None or self._within(i, within))]

    def mean_ms(self, name: str, per: str) -> float | None:
        """The ``name`` spans' milliseconds inside ``per`` spans, over the ``per`` spans."""
        n = len(self.named(per))
        return 1e3 * sum(s.end - s.start for s in self.named(name, per)) / n if n else None

    def per_span(self, counter: str, per: str) -> float | None:
        """The ``counter`` counted inside ``per`` spans, over the ``per`` spans."""
        n = len(self.named(per))
        got = sum(c.n for c in self.counts if c.name == counter and c.span >= 0 and self._within(c.span, per))
        return got / n if n else None

    def idle_us(self, spans) -> float | None:
        """The device's idle microseconds (outside the union of the trace's
        device events) inside the given program spans, on the trace's clock;
        None where the trace holds no device event."""
        merged = []
        for _, a, b in sorted(self.ctx["trace"].device, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        if not merged:
            return None
        starts = [a for a, _ in merged]
        done = [0.0]
        for a, b in merged:
            done.append(done[-1] + b - a)

        def busy_before(t):
            k = bisect.bisect_right(starts, t)
            return done[k] - (max(0.0, merged[k - 1][1] - t) if k else 0.0)

        idle = 0.0
        for s in spans:
            a, b = s.start * 1e6 + self.offset_us, s.end * 1e6 + self.offset_us
            idle += (b - a) - (busy_before(b) - busy_before(a))
        return idle

    def idle_share(self, spans) -> float | None:
        """``idle_us`` over the traced window, in %."""
        idle = self.idle_us(spans)
        return None if idle is None else 100.0 * idle / 1e6 / self.ctx["window_s"]
