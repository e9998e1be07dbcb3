"""program_trace.py and the per-layer metrics that read the program's spans and
counts, on a synthetic traced window: the benchmark's spans on both clocks,
device events, and a recording of the program's tracer."""

from __future__ import annotations

import json
from collections import namedtuple

import pytest

from benchmark import harness, program_trace
from benchmark.tests.conftest import ROOT

# The records of the program's tracer (zeronotesamba_torch/utils/profiling.py), as program_trace reads them.
Span = namedtuple("Span", "name start end parent request")
Count = namedtuple("Count", "name n span")
OFFSET_US = -9.9e6  # the trace's microseconds less perf_counter's


def _ctx(bench_spans, device=(), window_s=0.3, jitter_us=()):
    """A traced window: the benchmark's spans (perf_counter seconds), also on
    the trace's clock (moved by ``jitter_us`` each), and the device's events
    (trace microseconds)."""
    spans = harness.Spans(traced=False)
    spans.spans = list(bench_spans)
    trace = harness.Trace.__new__(harness.Trace)
    jitter = list(jitter_us) + [0.0] * len(bench_spans)
    trace.spans = [(n, a * 1e6 + OFFSET_US + j, b * 1e6 + OFFSET_US + j) for (n, a, b), j in zip(bench_spans, jitter)]
    trace.device, trace.host = [("k", a, b) for a, b in device], []
    return {"trace": trace, "spans": spans, "window_s": window_s, "facts": {}}


def _us(t: float) -> float:
    return t * 1e6 + OFFSET_US


# Three songs of 100 ms. In each the device is busy for its first 50 ms; the
# host then copies (10 ms idle) and decodes (the last 40 ms, idle); the
# Viterbi is 30 ms of the decode.
SONGS = [("song", 10.0 + 0.1 * k, 10.1 + 0.1 * k) for k in range(3)]
DEVICE = [(_us(a), _us(a + 0.05)) for _, a, _ in SONGS]


def _song_recording(dropped=0):
    spans, counts = [], []
    for k, (_, a, b) in enumerate(SONGS):
        top = len(spans)
        spans += [Span("track", a, b, -1, k + 1), Span("track.separate", a, a + 0.02, top, k + 1),
                  Span("decode", b - 0.04, b, top, k + 1), Span("decode.viterbi", b - 0.035, b - 0.005, top + 2, k + 1)]
        counts += [Count("h2d_bytes", 1_920_000, top + 1), Count("h2d_bytes", 3_840_000, top),
                   Count("d2h_syncs", 2, top + 1), Count("d2h_syncs", 4, top)]
    counts.append(Count("h2d_bytes", 999, -1))  # outside every song: not counted
    return spans, counts, dropped


def test_fit_recovers_a_known_offset():
    offset, residual, anchors = program_trace.fit(_ctx(SONGS, jitter_us=(3.0, -3.0, 0.0)))
    assert abs(offset - OFFSET_US) < 1e-6 and abs(residual - 3.0) < 1e-6 and anchors == 3


def test_idle_goes_to_decode_or_to_the_pipeline(monkeypatch):
    monkeypatch.setattr(program_trace, "recording", _song_recording)
    ctx = _ctx(SONGS, DEVICE)
    got = {name: harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(ctx)
           for name in ("decode_idle_share.serve", "pipeline_idle_share.serve", "separate_ms.serve",
                        "decode_ms.serve", "viterbi_ms.serve", "h2d_bytes_per_song.serve", "syncs_per_song.serve")}
    assert got == pytest.approx({"decode_idle_share.serve": 40.0, "pipeline_idle_share.serve": 10.0,
                                 "separate_ms.serve": 20.0, "decode_ms.serve": 40.0, "viterbi_ms.serve": 30.0,
                                 "h2d_bytes_per_song.serve": 5_760_000, "syncs_per_song.serve": 6}, rel=1e-9)
    # Together they are the device's idle share of the songs, as idle_share.serve reads it.
    assert got["decode_idle_share.serve"] + got["pipeline_idle_share.serve"] == pytest.approx(
        harness.idle_share(ctx), rel=1e-9)


def test_validation_host_share(monkeypatch):
    bench = [("train_epoch", 20.0, 20.6), ("val_pass", 20.6, 21.0)]
    spans = [Span("epoch.step", 20.0, 20.5, -1, 1), Span("decode", 20.1, 20.2, -1, 1),  # not in a val_pass
             Span("epoch.step", 20.6, 20.7, -1, 2), Span("decode", 20.7, 20.75, -1, 2),
             Span("decode.viterbi", 20.71, 20.74, 3, 2), Span("score", 20.75, 20.76, -1, 2)]
    monkeypatch.setattr(program_trace, "recording", lambda: (spans, [], 0))
    read = harness.load_module(ROOT / "benchmark" / "metrics" / "val_host_share.finetune.py").read
    assert read(_ctx(bench, [(_us(20.0), _us(20.7))], window_s=1.0)) == pytest.approx(6.0, rel=1e-9)


@pytest.mark.parametrize("case", ["one anchor", "residual", "dropped", "no tracer", "untraced"])
def test_no_reading_where_the_fit_or_the_recording_fails(monkeypatch, case):
    bench, jitter, recorded = SONGS, (), _song_recording()
    if case == "one anchor":
        bench = SONGS[:1]
    elif case == "residual":
        bench, jitter = SONGS[:2], (0.0, 400.0)  # a residual of 200 us
    elif case == "dropped":
        recorded = _song_recording(dropped=1)
    elif case == "no tracer":
        recorded = None
    ctx = _ctx(bench, DEVICE, jitter_us=jitter)
    if case == "untraced":
        ctx["trace"] = None
    monkeypatch.setattr(program_trace, "recording", lambda: recorded)
    assert program_trace.load(ctx) is None
    for name in ("separate_ms.serve", "decode_idle_share.serve", "syncs_per_song.serve", "val_host_share.finetune"):
        assert harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(ctx) is None


def test_a_residual_under_the_limit_still_reads():
    ctx = _ctx(SONGS[:2], jitter_us=(0.0, 1.98 * program_trace.MAX_RESIDUAL_US))
    assert program_trace.load(ctx, _song_recording()) is not None


def test_every_metric_file_has_an_entry():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in manifest["per_layer"]}
