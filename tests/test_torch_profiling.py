"""The port's tracer (zeronotesamba_torch/utils/profiling.py): spans and
counts recorded only while tracing is on, their parents, requests and
enclosing spans, the fixed-size buffer, the Chrome trace export on the
profiler's clock, and the spans and crossings of ``track_signal`` and
``run_epoch``.

The file imports no JAX. Its card test runs with
``python -m pytest --noconftest tests/test_torch_profiling.py -q -m cuda``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zeronotesamba_torch.data.datasets import SongRecord
from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, run_epoch
from zeronotesamba_torch.utils import profiling

TRACK_SPANS = ["track", "track.separate", "track.upload", "track.transform", "track.encode", "track.download",
               "decode", "decode.viterbi"]


@pytest.fixture(autouse=True)
def fresh_buffer():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing():
    before = profiling.totals("test.")
    with profiling.span("outer", request=True):
        with profiling.span("inner"):
            profiling.count("test.items", 3)
    assert profiling.spans() == [] and profiling.counts() == [] and profiling.dropped() == 0
    assert profiling.totals("test.")["items"] == before.get("items", 0) + 3


def test_nested_spans_under_the_profiler():
    with _cpu_profile():
        with profiling.span("a", request=True):
            with profiling.span("a.1"):
                with profiling.span("a.1.x"):
                    pass
            with profiling.span("a.2"):
                pass
        with profiling.span("b", request=True):
            pass
        with profiling.span("b.after"):
            pass
    with profiling.span("off"):
        pass
    got = profiling.spans()
    assert [(s.name, s.parent, s.request) for s in got] == [
        ("a", -1, 1), ("a.1", 0, 1), ("a.1.x", 1, 1), ("a.2", 0, 1), ("b", -1, 2), ("b.after", -1, 2)]
    for s in got:
        assert s.end >= s.start
        if s.parent >= 0:
            assert got[s.parent].start <= s.start and s.end <= got[s.parent].end


def test_counts_attach_to_the_enclosing_span():
    before = profiling.totals("test.")
    profiling.enable()
    profiling.count("test.bytes", 10)
    with profiling.span("outer", request=True):
        profiling.count("test.bytes", 20)
        with profiling.span("inner"):
            profiling.count("test.syncs")
    profiling.enable(False)
    profiling.count("test.bytes", 40)
    assert profiling.counts() == [("test.bytes", 10, -1), ("test.bytes", 20, 0), ("test.syncs", 1, 1)]
    after = profiling.totals("test.")
    assert after["bytes"] == before.get("bytes", 0) + 70 and after["syncs"] == before.get("syncs", 0) + 1


def test_crossings_to_the_cpu_are_not_counted():
    before = profiling.totals()
    profiling.enable()
    t = profiling.to_device(np.ones(8, dtype=np.float32), "cpu")
    assert profiling.to_host(t).tolist() == [1.0] * 8
    assert profiling.counts() == [] and profiling.totals() == before


def test_full_buffer_counts_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.enable()
    for k in range(5):
        with profiling.span(f"s{k}"):
            profiling.count("test.dropped")
    assert [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert len(profiling.counts()) == 3 and profiling.dropped() == 4
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_reset_inside_a_span_leaves_the_new_spans_alone():
    profiling.enable()
    with profiling.span("old"):
        profiling.reset()
        with profiling.span("new"):
            pass
    assert [(s.name, s.end is not None) for s in profiling.spans()] == [("new", True)]


def test_trace_exports_spans_on_the_trace_clock(tmp_path):
    a = torch.randn(384, 384)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("mm", request=True):
                torch.mm(a, a)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    ops = sorted((e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"), key=lambda e: e["ts"])
    mine = sorted((e for e in events if e.get("cat") == "program_span"), key=lambda e: e["ts"])
    assert [e["name"] for e in mine] == ["mm"] * 3 and [e["args"]["request"] for e in mine] == [1, 2, 3]
    assert len({e["pid"] for e in mine}) == 1 and mine[0]["pid"] not in {e["pid"] for e in ops}
    for op, span in zip(ops, mine):
        # The span encloses the op, within 50 us of the clocks' fit.
        assert span["ts"] <= op["ts"] + 50.0
        assert span["ts"] + span["dur"] >= op["ts"] + op["dur"] - 50.0
        assert op["ts"] - span["ts"] < 5e3


def test_track_signal_spans_on_the_cpu():
    sig, _ = click_track(4.0, 120.0, seed=1)
    tracker = BeatTracker(seed=0, device="cpu")
    with _cpu_profile():
        tracker.track_signal(sig, separation="hpss", decoder="dbn")
    got = profiling.spans()
    assert [s.name for s in got] == TRACK_SPANS
    assert [s.parent for s in got] == [-1, 0, 0, 0, 0, 0, 0, 6] and {s.request for s in got} == {1}
    # Crossings are counted only where the device is a card; the DBN counts its backend under `decode`.
    assert [(c.name, c.n, c.span) for c in profiling.counts()] == [("dbn.native", 1, 6)]


def test_run_epoch_spans_a_request_a_batch():
    rng = np.random.default_rng(0)
    records = [SongRecord(f"s{i}", rng.standard_normal((2, 96, 64)).astype(np.float32),
                          np.zeros(64, np.float32), np.zeros(64, np.float32), np.array([0.2, 0.6]), np.array([0.2]))
               for i in range(3)]
    staged = StagedDataset(records, 64, device="cpu")
    cfg = SupervisedConfig(status="pretrained", batch_size=2, bucket_frames=64)
    state = init_state(cfg, None, 0, device="cpu")
    plan = staged.plan([r.name for r in records], 2)
    with _cpu_profile():
        run_epoch(state, staged, plan, cfg, train=False, score=True)
    got = profiling.spans()
    per_song = ["decode", "decode.viterbi", "score"]
    assert [s.name for s in got] == (["epoch.batch", "epoch.step", "epoch.download"] + per_song * 2
                                     + ["epoch.batch", "epoch.step", "epoch.download"] + per_song)
    assert [s.request for s in got] == [1] * 9 + [2] * 6
    assert all(s.parent == -1 for s in got if s.name != "decode.viterbi")


@pytest.mark.cuda
def test_track_signal_crossings_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the song's crossings are counted on a card)")
    sig, _ = click_track(30.0, 120.0, seed=2)
    tracker = BeatTracker(seed=0, device="cuda")
    tracker.track_signal(sig, separation="hpss", decoder="dbn")  # builds the kernels
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tracker.track_signal(sig, separation="hpss", decoder="dbn")
    got = profiling.spans()
    assert [s.name for s in got] == TRACK_SPANS
    by = {}
    for c in profiling.counts():
        if c.name in ("h2d_bytes", "d2h_syncs"):
            by[c.name] = by.get(c.name, 0) + c.n
            assert got[c.span].name in ("track.separate", "track.upload", "track.download")
    # The 480,000-sample song goes up once, its two stems come down and go up again, float32.
    assert by == {"h2d_bytes": 5_760_000, "d2h_syncs": 6}
