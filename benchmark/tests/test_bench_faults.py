"""The checks see a broken timed path: each fault a cell can have, planted in
the program underneath an otherwise whole run at a tiny size on the CPU,
makes ``correct`` false, also where only the window's steps are broken.
(These cells run on one card: no exchange between cards to leave out.)"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.run import measure
from benchmark.tests.conftest import tiny_cell


def _run(name: str) -> dict:
    return measure(tiny_cell(name), 2**40 + 29, 0.5, False, "cpu", time.perf_counter())


def _alter_answer(monkeypatch, field: str):
    from zeronotesamba_torch import infer

    track = infer.BeatTracker.track_signal

    def altered(self, *a, **kw):
        res = track(self, *a, **kw)
        if field == "beat_times":
            res.beat_times = res.beat_times[1:]
        else:
            arr = getattr(res, field).copy()
            arr[..., arr.shape[-1] // 2] += 0.05
            setattr(res, field, arr)
        return res

    monkeypatch.setattr(infer.BeatTracker, "track_signal", altered)


@pytest.mark.parametrize("field", ["vqt", "fused_pulse", "beat_times"])
def test_song_answer_altered(monkeypatch, field):
    _alter_answer(monkeypatch, field)
    assert not _run("zerons-song-30s")["correct"]


def test_step_returns_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = _run("zerons-finetune-30s")
    assert not result["correct"] and result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["unchanged", "double"])
def test_window_steps_broken_after_setup(monkeypatch, fault):
    # Set-up's three steps are sound; every later step leaves the state as it
    # was, or is applied twice.
    step, calls = torch.optim.Adam.step, []

    def broken(self, closure=None):
        calls.append(None)
        if len(calls) > 3:
            if fault == "unchanged":
                return None
            step(self, closure)
        return step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", broken)
    checks = _run("zerons-finetune-30s")["checks"]
    assert checks["update_gap"]["value"] <= checks["update_gap"]["limit"]
    assert checks["epoch_update_median_gap"]["value"] > checks["epoch_update_median_gap"]["limit"]


def test_half_batch_left_out(monkeypatch):
    from zeronotesamba_torch.train import supervised

    loss_and_out = supervised._loss_and_out

    def half(model, vqt, pulse, mask, *a, **kw):
        h = max(1, vqt.shape[0] // 2)
        loss, out = loss_and_out(model, vqt[:h], pulse[:h], mask[:h], *a, **kw)
        return loss, torch.cat([out, out[: vqt.shape[0] - h]])

    monkeypatch.setattr(supervised, "_loss_and_out", half)
    assert not _run("zerons-finetune-30s")["correct"]


@pytest.mark.parametrize("where", ["etl", "validation"])
def test_finetune_answer_altered(monkeypatch, where):
    from zeronotesamba_torch.data import datasets
    from zeronotesamba_torch.train import supervised

    if where == "etl":
        xqt = datasets.generate_xqt
        monkeypatch.setattr(datasets, "generate_xqt", lambda *a, **kw: xqt(*a, **kw) + np.float32(0.05))
    else:
        eval_step = supervised.eval_step
        monkeypatch.setattr(supervised, "eval_step", lambda *a, **kw: tuple(
            t * 1.01 if i == 0 else t for i, t in enumerate(eval_step(*a, **kw))))
    assert not _run("zerons-finetune-30s")["correct"]
