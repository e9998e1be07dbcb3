"""The Spleeter ETL cell at a tiny size on the CPU (the program's plain paths):
its run is correct, traced and untraced; each fault makes ``correct`` false;
the frozen counts match numbers worked by hand; a program without Spleeter
fails at set-up. On a card, the control fails at a small size.
On a CUDA card: python -m pytest benchmark/tests -q -m cuda"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import spleeter
from benchmark.run import measure
from benchmark.tests.conftest import ROOT

CELL = "spleeter-etl-30s"
# Two 3 s songs (134 frames: 3 segments of 64); the nets cut in width, the segments in size.
TINY_TRAFFIC = {"duration_s": 3.0, "pool": 2, "warm_calls": 1, "check_songs": 2, "trace_seconds": 3}
TINY_MODEL = {"conv_n_filters": [2, 4, 8, 16, 32, 64], "T": 64, "F": 128}
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "spleeter_4stems.json").read_text())


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(traffic=TINY_TRAFFIC, model=TINY_MODEL):
    cell = harness.Cell(CELL)
    cell.traffic.update(traffic)
    cell.config = dict(cell.config, **model)
    return cell


def _run(seed: int = 2**40 + 31) -> dict:
    return measure(tiny_cell(), seed, 1.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_driver_runs_and_is_correct(trace):
    cell = tiny_cell()
    result = measure(cell, 2**40 + 17, 3.0 if trace else 1.0, bool(trace), "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits) == {"spec_gap", "mask_gap", "stream_gap", "etl_vqt_gap"}
    wanted = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    if trace:
        # No device here: the readers of device events find nothing and are left out.
        assert set(result["metrics"]) <= wanted
        assert result["metrics"]["segments_per_song.etl"]["value"] == 3
        assert result["metrics"]["h2d_bytes_per_song.etl"]["value"] == 0  # no copies on the CPU
        assert result["metrics"]["separate_ms.etl"]["value"] > 0
    else:
        assert set(result["metrics"]) == wanted == {"audio_min_per_s", "setup_s"}


def _alter(monkeypatch, fault: str):
    from zeronotesamba_torch.models import spleeter as program

    separate = program.Spleeter.separate

    def altered(self, *a, **kw):
        anchor, positive = separate(self, *a, **kw)
        last = self.last
        if fault == "magnitude":
            last["magnitude"] = last["magnitude"] * 1.001
        elif fault == "mask":
            last["masks"] = last["masks"].clone()
            last["masks"][0, 0, 0, 10, 10] += 0.01
        elif fault == "stream":
            last["streams"] = last["streams"].clone()
            last["streams"][1, 1000] += 0.01 * float(last["streams"][1].abs().max())
        elif fault == "record":
            # The record's streams differ from the separator's (a lost or reordered stream).
            return positive, anchor
        return anchor, positive

    monkeypatch.setattr(program.Spleeter, "separate", altered)


@pytest.mark.parametrize("fault,check", [("magnitude", "spec_gap"), ("mask", "mask_gap"), ("stream", "stream_gap"),
                                         ("record", "etl_vqt_gap")])
def test_fault_fails(monkeypatch, fault, check):
    _alter(monkeypatch, fault)
    result = _run()
    assert not result["correct"]
    assert result["checks"][check]["value"] > result["checks"][check]["limit"]


def test_frozen_counts():
    # Per segment at the published widths: 256 x 512 x 2 x 16 x 25 MACs, then 5 x 419,430,400 for the other
    # encoder convs; transposed convs 8 x 16 x 512 x 256 x 25, 4 x 838,860,800 and 256 x 512 x 32 x 1 x 25;
    # the head 512 x 1,024 x 2 x 16.
    macs = (256 * 512 * 2 * 16 * 25 + 5 * 419_430_400 + 8 * 16 * 512 * 256 * 25 + 4 * 838_860_800
            + 256 * 512 * 32 * 25 + 512 * 1024 * 2 * 16)
    assert spleeter.unet_flops(CONFIG) == 2 * macs == 12_197_036_032
    assert spleeter.n_segments(30 * 44100, CONFIG) == 3
    assert spleeter.spleeter_flops(CONFIG, 3) == 146_364_432_384
    assert spleeter.param_count(CONFIG) == CONFIG["parameters"] == 4 * CONFIG["parameters_per_net"] == 39_307_036


def test_facts_count_every_record():
    from benchmark.drivers import etl_closed_loop as driver
    from benchmark.reference import counts

    run = driver.Run.__new__(driver.Run)
    run.config, run.traffic = CONFIG, {"duration_s": 30.0}
    run.songs = [(np.zeros(30 * 44100, np.float32), None), (np.zeros(10 * 44100, np.float32), None)]
    run.built = [0, 1, 0]
    # 10 s: 435 frames, one segment. Each log-VQT launch takes one 30 s stream at 16 kHz.
    assert run.facts() == {"flops": 7 * 4 * 12_197_036_032, "records": 3, "segments": 7,
                           "vqt_bounds_s": counts.vqt_kernel_bounds_s(1, 480_000)}


def test_program_without_spleeter_fails_at_setup(monkeypatch):
    monkeypatch.setitem(sys.modules, "zeronotesamba_torch.models.spleeter", None)  # as before Spleeter
    cell = tiny_cell()
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        cell.driver.Run(cell.config, cell.traffic, 5, "cpu")
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.cuda
def test_program_passes_and_control_fails(card):
    from benchmark.calibrate import readings

    cell = tiny_cell({"duration_s": 10.0, "pool": 4, "check_songs": 4, "segments": 1}, {})
    for seed in (2**35 + 3, 11, 2**31 + 13):
        line = readings(cell, seed, 1.0, card)
        assert all(line["program"][k] <= lim for k, lim in cell.limits.items()), line
        assert any(line["control"][k] > lim for k, lim in cell.limits.items()), line
