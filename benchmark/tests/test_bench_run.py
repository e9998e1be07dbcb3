"""run.py's refusals, the harness's arithmetic, and the checks' verdict."""

from __future__ import annotations

import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, run
from benchmark.tests.conftest import ROOT, tiny_cell


def test_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "zerons-song-30s", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("where", ["readings", "metric"])
def test_no_result_once_jax_is_loaded(capsys, monkeypatch, where):
    # JAX turns up after the window: in the check, or in a per-layer metric's reader.
    import torch

    cell, jax = tiny_cell("zerons-finetune-30s"), types.ModuleType("jax")
    if where == "readings":
        readings = cell.driver.Run.readings

        def loading(self, *a, **kw):
            monkeypatch.setitem(sys.modules, "jax", jax)
            return readings(self, *a, **kw)

        monkeypatch.setattr(cell.driver.Run, "readings", loading)
    else:
        load = harness.load_module

        def loading(path):
            if path.parent.name == "metrics":
                monkeypatch.setitem(sys.modules, "jax", jax)
            return load(path)

        monkeypatch.setattr(harness, "load_module", loading)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    measure = run.measure
    monkeypatch.setattr(run, "measure", lambda _, seed, seconds, trace, device, t0:
                        measure(cell, seed, seconds, trace, "cpu", t0))
    rc = run.main(["--workload", cell.name, "--seed", "5", "--seconds", "0.5", "--trace",
                   str(int(where == "metric"))])
    out = capsys.readouterr()
    assert rc == 3 and not any(line.startswith("{") for line in out.out.splitlines())
    assert "loaded jax" in out.err


def test_refuses_in_a_bare_checkout(tmp_path):
    # Only BENCHMARK.json and the benchmark's own files: no program to measure.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zerons-song-30s", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_union_of_spans():
    assert harness.union_s([(0, 10), (5, 20), (30, 40)]) == 30e-6
    assert harness.union_s([]) == 0.0


def test_judge():
    ok, checks = harness.judge({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 1.0})
    assert not ok and checks["b"] == {"value": 2.0, "limit": 1.0}
    assert harness.judge({"a": float("nan")}, {"a": 1.0})[0] is False
    assert harness.judge({}, {"a": 1.0})[0] is False
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0] is True


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zeronotesamba_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_idle_gaps_by_host_work():
    # Device busy 0-10, 20-30, 100-110 us; the host copies in 12-18 and 95-99.
    tr = harness.Trace.__new__(harness.Trace)
    tr.device = [("k", 0, 10), ("k", 20, 30), ("k", 100, 110)]
    tr.host = [("aten::to", 12, 18), ("aten::to", 95, 99)]
    tr.spans = [("song", 0, 60), ("song", 61, 120)]
    gaps = dict(tr.idle_gaps())
    # Gaps 10-20 and 30-100: 10 us in the copies, 1 us between the two songs, the rest in songs.
    assert abs(gaps["aten::to"] - 10e-6) < 1e-12 and abs(gaps["song:python"] - 69e-6) < 1e-12
    assert abs(gaps["harness"] - 1e-6) < 1e-12
    assert abs(tr.busy_s() - 30e-6) < 1e-12 and tr.device_time("k")[1] == 3
