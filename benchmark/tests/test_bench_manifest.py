"""BENCHMARK.json against the contract's shape, and every file it names."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.tests.conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
NAMES = ([(s, e["name"]) for s in ("configs", "workloads", "end_to_end", "per_layer") for e in MANIFEST[s]]
         + [("config", w["config"]) for w in MANIFEST["workloads"]]
         + [("traffic", w["traffic"]) for w in MANIFEST["workloads"]]
         + [("reduced", k) for c in MANIFEST["configs"] for k in c["reduced"]])


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,name", NAMES)
def test_name_characters(section, name):
    assert NAME.match(name), (section, name)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    section = "end_to_end" if "bound" in metric else "per_layer"
    assert set(metric) - {"workloads"} == ENTRY_KEYS[section]
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if section == "end_to_end":
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric.get("workloads", cells)) <= set(moved.get("workloads", cells))
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == ENTRY_KEYS["workloads"] and cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (ROOT / "benchmark" / "limits" / f"{cell['name']}.json").is_file()
    reported = [m["name"] for m in MANIFEST["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == ENTRY_KEYS["configs"] and len(config["reduced"]) <= 16
    body = json.loads((ROOT / config["file"]).read_text())
    assert config["file"].startswith("benchmark/configs/") and body["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
    assert 1 <= len(config["source"]) <= 200


def test_unique_names_and_four_chip_share():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
