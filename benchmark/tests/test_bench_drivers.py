"""Each driver's control flow and the reference, end to end at a tiny size on
the CPU (the program's plain paths): a result line of the contract's shape
that the checks call correct, traced and untraced."""

from __future__ import annotations

import time

import pytest

from benchmark.run import measure
from benchmark.tests.conftest import tiny_cell

CELLS = ["zerons-song-30s", "zerons-finetune-30s"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_driver_runs_and_is_correct(name, trace):
    cell = tiny_cell(name)
    result = measure(cell, 2**40 + 17, 0.5, bool(trace), "cpu", time.perf_counter())
    assert list(result)[:3] == ["correct", "attempted", "failed"] and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    wanted = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    if trace:
        # No device here: the readers of device events find nothing and are left out.
        assert set(result["metrics"]) <= wanted and "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == wanted
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == set(cell.limits)


def test_seed_fixes_the_inputs():
    from benchmark.reference.songs import make_songs

    mix = tiny_cell("zerons-song-30s").traffic
    a, b, c = make_songs(mix, 2**33 + 1, 2), make_songs(mix, 2**33 + 1, 2), make_songs(mix, 5, 2)
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all() for x, y in zip(a, b))
    assert not (a[0][0] == c[0][0]).all()
    assert {s.shape for s, _ in a + c} == {(int(mix["duration_s"] * mix["sample_rate"]),)}
