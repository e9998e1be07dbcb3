"""On the card: sound runs read under every limit, and the control (the
reference in the program's place, one precision below) fails at least one, on three
seeds, at a size a test run holds (10 s songs).
On a CUDA card: python -m pytest benchmark/tests -q -m cuda"""

from __future__ import annotations

import pytest

from benchmark.calibrate import readings
from benchmark.tests.conftest import tiny_cell

SMALL = {"song_closed_loop": {"duration_s": 10.0, "pool": 4, "check_songs": 4},
         "finetune_epochs": {"duration_s": 10.0, "songs": 24, "tempos": 4, "batch_size": 4, "check_songs": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zerons-song-30s", "zerons-finetune-30s"])
def test_program_passes_and_control_fails(card, name):
    cell = tiny_cell(name)
    cell.traffic.update(SMALL[cell.traffic["driver"]])
    for seed in (2**35 + 1, 7, 2**31 + 11):
        line = readings(cell, seed, 1.0, card)
        assert all(line["program"][k] <= lim for k, lim in cell.limits.items()), line
        assert any(line["control"][k] > lim for k, lim in cell.limits.items()), line
