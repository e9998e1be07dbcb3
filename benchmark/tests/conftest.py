"""Shared fixtures of the benchmark's own tests (run: python -m pytest benchmark/tests -q).

Card tests take the ``card`` fixture, which skips where no CUDA card is
visible; on a CUDA card they run with ``python -m pytest benchmark/tests -q -m cuda``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes a CPU run of every driver holds: the cells' shapes cut in length and count.
TINY = {
    "song_closed_loop": {"duration_s": 3.0, "pool": 3, "warm_calls": 1, "check_songs": 2, "trace_seconds": 1},
    "finetune_epochs": {"duration_s": 1.5, "songs": 16, "tempos": 4, "batch_size": 2, "check_songs": 2, "trace_seconds": 1},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


def tiny_cell(name: str):
    """The cell ``name`` with its traffic cut to a CPU test's size."""
    from benchmark import harness

    cell = harness.Cell(name)
    cell.traffic.update(TINY[cell.traffic["driver"]])
    return cell
