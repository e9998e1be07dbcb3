"""The frozen counts against numbers worked by hand."""

from __future__ import annotations

import json

import pytest

from benchmark.reference import counts
from benchmark.tests.conftest import ROOT

ZERONS = json.loads((ROOT / "benchmark" / "configs" / "zerons_downcnn.json").read_text())
BOCK = json.loads((ROOT / "benchmark" / "configs" / "bock_tcn.json").read_text())


def test_downcnn_frame():
    # 96 x (3*11*1*64 + 7*13*64*64) + 32 x (5*15*64*128 + 9*17*128*128)
    # + 8 x (3*19*128*256 + 5*21*256*256) + 1 x (23*256*128 + 25*128*128) MACs, plus the head's 128.
    macs = (96 * (3 * 11 * 64 + 7 * 13 * 64 * 64) + 32 * (5 * 15 * 64 * 128 + 9 * 17 * 128 * 128)
            + 8 * (3 * 19 * 128 * 256 + 5 * 21 * 256 * 256) + 23 * 256 * 128 + 25 * 128 * 128 + 128)
    assert counts.downcnn_flops_per_frame(ZERONS) == 2 * macs == 414_036_224


@pytest.mark.parametrize("batch,frames,tflop", [(8, 768, 15.263), (16, 313, 12.441), (8, 1920, 38.158)])
def test_twin_train_step(batch, frames, tflop):
    assert round(counts.train_flops(ZERONS, batch, frames) / 1e12, 3) == tflop


def test_bock_step():
    per_frame = 2 * (9 * 16 * 96 + 9 * 16 * 16 * 32 + 9 * 16 * 16 * 8 + 8 * (5 * 16 * 16 + 16 * 16) + 16)
    assert counts.tcn_flops_per_frame(BOCK) == per_frame == 236_576
    assert round(counts.train_flops(BOCK, 8, 1920) / 1e9, 2) == 10.90


def test_vqt_kernel_bounds_at_the_serving_shape():
    # Two 30 s streams: the byte-bound cascade and the operation-bound octave kernel.
    b = counts.vqt_kernel_bounds_s(2, 480_000)
    assert round(b["cascade_kernel"] * 1e3, 7) == 0.0025978
    assert round(b["octaves_kernel"] * 1e3, 7) == 0.0055319
    assert counts.bound_s(3.35e12, 0.0) == 1.0 and counts.bound_s(0.0, 67e12) == 1.0
