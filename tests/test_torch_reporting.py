"""The port's reporting and front-end leftovers against the JAX package's,
on the CPU: the six results workbooks, the direct VQT oracle, the device
resampler and the two plots.

Tolerances: the workbooks equal JAX's cell for cell; the oracle equal to
JAX's (the same float64 numpy); the port's multi-rate log-VQT against the
oracle at tests/test_vqt.py:35's limits (``ops/oracle.MULTIRATE_LIMITS``);
``resample_device`` within 1e-5 of ``resample_jax`` and within
tests/test_ops_misc.py:22's 5e-3 of ``resample_poly_host`` on a band-limited
signal away from the edges.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.experiments import report_xlsx as j_report
from zeronotesamba_tpu.ops.filterbank import XQTParams as JXQTParams
from zeronotesamba_tpu.ops.oracle import xqt_direct as j_xqt_direct
from zeronotesamba_tpu.ops.resample import resample_jax
from zeronotesamba_torch import cli
from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.experiments import report_xlsx
from zeronotesamba_torch.ops.filterbank import XQTParams
from zeronotesamba_torch.ops.oracle import MULTIRATE_LIMITS, log_xqt_direct, multirate_errors, xqt_direct
from zeronotesamba_torch.ops.resample import resample_device, resample_poly_host
from zeronotesamba_torch.ops.vqt import best_log_xqt, xqt_magnitude
from zeronotesamba_torch.utils import plotting
from zeronotesamba_torch.utils.xlsx import read_xlsx

matplotlib.use("Agg")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "results", "synthetic")


def test_export_equals_jax_cell_for_cell(tmp_path):
    ours = report_xlsx.export(SRC, str(tmp_path / "torch"))
    ref = j_report.export(SRC, str(tmp_path / "jax"))
    assert ours["written"] == ref["written"] and ours["skipped"] == ref["skipped"]
    assert sorted(ours["written"]) == sorted(report_xlsx.BUILDERS) == sorted(j_report.BUILDERS)
    for name in ours["written"]:
        assert read_xlsx(str(tmp_path / "torch" / name)) == read_xlsx(str(tmp_path / "jax" / name)), name


def test_cli_export_xlsx(tmp_path, capsys):
    import json

    src = tmp_path / "src"
    src.mkdir()
    (src / "summary.json").write_bytes(open(os.path.join(SRC, "summary.json"), "rb").read())
    cli.main(["export-xlsx", "--src", str(src), "--out", str(tmp_path / "x")])
    manifest = json.loads(capsys.readouterr().out)
    assert manifest["written"] == ["unsupervised.xlsx", "cross_data.xlsx", "beat_tracking.xlsx"]
    assert manifest == j_report.export(str(src), str(tmp_path / "x"))
    assert cli.build_parser().parse_args(["export-xlsx"]).out == "results/synthetic_torch/xlsx"


@pytest.mark.parametrize("mode", ["vqt", "cqt"])
def test_oracle_equals_jax(mode):
    sig = click_track(1.0, 120.0, seed=3)[0]
    got = xqt_direct(sig, XQTParams(mode=mode))
    assert np.array_equal(got, j_xqt_direct(sig, JXQTParams(mode=mode)))
    assert np.array_equal(log_xqt_direct(sig, XQTParams(mode=mode)), np.log(got + XQTParams().log_eps))


@pytest.mark.parametrize("mode", ["vqt", "cqt"])
def test_multirate_log_vqt_against_the_oracle(mode):
    """tests/test_vqt.py::test_multirate_matches_direct_oracle for the port,
    on its magnitudes and on its log-VQT (exp minus eps)."""
    p = XQTParams(mode=mode)
    sig = click_track(3.0, 120.0, seed=3)[0]
    direct = xqt_direct(sig, p)
    y = torch.tensor(sig)[None]
    fast = xqt_magnitude(y, p)[0].double().numpy()
    from_log = np.exp(best_log_xqt(y, p)[0].double().numpy()) - p.log_eps
    for got in (fast, from_log):
        assert got.shape == direct.shape
        errs = multirate_errors(got, direct, p)
        assert all(errs[k] < MULTIRATE_LIMITS[k] for k in MULTIRATE_LIMITS), errs


def _band_limited(n: int, sr: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    spec = np.zeros(n // 2 + 1, dtype=complex)
    keep = int(6000 / sr * n)
    spec[1:keep] = rng.standard_normal(keep - 1) + 1j * rng.standard_normal(keep - 1)
    y = np.fft.irfft(spec, n)
    return (y / np.abs(y).max()).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (16000, 22050), (48000, 16000), (16000, 16000)])
def test_resample_device_equals_jax_and_host(sr_in, sr_out):
    y = np.stack([_band_limited(sr_in, sr_in, 0), _band_limited(sr_in, sr_in, 1)])
    got = resample_device(torch.tensor(y), sr_in, sr_out).numpy()
    ref = np.asarray(resample_jax(y, sr_in, sr_out))
    assert got.shape == ref.shape == (2, sr_out)  # 1 s in
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    for b in range(2):
        host = resample_poly_host(y[b], sr_in, sr_out)
        m = min(len(host), got.shape[1])
        assert np.abs(host[500: m - 500] - got[b, 500: m - 500]).max() < 5e-3


def test_plots_write_their_files(tmp_path):
    sig, beats = click_track(2.0, 120.0, seed=1)
    vqt = best_log_xqt(torch.tensor(sig)[None])[0].numpy()
    xqt_png, pulse_png = str(tmp_path / "f" / "xqt.png"), str(tmp_path / "f" / "pulse.png")
    plotting.plot_xqt(vqt, title="click", save=xqt_png)
    plotting.plot_pulse_over_waveform(sig, np.exp(vqt[80]) / np.exp(vqt[80]).max(), beat_times=beats, title="click",
                                      save=pulse_png)
    for path in (xqt_png, pulse_png):
        with open(path, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
